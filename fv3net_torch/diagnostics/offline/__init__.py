"""Offline ML model evaluation (port of
``fv3net_tpu/diagnostics/offline``).

reference: workflows/diagnostics/fv3net/diagnostics/offline/ -- the
``python -m fv3net.diagnostics.offline.compute`` surface: predictions
over held-out batches with a target/predict ``derivation`` dimension,
a registry of masked/zonal/diurnal/pressure-level diagnostics
(compute_diagnostics.py:55-566), derived diagnostics, snapshot maps,
meridional transects, scalar-metrics JSON, and the HTML views.

Package layout:
- ``_sample.py``: stacked-sample metrics (R2/RMSE/bias profiles,
  predicted-vs-target densities, column-integrated skill) and the
  quick report.
- ``compute_diagnostics.py``: cube-shaped diagnostics registry over
  (prediction, target, grid, delp), the mse/variance/bias x
  2d/pressure-level/model-level x mask families, zonal averages,
  diurnal cycles, time-domain means.
- ``derived.py``: derived-diagnostics registry (R2 insertion).
- ``select.py``: snapshot selection + meridional transects.
- ``views.py``: the full HTML report (host copy).
- ``compute.py``: the offline CLI (``offline-diags-torch``) gluing all
  of it.
"""
from fv3net_torch.diagnostics.offline._sample import (  # noqa: F401
    compute_offline_diags,
    input_sensitivity,
    main,
    offline_report,
)
from fv3net_torch.diagnostics.offline.compute_diagnostics import (  # noqa: F401
    DiagArg,
    compute_diagnostics,
    diagnostics_registry,
)
from fv3net_torch.diagnostics.offline.derived import (  # noqa: F401
    compute_r2,
    derived_registry,
    insert_r2,
    insert_rmse,
)
from fv3net_torch.diagnostics.offline.select import (  # noqa: F401
    meridional_transect,
    select_snapshot,
)
