"""Cubed-sphere visualization (reference: external/fv3viz —
plot_cube / pcolormesh_cube / infer_cmap_params / diagnostic panels /
timestep histograms / colorblind-friendly styles)."""
from fv3net_torch.viz.plot_cube import (  # noqa: F401
    pcolormesh_cube,
    plot_cube,
    plot_cube_faceted,
)
from fv3net_torch.viz.helpers import (  # noqa: F401
    WONG_PALETTE,
    get_var_label,
    infer_cmap_params,
    plot_daily_and_hourly_hist,
    plot_daily_hist,
    plot_hourly_hist,
    wong_palette,
    plot_diurnal_cycle,
    plot_time_series,
    use_colorblind_friendly_style,
)
