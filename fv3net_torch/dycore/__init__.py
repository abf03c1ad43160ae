"""Dynamical core on tensors (port of ``fv3net_tpu/dycore``, hydrostatic
and nonhydrostatic): vertically-Lagrangian layers with a PPM remap to the
hybrid coordinate every dynamics interval; ``testcases`` holds the JW06
baroclinic wave and the mountain at rest."""
from fv3net_torch.dycore.state import (  # noqa: F401
    DycoreState,
    add_nonhydrostatic_fields,
    init_state,
)
from fv3net_torch.dycore.core import DycoreConfig, dynamics_step  # noqa: F401
