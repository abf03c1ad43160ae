"""Hydrostatic dynamical core on tensors (port of ``fv3net_tpu/dycore``):
vertically-Lagrangian layers with a PPM remap to the hybrid coordinate
every dynamics interval."""
from fv3net_torch.dycore.state import DycoreState, init_state  # noqa: F401
from fv3net_torch.dycore.core import DycoreConfig, dynamics_step  # noqa: F401
