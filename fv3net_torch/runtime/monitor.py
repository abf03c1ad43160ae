"""Monitor: tendency and storage diagnostics from state differences
(port of ``fv3net_tpu/runtime/monitor.py``; reference:
workflows/prognostic_c48_run/runtime/monitor.py:31-122).  It wraps a
named step, keeps the selected variables before it, and emits
``tendency_of_{var}_due_to_{name}``,
``storage_of_{var}_path_due_to_{name}`` (the mass-weighted column
integral) and ``storage_of_mass_due_to_{name}``.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

from fv3net_torch.core.constants import GRAVITY
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.runtime import names
from fv3net_torch.runtime.derived_state import DIMS_2D, DIMS_3D, DerivedState

# variables whose column path is stored
_PATH_VARS = {names.SPHUM, names.CLOUD, names.TEMP}


class Monitor:
    """Compute tendency diagnostics of a named step."""

    def __init__(self, tendency_variables: Sequence[str], timestep: float):
        self.tendency_variables = list(tendency_variables)
        self.timestep = timestep

    def __call__(self, name: str, step: Callable[[], Dict[str, Quantity]],
                 state: DerivedState) -> Dict[str, Quantity]:
        """Run ``step()`` and return its diagnostics merged with the
        before/after tendency diagnostics of ``name``."""
        before = {v: state[v].data for v in self.tendency_variables}
        delp_before = state[names.DELP].data
        diags = step() or {}
        out = dict(diags)
        delp_after = state[names.DELP].data
        for v in self.tendency_variables:
            tend = (state[v].data - before[v]) / self.timestep
            out[f"tendency_of_{v}_due_to_{name}"] = Quantity(tend, DIMS_3D)
            if v in _PATH_VARS:
                path = (tend * delp_after / GRAVITY).sum(dim=1)
                out[f"storage_of_{v}_path_due_to_{name}"] = Quantity(
                    path, DIMS_2D
                )
        mass_storage = (delp_after - delp_before).sum(dim=1) / (
            GRAVITY * self.timestep
        )
        out[f"storage_of_mass_due_to_{name}"] = Quantity(mass_storage, DIMS_2D)
        return out
