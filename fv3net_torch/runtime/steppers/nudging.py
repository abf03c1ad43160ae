"""Nudging stepper: relax named variables toward reference states (port
of ``fv3net_tpu/runtime/steppers/nudging.py``; reference:
workflows/prognostic_c48_run/runtime/steppers/nudging.py and
runtime/nudging.py)."""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.runtime import names
from fv3net_torch.runtime.derived_state import DerivedState


class PureNudger:
    """Nudge state variables toward a time-interpolated reference.

    The tendency of ``var`` is (reference - state) / timescale, named by
    ``names.STATE_NAME_TO_TENDENCY`` (dQ1, dQ2, dQu, dQv, dQp) or
    ``{var}_tendency_due_to_nudging``; the reference fields come back as
    the diagnostics ``{var}_reference``.  The reference data (numpy from
    a zarr store, or tensors) moves to the state's device; the arithmetic
    takes the wider of its dtype and the state's, as the reference's.

    The tendencies come out in the order of the variables' names, the
    order a run config's yaml holds them in, whatever the order of
    ``timescales``: applying them is not commutative (the humidity and
    delp setters move delp, which the temperature setter reads), and
    ``run_segment`` on an in-memory config must give what
    ``append_segment`` gives on its yaml copy.  The reference keeps the
    mapping's order (ROADMAP.md, Queue 3).

    Args:
        reference_getter: time -> Dict[str, Quantity] of reference fields
        timescales: variable name -> relaxation timescale in seconds
    """

    label = "nudging"

    def __init__(
        self,
        reference_getter: Callable,
        timescales: Mapping[str, float],
    ):
        self.reference_getter = reference_getter
        self.timescales = dict(sorted(timescales.items()))

    def __call__(self, time, state: DerivedState):
        reference = self.reference_getter(time)
        tendencies: Dict[str, Quantity] = {}
        diagnostics: Dict[str, Quantity] = {}
        for var, tau in self.timescales.items():
            cur = state[var].data
            ref = torch.as_tensor(reference[var].data, device=cur.device)
            tend = (ref - cur) / tau
            tendency_name = names.STATE_NAME_TO_TENDENCY.get(var)
            if tendency_name is None:
                tendency_name = f"{var}_tendency_due_to_nudging"
            tendencies[tendency_name] = Quantity(tend, state[var].dims)
            diagnostics[f"{var}_reference"] = Quantity(
                ref, reference[var].dims, reference[var].units)
        return tendencies, diagnostics, {}
