"""Prescriber stepper: overwrite named variables from a time-dependent
dataset (port of ``fv3net_tpu/runtime/steppers/prescriber.py``;
reference: workflows/prognostic_c48_run/runtime/steppers/prescriber.py,
built by runtime/factories.py:60-67)."""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.runtime.derived_state import DerivedState


class Prescriber:
    """Set listed variables to externally provided values each step.

    Args:
        data_getter: time -> Dict[str, Quantity]
        variables: names to prescribe (subset of what data_getter returns)
        rename: optional mapping from source names to state names
    """

    label = "prescriber"

    def __init__(
        self,
        data_getter: Callable,
        variables: Sequence[str],
        rename: Mapping[str, str] = None,
    ):
        self.data_getter = data_getter
        self.variables = list(variables)
        self.rename = dict(rename or {})

    def __call__(self, time, state: DerivedState):
        data = self.data_getter(time)
        state_updates: Dict[str, Quantity] = {}
        for var in self.variables:
            target = self.rename.get(var, var)
            state_updates[target] = data[var]
        return {}, {}, state_updates
