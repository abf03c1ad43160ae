"""Online ML stepper (port of
``fv3net_tpu/runtime/steppers/machine_learning.py``; reference:
workflows/prognostic_c48_run/runtime/steppers/machine_learning.py:114-245):
``MultiModelAdapter`` merges per-model predictions, ``PureMLStepper``
splits predictions into tendencies (dQ1/dQ2/dQu/dQv) and direct state
updates under the non-negative-humidity limiter, ``add_tendency`` applies
them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit.packer import stack_columns, unstack_columns
from fv3net_torch.runtime import names
from fv3net_torch.runtime.derived_state import DIMS_2D, DIMS_3D, DerivedState
from fv3net_torch.runtime.diagnostics.compute import limit_sphum_tendency


class MultiModelAdapter:
    """Merge the predictions of several predictors (later models win on
    a shared output)."""

    def __init__(self, models: Sequence):
        self.models = list(models)

    @staticmethod
    def _union(lists) -> List[str]:
        out: List[str] = []
        for names_ in lists:
            out += [v for v in names_ if v not in out]
        return out

    @property
    def input_variables(self) -> List[str]:
        return self._union(m.input_variables for m in self.models)

    @property
    def output_variables(self) -> List[str]:
        return self._union(m.output_variables for m in self.models)

    def predict(self, X: Dataset) -> Dataset:
        merged: Dict[str, Quantity] = {}
        for m in self.models:
            merged.update(m.predict(X).items())
        return Dataset(merged)


def predict(model, state: DerivedState) -> Dataset:
    """The model's prediction from its inputs in the derived state,
    stacked to [sample(, z)]."""
    data = {}
    for name in model.input_variables:
        q = state[name]
        stacked = stack_columns(q.data)
        dims = ("sample", "z") if stacked.ndim == 2 else ("sample",)
        data[name] = Quantity(stacked, dims, q.units)
    return model.predict(Dataset(data))


class PureMLStepper:
    """Apply ML-predicted corrective tendencies and state updates.

    Called as ``stepper(time, state)``; returns (tendencies, diagnostics,
    state_updates) of Quantities on the model grid.
    """

    label = "machine_learning"

    def __init__(self, model, timestep: float, hydrostatic: bool = False,
                 mse_conserving_limiter: bool = True,
                 diagnostic_only: bool = False):
        self.model = model
        self.timestep = timestep
        self.hydrostatic = hydrostatic
        self.mse_conserving_limiter = mse_conserving_limiter
        # the config's diagnostic_ml (or online: false): the TimeLoop's
        # per-step path records the predictions and applies nothing, and
        # such a stepper never runs in a fused chunk
        self.diagnostic_only = diagnostic_only

    def __call__(self, time, state: DerivedState):
        prediction = predict(self.model, state)
        grid_shape = tuple(state[names.DELP].shape[i] for i in (0, 2, 3))

        tendencies: Dict[str, Quantity] = {}
        state_updates: Dict[str, Quantity] = {}
        for key in prediction:
            arr = unstack_columns(prediction[key].data, grid_shape)
            q = Quantity(arr, DIMS_3D if arr.ndim == 4 else DIMS_2D)
            if names.is_tendency_variable(key):
                tendencies[key] = q
            else:
                state_updates[key] = q

        # the limiter always runs when dQ2 is predicted; the flag picks
        # the MSE-conserving or the plain-scaling variant
        tendencies, diagnostics = limit_sphum_tendency(
            state[names.SPHUM].data,
            tendencies,
            self.timestep,
            mse_conserving=self.mse_conserving_limiter,
            delp=state[names.DELP].data,
            hydrostatic=self.hydrostatic,
        )
        return tendencies, diagnostics, state_updates


def add_tendency(state: DerivedState, tendencies, dt: float) -> None:
    """``state[name] += tendency * dt`` for each tendency, in the
    tendencies' order (dQ1 before dQ2 matters: the humidity setter moves
    delp, and with it the pressure the temperature setter reads)."""
    for key, tend in tendencies.items():
        target = names.TENDENCY_TO_STATE_NAME.get(key)
        if target is None and key.endswith("_tendency_due_to_nudging"):
            # nudged variables outside the dQ* names carry their state
            # name in the tendency key
            candidate = key[: -len("_tendency_due_to_nudging")]
            if candidate in state:
                target = candidate
        if target is None:
            continue
        cur = state[target]
        # cast to the state's dtype: the model may be wider and must not
        # widen the prognostic state
        tend_data = tend.data.to(cur.data.dtype)
        state[target] = Quantity(cur.data + dt * tend_data, cur.dims,
                                 cur.units)
