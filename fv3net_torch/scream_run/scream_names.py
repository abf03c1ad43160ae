"""SCREAM <-> fv3 variable-name bridge + the SCREAM ML stepper (port of
``fv3net_tpu/scream_run/scream_names.py``; reference:
scream_run/steppers/machine_learning.py predict path; name conventions as
in loaders/mappers.py SCREAM_RENAME)."""
from __future__ import annotations

from typing import Dict

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit.packer import stack_columns, unstack_columns
from fv3net_torch.runtime import names
from fv3net_torch.runtime.derived_state import DIMS_2D, DIMS_3D
from fv3net_torch.scream_run.ml import (
    MachineLearningConfig,
    MultiModelAdapter,
    predict_with_qv_constraint,
)

SCREAM_TO_FV3: Dict[str, str] = {
    "T_mid": names.TEMP,
    "qv": names.SPHUM,
    "U": names.EASTWARD_WIND,
    "V": names.NORTHWARD_WIND,
}


class ScreamMLStepper:
    """Postphysics stepper applying SCREAM-convention ML corrections
    (dQ1/dQ2/dQu/dQv) with the qv non-negativity constraint."""

    label = "scream_machine_learning"

    def __init__(self, model: MultiModelAdapter, timestep: float,
                 config: MachineLearningConfig):
        self.model = model
        self.timestep = timestep
        self.config = config

    def __call__(self, time, state):
        scream_state: Dict[str, Quantity] = {}
        needed = set(self.model.input_variables) | {"qv"}
        for s_name in needed:
            fv3_name = SCREAM_TO_FV3.get(s_name, s_name)
            q = state[fv3_name]
            stacked = stack_columns(q.data)
            dims = ("sample", "z") if stacked.ndim == 2 else ("sample",)
            scream_state[s_name] = Quantity(stacked, dims, q.units)
        pred = predict_with_qv_constraint(
            self.model, scream_state, self.timestep,
            self.config.mse_conserving_limiter,
            scaling=self.config.scaling,
        )
        grid_shape = tuple(state[names.DELP].shape[i] for i in (0, 2, 3))
        unstacked = {}
        for k in pred:
            arr = unstack_columns(pred[k].data, grid_shape)
            unstacked[k] = Quantity(
                arr, DIMS_3D if arr.ndim == 4 else DIMS_2D
            )
        if self.config.diagnostic_ml:
            return {}, unstacked, {}
        tendencies = {
            k: unstacked[k]
            for k in ("dQ1", "dQ2", "dQu", "dQv")
            if k in unstacked
        }
        return tendencies, {}, {}
