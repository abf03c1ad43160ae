"""SCREAM-convention ML stepper pieces (port of
``fv3net_tpu/scream_run/ml.py``; reference:
prognostic_scream_run/scream_run/steppers/machine_learning.py:24-145 —
MachineLearningConfig, MultiModelAdapter, predict_with_qv_constraint /
enforce_non_negative_humidity)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import io
from fv3net_torch.ops import thermo
from fv3net_torch.runtime.steppers.machine_learning import MultiModelAdapter

SPHUM = "qv"  # SCREAM humidity name (reference machine_learning.py)


@dataclasses.dataclass
class MachineLearningConfig:
    """(reference machine_learning.py:24-47)"""

    models: List[str] = dataclasses.field(default_factory=list)
    diagnostic_ml: bool = False
    scaling: Dict[str, float] = dataclasses.field(default_factory=dict)
    limit_negative_humidity: bool = True
    mse_conserving_limiter: bool = True


def open_model(config: MachineLearningConfig, device="cuda",
               dtype=None) -> MultiModelAdapter:
    """The configured models on ``device`` (in ``dtype`` if given)
    (reference machine_learning.py:88-100)."""
    return MultiModelAdapter([io.load(path).to(device=device, dtype=dtype)
                              for path in config.models])


def predict(
    model: MultiModelAdapter,
    state: Dict[str, Quantity],
    scaling: Dict[str, float] = None,
) -> Dataset:
    inputs = Dataset({k: state[k] for k in model.input_variables})
    pred = model.predict(inputs)
    if scaling:
        # per-output multiplicative factors (reference
        # machine_learning.py MachineLearningConfig.scaling) — applied
        # BEFORE the humidity limiter so the constraint sees the scaled
        # tendencies
        out = dict(pred.items())
        for name, factor in scaling.items():
            if name in out:
                q = out[name]
                out[name] = Quantity(q.data * factor, q.dims, q.units)
        pred = Dataset(out)
    return pred


def enforce_non_negative_humidity(
    prediction: Dataset,
    state: Dict[str, Quantity],
    dt: float,
    mse_conserving_limiter: bool = True,
) -> Dataset:
    """(reference machine_learning.py:124-145): limit dQ2 so humidity
    stays non-negative over the step, compensating dQ1 to conserve MSE
    when requested."""
    q = state[SPHUM].data
    out = dict(prediction.items())
    dq1 = out["dQ1"].data if "dQ1" in out else torch.zeros_like(q)
    dq2 = out["dQ2"].data if "dQ2" in out else torch.zeros_like(q)
    if mse_conserving_limiter:
        dq2_new, dq1_new = thermo.non_negative_sphum_mse_conserving(
            q, dq2, dt, q1=dq1
        )
    else:
        dq1_new, dq2_new = thermo.non_negative_sphum(q, dq1, dq2, dt)
    dims = state[SPHUM].dims
    if "dQ1" in out:
        out["dQ1"] = Quantity(dq1_new, dims)
    if "dQ2" in out:
        out["dQ2"] = Quantity(dq2_new, dims)
    return Dataset(out)


def predict_with_qv_constraint(
    model: MultiModelAdapter,
    state: Dict[str, Quantity],
    dt: float,
    mse_conserving_limiter: bool = True,
    scaling: Dict[str, float] = None,
) -> Dataset:
    """(reference machine_learning.py:114-121)"""
    return enforce_non_negative_humidity(
        predict(model, state, scaling), state, dt, mse_conserving_limiter
    )
