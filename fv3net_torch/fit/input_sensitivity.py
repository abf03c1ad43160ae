"""Input-sensitivity reporting structures (port of
``fv3net_tpu/fit/input_sensitivity.py``; reference:
external/fv3fit/fv3fit/_shared/input_sensitivity.py): one container for
either random-forest feature importances or neural-net Jacobians, which
the offline diagnostics report reads.  Host-only."""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "RandomForestInputSensitivity",
    "RandomForestInputSensitivities",
    "JacobianInputSensitivity",
    "InputSensitivity",
    "input_sensitivity",
]

# Jacobian format: {y_name: {x_name: dy/dx array}}
JacobianInputSensitivity = Mapping[str, Mapping[str, np.ndarray]]


@dataclasses.dataclass
class RandomForestInputSensitivity:
    """Per-input-feature importance summary (reference
    input_sensitivity.py:10-24)."""

    mean_importances: Sequence[float]
    std_importances: Sequence[float]
    indices: Sequence[int]


RandomForestInputSensitivities = Mapping[str, RandomForestInputSensitivity]


@dataclasses.dataclass
class InputSensitivity:
    """Either-or container (reference input_sensitivity.py:29-33)."""

    rf_feature_importances: Optional[RandomForestInputSensitivities] = None
    jacobians: Optional[JacobianInputSensitivity] = None


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def input_sensitivity(model, base_state) -> InputSensitivity:
    """Models exposing ``feature_importances`` (a mapping, or a callable
    returning one, of input -> (mean, std)) report importances;
    differentiable predictors report exact Jacobians (reference:
    RandomForest.input_sensitivity at sklearn/_random_forest.py and
    PureKerasModel jacobians at keras/jacobian.py)."""
    importances = getattr(model, "feature_importances", None)
    if importances is not None:
        per_input = importances() if callable(importances) else importances
        out = {}
        for name, (mean, std) in per_input.items():
            mean = np.atleast_1d(_host(mean))
            std = np.atleast_1d(_host(std))
            out[name] = RandomForestInputSensitivity(
                mean_importances=mean.tolist(),
                std_importances=std.tolist(),
                indices=list(range(mean.size)),
            )
        return InputSensitivity(rf_feature_importances=out)

    from fv3net_torch.fit.jacobian import compute_jacobians

    jac = compute_jacobians(model, base_state)
    return InputSensitivity(
        jacobians={
            y: {x: _host(v) for x, v in row.items()}
            for y, row in jac.items()
        }
    )
