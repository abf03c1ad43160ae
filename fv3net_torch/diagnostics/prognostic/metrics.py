"""Scalar metrics from computed diagnostics (port of
``fv3net_tpu/diagnostics/prognostic/metrics.py``; reference:
workflows/diagnostics/fv3net/diagnostics/prognostic_run/metrics.py):
computed diagnostics (time series, maps) reduced to scalar values (time
means of RMSEs and biases, drifts) written as JSON.  Each series is
reduced where its data lie (a tensor on its device, or a host array);
only the scalar comes to the host.
"""
from __future__ import annotations

import json
from typing import Dict

import torch

from fv3net_torch.core.quantity import Quantity


def _series(q: Quantity) -> torch.Tensor:
    return torch.as_tensor(q.data)


def compute_metrics(diags: Dict[str, Quantity]) -> Dict[str, dict]:
    """Scalar metrics: time-mean of every *_rms_global / *_mean_bias_global
    series and drifts (last less first) of spatial means."""
    metrics: Dict[str, dict] = {}
    for name, q in diags.items():
        arr = _series(q)
        if name.endswith("_rms_global") and arr.ndim == 1:
            var = name[: -len("_rms_global")]
            metrics[f"rmse_of_{var}"] = {
                "value": float(torch.nanmean(arr)),
                "units": q.units,
            }
        if name.endswith("_mean_bias_global") and arr.ndim == 1:
            var = name[: -len("_mean_bias_global")]
            metrics[f"mean_bias_of_{var}"] = {
                "value": float(torch.nanmean(arr)),
                "units": q.units,
            }
        if name.endswith("_spatial_mean_global") and arr.ndim == 1 and len(arr) > 1:
            var = name[: -len("_spatial_mean_global")]
            metrics[f"drift_of_{var}"] = {
                "value": float(arr[-1] - arr[0]),
                "units": q.units,
            }
    return metrics


def dump_metrics(metrics: Dict[str, dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(metrics, f, indent=2)
