"""Derived offline diagnostics (port of
``fv3net_tpu/diagnostics/offline/derived.py``; reference:
offline/_helpers.py:73-150 compute_r2 / insert_rmse from the mse and
variance families, and offline/derived_diagnostics.py, a registry of
diagnostics computed FROM the diagnostics themselves).  The values are
float64 tensors on the diagnostics' device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.diagnostics.registry import Registry


def _f64(q: Quantity) -> torch.Tensor:
    return torch.as_tensor(q.data).to(torch.float64)


def compute_r2(diags: Dict[str, Quantity]) -> Dict[str, Quantity]:
    """R2 = 1 - mse/variance for every mse/variance pair (reference
    _helpers.py:73-81); a zero variance gives inf or NaN."""
    out: Dict[str, Quantity] = {}
    for name, q in diags.items():
        if "_mse_" not in name:
            continue
        var_name = name.replace("_mse_", "_variance_")
        if var_name not in diags:
            continue
        r2 = 1.0 - _f64(q) / _f64(diags[var_name])
        out[name.replace("_mse_", "_r2_")] = dataclasses.replace(
            q, data=r2, units=""
        )
    return out


def insert_r2(diags: Dict[str, Quantity]) -> Dict[str, Quantity]:
    merged = dict(diags)
    merged.update(compute_r2(diags))
    return merged


def insert_rmse(diags: Dict[str, Quantity]) -> Dict[str, Quantity]:
    """sqrt of every mse diagnostic (reference _helpers.py:145-150)."""
    merged = dict(diags)
    for name, q in diags.items():
        if "_mse_" in name:
            merged[name.replace("_mse_", "_rmse_")] = dataclasses.replace(
                q,
                data=torch.sqrt(_f64(q)),
                units=q.units.replace("(", "").replace(")^2", ""),
            )
    return merged


def merge_derived(outputs):
    return {name: q for name, q in outputs if q is not None}


derived_registry = Registry(merge_derived)


@derived_registry.register("r2_score_2d_global")
def overall_r2(diags: Dict[str, Quantity]):
    """Mean 2-D global R2 over all predicted variables, a headline scalar
    for the report (derived from the registry outputs like the
    reference's derived_registry entries)."""
    vals = [
        _f64(q)
        for name, q in insert_r2(diags).items()
        if "_r2_2d_global" in name and q.ndim == 0
    ]
    if not vals:
        return None
    return Quantity(torch.stack(vals).mean(), (), "")
