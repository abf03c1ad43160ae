"""Tendency preparation before application to the dynamical core (port of
``fv3net_tpu/runtime/tendency.py``; reference:
workflows/prognostic_c48_run/runtime/tendency.py).

ML predictions may hold NaN; they are zero-filled before application and
the per-column filled fraction is recorded as a diagnostic.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from fv3net_torch.core.quantity import Quantity

DIMS_2D = ("tile", "y", "x")


def fillna_tendency(q: Quantity) -> Tuple[Quantity, Quantity]:
    """Zero-fill NaNs in one tendency; also return the per-column
    fraction of levels that were filled."""
    data = q.data
    isnan = torch.isnan(data)
    filled = torch.where(isnan, torch.zeros_like(data), data)
    if data.ndim == 4:  # [tile, z, y, x]
        frac = isnan.to(data.dtype).mean(dim=1)
        frac_dims = DIMS_2D
    else:
        frac = isnan.to(data.dtype)
        frac_dims = q.dims
    return Quantity(filled, q.dims, q.units), Quantity(frac, frac_dims)


def fillna_tendencies(
    tendencies: Mapping[str, Quantity]
) -> Tuple[Dict[str, Quantity], Dict[str, Quantity]]:
    """(filled tendencies, ``{name}_filled_frac`` diagnostics)."""
    filled: Dict[str, Quantity] = {}
    fracs: Dict[str, Quantity] = {}
    for name, q in tendencies.items():
        filled[name], fracs[f"{name}_filled_frac"] = fillna_tendency(q)
    return filled, fracs
