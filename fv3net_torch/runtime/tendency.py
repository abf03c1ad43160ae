"""Tendency preparation before application to the dynamical core (port of
``fv3net_tpu/runtime/tendency.py``; reference:
workflows/prognostic_c48_run/runtime/tendency.py).

ML predictions may hold NaN; they are zero-filled before application and
the per-column filled fraction is recorded as a diagnostic.  The
reservoir's bookkeeping turns state updates into tendencies and back.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.runtime.names import STATE_NAME_TO_TENDENCY

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


def tendencies_from_state_updates(
    initial_state: Mapping[str, Quantity],
    updated_state: Mapping[str, Quantity],
    dt: float,
) -> Dict[str, Quantity]:
    """(updated - initial) / dt for every updated variable with a
    registered tendency name."""
    out: Dict[str, Quantity] = {}
    for variable in updated_state:
        tendency_var = STATE_NAME_TO_TENDENCY.get(variable)
        if tendency_var is None:
            continue
        a = torch.as_tensor(initial_state[variable].data)
        b = torch.as_tensor(updated_state[variable].data)
        out[tendency_var] = Quantity(
            (b - a) / dt, updated_state[variable].dims
        )
    return out


def state_updates_from_tendency(
    tendency_updates: Mapping[str, Quantity]
) -> Dict[str, Quantity]:
    """Rename applied-tendency state results so both the overwritten and
    overwriting values can be stored."""
    return {
        f"{k}_state_from_postphysics_tendency": v
        for k, v in tendency_updates.items()
    }
