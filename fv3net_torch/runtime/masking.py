"""State-blend masks for emulator/ML updates (port of
``fv3net_torch/runtime/masking.py``, on tensors).

reference: workflows/prognostic_c48_run/runtime/masking.py:16-99 —
``where_masked(left, right, compute_mask)`` keeps the ``left`` (pre-
update) value wherever the mask is True, so named mask kinds can veto
an emulator's output for chosen fields/levels (e.g. ignore upper-level
humidity updates).  Level index 0 is the model top, as in the reference
(FV3 z ordering) and this framework's dynamics layout.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Hashable, Mapping, Optional

import torch

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.runtime import names

__all__ = ["get_mask", "where_masked"]

_KINDS = {}


def _level_index(q: Quantity):
    """Index along the vertical axis, broadcast to ``q``'s shape."""
    for axis, dim in enumerate(q.dims):
        if dim in ("z", "pfull", "nz"):
            shape = [1] * len(q.dims)
            shape[axis] = q.data.shape[axis]
            return torch.arange(q.data.shape[axis],
                                device=q.data.device).reshape(shape)
    raise ValueError(f"no vertical dim in {q.dims}")


def where_masked(
    left: Mapping[Hashable, Quantity],
    right: Mapping[Hashable, Quantity],
    compute_mask: Callable,
) -> Mapping[Hashable, Quantity]:
    """Blend two states: where ``compute_mask(name, left[name])`` is
    True return ``left`` (the update is vetoed), else ``right``."""
    updated = dict(left)
    for key in right:
        q = left[key]
        mask = compute_mask(key, q)
        data = q.data
        mask = torch.as_tensor(mask, device=data.device)
        updated[key] = Quantity(
            torch.where(mask, data, torch.as_tensor(right[key].data)),
            q.dims, q.units,
        )
    return updated


def _register(name):
    def deco(fn):
        _KINDS[name] = fn
        return fn

    return deco


def get_mask(kind: str, ignore_humidity_below: Optional[int] = None):
    """Look up a mask function by kind (reference masking.py:34-40)."""
    if kind == "default":
        return partial(
            _compute_mask_default,
            ignore_humidity_below=ignore_humidity_below,
        )
    try:
        return _KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown mask kind {kind!r}") from None


def _compute_mask_default(
    name: Hashable, q: Quantity, ignore_humidity_below: Optional[int] = None
):
    if name == names.SPHUM and ignore_humidity_below is not None:
        return _level_index(q) < ignore_humidity_below
    return torch.tensor(False)


@_register("2021_09_16")
def _compute_mask_2021_09_16(name: Hashable, q: Quantity):
    """The emulation-track mask of 2021-09-16 (reference :55-63)."""
    if name == names.SPHUM:
        return _level_index(q) < 20
    if name == names.EASTWARD_WIND_AFTER_PHYSICS:
        return _level_index(q) < 6
    return torch.tensor(False)


@_register("no_cloud")
def _compute_mask_no_cloud(name: Hashable, q: Quantity):
    return torch.tensor(name == names.CLOUD)


@_register("no_cloud_no_qv")
def _compute_mask_no_cloud_no_qv(name: Hashable, q: Quantity):
    return torch.tensor(name in (names.CLOUD, names.SPHUM))


@_register("no_sphum_bl")
def _compute_mask_no_sphum_bl(name: Hashable, q: Quantity):
    if name == names.SPHUM:
        z = _level_index(q)
        # reference :84-87 preserves this (empty) band expression as-is
        return (z > 68) & (z < 20)
    return torch.tensor(False)


@_register("no_sphum_bl_no_cloud")
def _compute_mask_no_sphum_bl_no_cloud(name: Hashable, q: Quantity):
    if name == names.CLOUD:
        return torch.tensor(True)
    return _compute_mask_no_sphum_bl(name, q)
