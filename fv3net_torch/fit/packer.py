"""Pack named variables into a [sample, feature] tensor and back, and
stack [tile, nz, ny, nx] model fields into [sample, z] columns (port of
``fv3net_tpu/fit/packer.py``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity


@dataclasses.dataclass
class PackingInfo:
    """Feature layout of a packed array: per-variable feature counts, in
    packing order."""

    names: List[str]
    features: List[int]

    @property
    def total_features(self) -> int:
        return sum(self.features)

    def slices(self) -> Dict[str, slice]:
        out = {}
        start = 0
        for name, nf in zip(self.names, self.features):
            out[name] = slice(start, start + nf)
            start += nf
        return out


def pack(
    data: Mapping[str, torch.Tensor], names: Sequence[str]
) -> Tuple[torch.Tensor, PackingInfo]:
    """Concatenate [sample] or [sample, nz] variables along features."""
    arrays = []
    features = []
    for name in names:
        arr = data[name]
        if arr.ndim == 1:
            arr = arr[:, None]
        elif arr.ndim != 2:
            raise ValueError(
                f"{name}: expected [sample] or [sample, z], got shape "
                f"{tuple(arr.shape)}"
            )
        arrays.append(arr)
        features.append(arr.shape[1])
    return torch.cat(arrays, dim=1), PackingInfo(list(names), features)


def unpack(
    packed: torch.Tensor, info: PackingInfo, squeeze_scalar: bool = True
) -> Dict[str, torch.Tensor]:
    """Invert ``pack``: [sample, total_features] -> per-variable tensors."""
    out = {}
    for name, sl in info.slices().items():
        arr = packed[:, sl]
        if squeeze_scalar and arr.shape[1] == 1:
            arr = arr[:, 0]
        out[name] = arr
    return out


def stack_columns(field: torch.Tensor) -> torch.Tensor:
    """[tile, nz, ny, nx] -> [tile*ny*nx, nz]; [tile, ny, nx] ->
    [tile*ny*nx]."""
    if field.ndim == 4:
        t, nz, ny, nx = field.shape
        return field.movedim(1, -1).reshape(t * ny * nx, nz)
    if field.ndim == 3:
        t, ny, nx = field.shape
        return field.reshape(t * ny * nx)
    raise ValueError(f"cannot stack shape {tuple(field.shape)}")


def unstack_columns(
    stacked: torch.Tensor, grid_shape: Tuple[int, int, int]
) -> torch.Tensor:
    """Invert stack_columns given (tile, ny, nx)."""
    t, ny, nx = grid_shape
    if stacked.ndim == 2:
        nz = stacked.shape[1]
        return stacked.reshape(t, ny, nx, nz).movedim(-1, 1)
    if stacked.ndim == 1:
        return stacked.reshape(t, ny, nx)
    raise ValueError(f"cannot unstack shape {tuple(stacked.shape)}")


def dataset_to_samples(ds: Dataset,
                       names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The named variables of a Dataset of [sample(, z)] Quantities."""
    return {n: ds[n].data for n in names}


def samples_to_dataset(data: Mapping[str, torch.Tensor]) -> Dataset:
    """[sample(, z)] tensors as a Dataset of Quantities."""
    return Dataset({
        name: Quantity(arr, ("sample",) if arr.ndim == 1 else ("sample", "z"))
        for name, arr in data.items()
    })
