"""Zarr-backed mappers (port of the ``ZarrMapper`` of
``fv3net_tpu/loaders/batches.py``; reference:
external/loaders/loaders/mappers/_xarray.py:9-56).  The batch stacking
of the reference module is not ported."""
from __future__ import annotations

from typing import Iterator, Mapping

from fv3net_torch.core import zarrio
from fv3net_torch.core.dataset import Dataset


class ZarrMapper(Mapping[str, Dataset]):
    """Time-keyed Mapping[str, Dataset] over a zarr store with a leading
    time dimension (the XarrayMapper equivalent); keys are the time
    indices as strings."""

    def __init__(self, path: str, time_dim: str = "time"):
        self._ds = zarrio.open_zarr(path)
        self._time_dim = time_dim
        n_times = self._ds.dims.get(time_dim)
        if n_times is None:
            raise ValueError(f"no {time_dim!r} dimension in {path}")
        self._keys = [str(i) for i in range(n_times)]

    def __getitem__(self, key: str) -> Dataset:
        i = self._keys.index(key)
        return self._ds.isel({self._time_dim: i})

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)
