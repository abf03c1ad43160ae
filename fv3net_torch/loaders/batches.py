"""Zarr-backed mappers and stacked batches (port of
``fv3net_tpu/loaders/batches.py``; reference:
external/loaders/loaders/mappers/_xarray.py:9-56 and
batches/_batch.py:45-118, 265-286).

``batches_from_mapper`` groups the mapper's times, stacks [tile, z, y, x]
fields into [sample, z] columns and draws the key shuffle and then each
batch's subsample from one ``np.random.RandomState(shuffle_seed)``.  A
batch's subsample is one set of columns taken from every variable, as
upstream fv3fit subsamples the stacked dataset, so the inputs and
targets of a row stay one column (``fv3net_tpu``'s draws a set for each
variable; ROADMAP.md Queue 3).  The batches hold CPU tensors; the
trainer's CLI moves them (``fit/train.py::batches_on``).
"""
from __future__ import annotations

from typing import Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core import zarrio
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit.packer import stack_columns


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


def stack_dataset(ds: Dataset, variables: Sequence[str]) -> Dataset:
    """Stack [tile, z, y, x] (or [tile, y, x]) variables into [sample(, z)]
    Quantities."""
    out = {}
    for name in variables:
        q = ds[name]
        stacked = stack_columns(torch.as_tensor(q.data))
        dims = ("sample", "z") if stacked.ndim == 2 else ("sample",)
        out[name] = Quantity(stacked, dims, q.units)
    return Dataset(out)


def batches_from_mapper(
    mapper: Mapping[str, Dataset],
    variables: Sequence[str],
    timesteps: Optional[Sequence[str]] = None,
    timesteps_per_batch: int = 1,
    subsample_ratio: float = 1.0,
    shuffle_seed: Optional[int] = None,
) -> List[Dataset]:
    """Stacked sample batches from a time mapper (reference
    batches/_batch.py:45-118: group timesteps, stack, shuffle the keys
    and subsample each batch's columns, sorted, the same columns for
    every variable)."""
    keys = list(timesteps if timesteps is not None else mapper)
    rng = np.random.RandomState(shuffle_seed)
    if shuffle_seed is not None:
        rng.shuffle(keys)
    batches = []
    for start in range(0, len(keys), timesteps_per_batch):
        group = keys[start: start + timesteps_per_batch]
        stacked = [stack_dataset(mapper[k], variables) for k in group]
        merged = {name: torch.cat([s[name].data for s in stacked], dim=0)
                  for name in variables}
        if subsample_ratio < 1.0 and variables:
            n = merged[variables[0]].shape[0]
            take = max(1, int(n * subsample_ratio))
            idx = torch.as_tensor(np.sort(rng.choice(n, size=take,
                                                     replace=False)))
            merged = {name: arr[idx] for name, arr in merged.items()}
        batches.append(Dataset({name: Quantity(arr, stacked[0][name].dims)
                                for name, arr in merged.items()}))
    return batches


def batches_from_config(config: dict) -> List[Dataset]:
    """The legacy ``{kind: zarr, path, variables, ...}`` data config
    (reference loaders/_config.py:56-87's role)."""
    kind = config.get("kind", "zarr")
    if kind == "zarr":
        mapper = ZarrMapper(config["path"], config.get("time_dim", "time"))
        return batches_from_mapper(
            mapper,
            config["variables"],
            timesteps=config.get("timesteps"),
            timesteps_per_batch=config.get("timesteps_per_batch", 1),
            subsample_ratio=config.get("subsample_ratio", 1.0),
            shuffle_seed=config.get("shuffle_seed"),
        )
    raise ValueError(f"unknown batches kind {kind!r}")


def batches_from_netcdf(
    path: str,
    variable_names: Sequence[str],
    in_memory: bool = False,
) -> Sequence[Dataset]:
    """Lazy sequence of Datasets from a directory of netCDF files in
    alphabetical order (reference batches/_batch.py:265-286), each
    holding ``variable_names``."""
    import glob
    import os

    from fv3net_torch.core.netcdfio import open_netcdf
    from fv3net_torch.core.safe import get_variables
    from fv3net_torch.loaders.sequences import Map

    filenames = sorted(glob.glob(os.path.join(path, "*.nc")))

    def load(fname: str) -> Dataset:
        return get_variables(open_netcdf(fname), variable_names)

    seq = Map(load, filenames)
    if in_memory:
        return tuple(seq[i] for i in range(len(seq)))
    return seq
