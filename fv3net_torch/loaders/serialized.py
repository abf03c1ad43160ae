"""Serialized-physics training sequences (port of
``fv3net_tpu/loaders/serialized.py``; reference:
external/loaders/loaders/batches/_serialized_phys.py): the savepoints
are the time-leading zarr snapshots the emulation ``StorageHook``
writes, read through the port's ``ZarrGroup``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core.zarrio import ZarrGroup
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity


class SerializedSequence(Sequence[Dataset]):
    """Index physics-state savepoints: seq[i] -> Dataset of variables at
    capture step i (reference _serialized_phys.py SerializedSequence).

    StorageHook stores arrays chunked one capture step per chunk, so
    indexing reads exactly one chunk per variable.
    """

    def __init__(self, path: str, variables: Optional[List[str]] = None):
        self._group = ZarrGroup(path)
        available = self._group.array_names()
        names = variables or available
        self._vars = [n for n in names if n in set(available)]
        if not self._vars:
            raise ValueError(f"no variables found in capture store {path}")
        self._n = self._group[self._vars[0]].shape[0]

    def __len__(self) -> int:
        return self._n

    def _read_step(self, arr, i: int) -> np.ndarray:
        if arr.chunks[0] == 1:
            idx = (i,) + (0,) * (len(arr.shape) - 1)
            chunk = arr._read_chunk(idx)
            sel = tuple(slice(0, s) for s in arr.shape[1:])
            return chunk[(0,) + sel]
        return arr.read()[i]

    def __getitem__(self, i) -> Dataset:
        if isinstance(i, slice):
            raise TypeError("index savepoints one at a time")
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        out = {}
        for v in self._vars:
            arr = self._group[v]
            out[v] = Quantity(
                torch.as_tensor(self._read_step(arr, i)), tuple(arr.dims[1:])
            )
        return Dataset(out)

    def flatten(self, sample_dims: int = 1) -> Dataset:
        """Stack every savepoint into a single [sample, ...] Dataset (the
        reference's FlattenDims wrapper collapsed to one call):
        the leading 1+sample_dims axes merge into "sample"."""
        parts = {}
        for v in self._vars:
            arr = self._group[v]
            data = arr.read()
            lead = int(np.prod(data.shape[: sample_dims + 1]))
            parts[v] = Quantity(
                torch.as_tensor(data).reshape(
                    (lead,) + data.shape[sample_dims + 1:]),
                ("sample",) + tuple(arr.dims[sample_dims + 1:]),
            )
        return Dataset(parts)
