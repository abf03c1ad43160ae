"""Lazy sequences of training batches (port of
``fv3net_tpu/loaders/sequences.py``; reference:
external/loaders/loaders/batches/_sequences.py and
loaders/_one_ahead.py).  ``shuffle`` draws its order from
``np.random.RandomState(seed)`` as the reference does, and ``Local``
writes the reference's on-disk form (one ``%05d.npz`` of arrays and JSON
metadata per item), so either package reads what the other wrote.
"""
from __future__ import annotations

import collections.abc
import concurrent.futures
import glob
import json
import os
from copy import deepcopy
from functools import partial
from typing import Any, Callable, Hashable, MutableMapping, Sequence, TypeVar, Union

import numpy as np

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity

T = TypeVar("T")


class BaseSequence(collections.abc.Sequence):
    """Sequence with lazy combinators (reference _sequences.py:21-43)."""

    def local(self, path: str, n_jobs: int = 4) -> "Local":
        """Persist every item under ``path`` and return the on-disk
        sequence."""
        return to_local(self, path=path, n_jobs=n_jobs)

    def take(self, n: int) -> "Take":
        """First ``n`` elements."""
        return Take(self, n)

    def map(self, func: Callable[[Any], Any]) -> "Map":
        """Lazily apply ``func`` to every element."""
        return Map(func, self)


class Take(BaseSequence):
    """First-n view (reference _sequences.py:46-57)."""

    def __init__(self, parent_seq: Sequence[Any], n: int):
        self._seq = parent_seq
        self.n = n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(len(self))[i]]
        if i < len(self):
            return self._seq[i]
        raise IndexError(i)

    def __len__(self):
        return self.n


class Map(BaseSequence):
    """Lazy function-over-arguments sequence (reference
    _sequences.py:115-152), with slice selection preserving ``attrs``."""

    attrs: MutableMapping[Hashable, Any]

    def __init__(self, func: Callable[..., Any], args_sequence: Sequence[Any]):
        if not isinstance(args_sequence, collections.abc.Sequence):
            raise TypeError(
                f"args_sequence must be a sequence, got {args_sequence}"
            )
        self._func = func
        self._args = args_sequence
        self.attrs = {}

    def __getitem__(self, item: Union[int, slice]):
        if isinstance(item, slice):
            seq = Map(self._func, self._args[item])
            seq.attrs.update(deepcopy(self.attrs))
            return seq
        return self._func(self._args[item])

    def __len__(self) -> int:
        return len(self._args)


def shuffle(sequence: Sequence[T], seed=None) -> Map:
    """Lazily shuffle a sequence (reference _sequences.py:155-166)."""
    rng = np.random.RandomState(seed)
    order = rng.choice(len(sequence), size=len(sequence), replace=False).tolist()
    return Map(partial(_simple_getitem, sequence), order)


def _simple_getitem(sequence: Sequence[Any], item):
    return sequence[item]


class Local(BaseSequence):
    """On-disk sequence of Datasets, one ``%05d.npz`` per item
    (reference _sequences.py:61-88, npz instead of joblib pickles)."""

    def __init__(self, path: str):
        self.path = path

    @property
    def files(self):
        return sorted(glob.glob(os.path.join(self.path, "*.npz")))

    @classmethod
    def dump(cls, dataset: Dataset, path: str) -> None:
        arrays = {name: q.values for name, q in dataset.items()}
        meta = {
            name: {"dims": list(q.dims), "units": q.units}
            for name, q in dataset.items()
        }
        np.savez(path, __meta__=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str) -> Dataset:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            out = {
                name: Quantity(z[name], tuple(m["dims"]), m["units"])
                for name, m in meta.items()
            }
        return Dataset(out)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i):
        sel = self.files[i]
        if isinstance(sel, str):
            return self.load(sel)
        return [self.load(f) for f in sel]


def to_local(sequence: Sequence[Dataset], path: str, n_jobs: int = 4) -> Local:
    """Persist a sequence of Datasets under ``path`` with ``n_jobs``
    writer threads (reference _sequences.py:91-112)."""
    os.makedirs(path, exist_ok=True)

    def save_item(i: int):
        Local.dump(sequence[i], os.path.join(path, "%05d.npz" % i))

    with concurrent.futures.ThreadPoolExecutor(max_workers=n_jobs) as pool:
        list(pool.map(save_item, range(len(sequence))))
    return Local(os.path.abspath(path))


class OneAheadIterator(collections.abc.Iterator):
    """Iterator that pre-computes the next item in a background thread
    (reference loaders/_one_ahead.py) — overlaps host IO with device
    compute in training loops."""

    def __init__(self, args: Sequence[Any], function: Callable[[Any], Any]):
        self.function = function
        self._args = args
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._idx = 0
        self._load_thread = None

    def _start_load(self):
        if self._idx < len(self._args):
            self._load_thread = self._executor.submit(
                self.function, self._args[self._idx]
            )

    def __next__(self):
        if self._idx >= len(self):
            raise StopIteration()
        result = self._load_thread.result()
        self._load_thread = None
        self._idx += 1
        if self._idx < len(self):
            self._start_load()
        return result

    def __iter__(self) -> "OneAheadIterator":
        self._idx = 0
        if self._load_thread is None:
            self._start_load()
        return self

    def __len__(self):
        return len(self._args)

    def __del__(self):
        if hasattr(self, "_executor"):
            self._executor.shutdown(wait=True)
