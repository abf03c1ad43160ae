"""Strict dataset access, sampling and combining (port of
``fv3net_tpu/core/safe.py``; reference: external/vcm/vcm/safe.py,
vcm/sampling.py and vcm/combining.py) over the port's Dataset and
Quantity containers.  The samplers draw as the reference does (Python's
``random.Random(seed)``), so the same seed picks the same windows.
"""
from __future__ import annotations

import random
import warnings
from collections import defaultdict
from typing import Any, Hashable, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity


def get_variables(ds: Dataset, variables: Iterable[Hashable]) -> Dataset:
    """ds[variables] with an error naming every missing variable
    (reference safe.py:9-20)."""
    variables = list(variables)
    missing = [v for v in variables if v not in ds]
    if missing:
        raise KeyError(
            f"{missing} missing from dataset with variables "
            f"{sorted(ds.keys())}"
        )
    return Dataset({v: ds[v] for v in variables}, coords=dict(ds.coords))


def warn_if_intersecting(old: Iterable[Hashable], new: Iterable[Hashable]):
    """(reference safe.py:47-56)"""
    overlap = set(old) & set(new)
    if overlap:
        warnings.warn(
            f"renaming will overwrite existing variables: {sorted(overlap)}",
            UserWarning,
        )


def stack_once(ds: Dataset, dim: str, dims: Sequence[str]) -> Dataset:
    """Stack ``dims`` into a new leading ``dim``; every variable must carry
    all of them (reference safe.py:23-44)."""
    out = {}
    for name, q in ds.items():
        if not set(dims) <= set(q.dims):
            raise ValueError(
                f"{name} has dims {q.dims}; cannot stack {dims}"
            )
        order = [d for d in q.dims if d not in dims] + list(dims)
        perm = [q.dims.index(d) for d in order]
        arr = torch.as_tensor(q.data).permute(*perm)
        keep = tuple(arr.shape[: arr.ndim - len(dims)])
        stacked = (arr.reshape(keep + (-1,)).movedim(-1, 0) if keep
                   else arr.reshape(-1))
        out[name] = Quantity(
            stacked, (dim,) + tuple(d for d in q.dims if d not in dims),
            q.units,
        )
    return Dataset(out)


# ------------------------------------------------------------- sampling
def sample(seq: Sequence, n_samples: int, window: int = 2,
           seed: int = 0) -> List[Tuple]:
    """Random sample of sliding windows (reference sampling.py:5-8)."""
    windows = [tuple(seq[i: i + window])
               for i in range(len(seq) - window + 1)]
    rng = random.Random(seed)
    rng.shuffle(windows)
    return windows[:n_samples]


def train_test_split_sample(seq: Sequence, boundary, train_samples: int,
                            test_samples: int, seed: int = 0):
    """Split a sorted sequence at ``boundary`` and sample consecutive
    pairs from each side (reference sampling.py:11-40)."""
    seq = sorted(seq)
    train_seq = [t for t in seq if t < boundary]
    test_seq = [t for t in seq if t >= boundary]
    return {
        "train": sample(train_seq, train_samples, seed=seed),
        "test": sample(test_seq, test_samples, seed=seed),
    }


# ------------------------------------------------------------ combining
def combine_array_sequence(
    arrays: Iterable[Tuple[Hashable, Tuple, Any]],
    labels: Sequence[str],
) -> Dataset:
    """Merge (name, keys, array) tuples into one Dataset with the key
    tuple's entries as new leading dimensions (reference
    combining.py:29-70); the label coordinates go into ``ds.coords``."""
    by_name: dict = defaultdict(dict)
    for name, keys, arr in arrays:
        if len(keys) != len(labels):
            raise ValueError(
                f"{name}: key tuple {keys} does not match labels {labels}"
            )
        if torch.is_tensor(arr):
            arr = arr.detach().cpu().numpy()
        by_name[name][tuple(keys)] = np.asarray(arr)
    out = {}
    coords = {}
    for name, entries in by_name.items():
        key_axes = [sorted({k[i] for k in entries})
                    for i in range(len(labels))]
        first = next(iter(entries.values()))
        shape = tuple(len(a) for a in key_axes) + first.shape
        data = np.empty(shape, first.dtype)
        for keys, arr in entries.items():
            idx = tuple(key_axes[i].index(keys[i])
                        for i in range(len(labels)))
            data[idx] = arr
        dims = tuple(labels) + tuple(f"dim_{i}" for i in range(first.ndim))
        out[name] = Quantity(torch.as_tensor(data), dims)
        for lab, ax in zip(labels, key_axes):
            coords[lab] = np.asarray(ax)
    return Dataset(out, coords=coords)
