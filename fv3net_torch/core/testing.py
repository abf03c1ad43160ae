"""Test helpers (port of ``fv3net_tpu/core/testing.py``; reference:
external/vcm/vcm/testing.py — no_warning context,
checksum_dataarray/checksum_dataarray_mapping for golden regression
data).

A tensor hashes as the numpy array of the same values does: numpy's
dtype string and the contiguous host bytes (a tensor on the card is
copied to the host first), so the golden digests of both packages are
one set.
"""
from __future__ import annotations

import contextlib
import hashlib
import warnings
from typing import Hashable, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def no_warning(*args):
    """Assert that the block raises no warning (reference testing.py:12)."""
    with warnings.catch_warnings(record=True) as records:
        warnings.simplefilter("always")
        yield
    matching = [
        r for r in records
        if not args or any(a in str(r.message) for a in args)
    ]
    assert not matching, f"unexpected warnings: {[str(r.message) for r in matching]}"


def checksum_array(arr) -> str:
    """Stable content hash of an array or tensor (reference
    checksum_dataarray)."""
    if torch.is_tensor(arr):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.md5()
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def checksum_dataset(ds) -> Tuple[Tuple[Hashable, str], ...]:
    """Sorted (name, checksum) pairs for a Dataset or mapping of arrays
    (reference checksum_dataarray_mapping)."""
    items = ds.items() if hasattr(ds, "items") else ds
    out = []
    for name, q in items:
        data = getattr(q, "data", q)
        out.append((name, checksum_array(data)))
    return tuple(sorted(out))
