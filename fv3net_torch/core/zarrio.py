"""Minimal zarr-v2 store, numpy + stdlib (port of
``fv3net_tpu/core/zarrio.py``).

Implements the zarr v2 on-disk format directly (``.zarray``/``.zgroup``/
``.zattrs`` JSON + C-order chunk files, optional zlib codec) with
xarray's ``_ARRAY_DIMENSIONS`` convention, so stores written here are
read by the reference package, by zarr-python and by xarray, and the
reverse.  Chunks are read and written one at a time in Python; the
reference's threaded native chunk I/O, its ``ZarrMapping`` and its
``open_delayed`` are not ported.
"""
from __future__ import annotations

import itertools
import json
import os
import zlib
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity

_DIM_KEY = "_ARRAY_DIMENSIONS"


def _dtype_str(dtype: np.dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype.byteorder == "=":
        return ("<" if np.little_endian else ">") + dtype.kind + str(dtype.itemsize)
    return dtype.str


def _chunk_grid(shape: Sequence[int], chunks: Sequence[int]):
    return [max(1, -(-s // c)) for s, c in zip(shape, chunks)]


class ZarrArray:
    """A single zarr v2 array on disk, supporting region writes and reads."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        fv = meta.get("fill_value", 0)
        if isinstance(fv, str):  # zarr v2 encodes NaN/Infinity as strings
            fv = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[fv]
        if fv is None:  # zarr "undefined" fill: any value is legal for holes
            fv = 0
        self.fill_value = fv
        comp = meta.get("compressor")
        self.compressed = comp is not None and comp.get("id") == "zlib"
        self.attrs: Dict[str, Any] = {}
        attrs_path = os.path.join(path, ".zattrs")
        if os.path.exists(attrs_path):
            with open(attrs_path) as f:
                self.attrs = json.load(f)

    @property
    def dims(self) -> Tuple[str, ...]:
        return tuple(self.attrs.get(_DIM_KEY, [f"dim_{i}" for i in range(len(self.shape))]))

    @classmethod
    def create(
        cls,
        path: str,
        shape: Sequence[int],
        dtype,
        chunks: Optional[Sequence[int]] = None,
        dims: Optional[Sequence[str]] = None,
        attrs: Optional[Mapping[str, Any]] = None,
        compress: bool = False,
        fill_value=0,
    ) -> "ZarrArray":
        os.makedirs(path, exist_ok=True)
        shape = tuple(int(s) for s in shape)
        chunks = tuple(int(c) for c in (chunks or shape))
        dtype = np.dtype(dtype)
        if isinstance(fill_value, str):
            pass  # already a zarr v2 special-float token ("NaN", ...)
        elif fill_value is not None and np.issubdtype(dtype, np.floating):
            if np.isnan(fill_value):
                fill_value = "NaN"
            else:
                fill_value = float(fill_value)
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": list(chunks),
            "dtype": _dtype_str(dtype),
            "compressor": {"id": "zlib", "level": 1} if compress else None,
            "fill_value": fill_value,
            "order": "C",
            "filters": None,
        }
        with open(os.path.join(path, ".zarray"), "w") as f:
            json.dump(meta, f)
        all_attrs = dict(attrs or {})
        if dims is not None:
            all_attrs[_DIM_KEY] = list(dims)
        with open(os.path.join(path, ".zattrs"), "w") as f:
            json.dump(all_attrs, f)
        return cls(path)

    def resize(self, shape: Sequence[int]) -> None:
        """Grow (or shrink) the logical shape; chunk layout unchanged: the
        append-along-time primitive of the diagnostics pipelines."""
        shape = tuple(int(s) for s in shape)
        meta_path = os.path.join(self.path, ".zarray")
        with open(meta_path) as f:
            meta = json.load(f)
        meta["shape"] = list(shape)
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        self.shape = shape

    def resize_time(self, n: int) -> None:
        """Resize the leading (time) axis to ``n``."""
        self.resize((n,) + self.shape[1:])

    # -- chunk io -----------------------------------------------------------
    def _chunk_path(self, idx: Tuple[int, ...]) -> str:
        key = ".".join(str(i) for i in idx) if idx else "0"
        return os.path.join(self.path, key)

    def _read_chunk(self, idx: Tuple[int, ...]) -> np.ndarray:
        p = self._chunk_path(idx)
        if not os.path.exists(p):
            return np.full(self.chunks, self.fill_value, self.dtype)
        with open(p, "rb") as f:
            raw = f.read()
        if self.compressed:
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, self.dtype).reshape(self.chunks).copy()

    def _write_chunk(self, idx: Tuple[int, ...], data: np.ndarray):
        raw = np.ascontiguousarray(data, self.dtype).tobytes()
        if self.compressed:
            raw = zlib.compress(raw, 1)
        with open(self._chunk_path(idx), "wb") as f:
            f.write(raw)

    # -- array io -------------------------------------------------------------
    def __setitem__(self, key, value):
        """Region write. ``key`` is a tuple of slices with step 1 (or ints)."""
        if not isinstance(key, tuple):
            key = (key,)
        sel = []
        for k, size in zip(key + (slice(None),) * (len(self.shape) - len(key)),
                           self.shape):
            if isinstance(k, (int, np.integer)):
                k = int(k) + size if k < 0 else int(k)
                sel.append(slice(k, k + 1))
            else:
                start, stop, step = k.indices(size)
                if step != 1:
                    raise ValueError("only contiguous region writes supported")
                sel.append(slice(start, stop))
        value = np.broadcast_to(
            np.asarray(value, self.dtype),
            tuple(s.stop - s.start for s in sel),
        )
        grid = _chunk_grid(self.shape, self.chunks)
        # iterate over intersecting chunks
        ranges = []
        for s, c, g in zip(sel, self.chunks, grid):
            first = s.start // c
            last = (s.stop - 1) // c if s.stop > s.start else first - 1
            ranges.append(range(first, last + 1))
        for idx in itertools.product(*ranges):
            chunk_sel = []
            val_sel = []
            full = True
            for i, (ci, s, c, size) in enumerate(
                zip(idx, sel, self.chunks, self.shape)
            ):
                c0 = ci * c
                lo = max(s.start, c0)
                hi = min(s.stop, c0 + c)
                chunk_sel.append(slice(lo - c0, hi - c0))
                val_sel.append(slice(lo - s.start, hi - s.start))
                if lo != c0 or hi != c0 + c:
                    full = False
            piece = value[tuple(val_sel)]
            if full:
                chunk = np.ascontiguousarray(piece, self.dtype)
            else:
                chunk = self._read_chunk(idx)
                chunk[tuple(chunk_sel)] = piece
            self._write_chunk(idx, chunk)

    def read(self) -> np.ndarray:
        grid = _chunk_grid(self.shape, self.chunks)
        out = np.full(
            tuple(g * c for g, c in zip(grid, self.chunks)),
            self.fill_value,
            self.dtype,
        )
        for idx in itertools.product(*[range(g) for g in grid]):
            sel = tuple(
                slice(i * c, (i + 1) * c) for i, c in zip(idx, self.chunks)
            )
            out[sel] = self._read_chunk(idx)
        return out[tuple(slice(0, s) for s in self.shape)]


class ZarrGroup:
    """A zarr v2 group directory holding arrays."""

    def __init__(self, path: str):
        self.path = path
        self.attrs: Dict[str, Any] = {}
        attrs_path = os.path.join(path, ".zattrs")
        if os.path.exists(attrs_path):
            with open(attrs_path) as f:
                self.attrs = json.load(f)

    @classmethod
    def create(cls, path: str, attrs: Optional[Mapping[str, Any]] = None):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, ".zgroup"), "w") as f:
            json.dump({"zarr_format": 2}, f)
        with open(os.path.join(path, ".zattrs"), "w") as f:
            json.dump(dict(attrs or {}), f)
        return cls(path)

    def array_names(self):
        names = []
        for name in sorted(os.listdir(self.path)):
            if os.path.isdir(os.path.join(self.path, name)) and os.path.exists(
                os.path.join(self.path, name, ".zarray")
            ):
                names.append(name)
        return names

    def __getitem__(self, name: str) -> ZarrArray:
        return ZarrArray(os.path.join(self.path, name))

    def create_array(self, name: str, **kwargs) -> ZarrArray:
        return ZarrArray.create(os.path.join(self.path, name), **kwargs)


# -- Dataset-level helpers ----------------------------------------------------

def to_zarr(
    ds: Dataset,
    path: str,
    chunks: Optional[Mapping[str, int]] = None,
    compress: bool = False,
):
    """Write a Dataset to a zarr group (xarray conventions)."""
    group = ZarrGroup.create(path, attrs=ds.attrs)
    chunks = dict(chunks or {})
    for name, q in ds.items():
        arr_chunks = tuple(
            chunks.get(d, s) for d, s in zip(q.dims, q.shape)
        )
        arr = group.create_array(
            name,
            shape=q.shape,
            dtype=q.values.dtype,
            chunks=arr_chunks,
            dims=q.dims,
            attrs=q.attrs,
            compress=compress,
        )
        arr[tuple(slice(0, s) for s in q.shape)] = q.values
    for name, coord in ds.coords.items():
        coord = np.asarray(coord)
        arr = group.create_array(
            name,
            shape=coord.shape,
            dtype=coord.dtype,
            chunks=coord.shape,
            dims=(name,) if coord.ndim == 1 else None,
            compress=compress,
        )
        arr[tuple(slice(0, s) for s in coord.shape)] = coord
    return group


def open_zarr(path: str) -> Dataset:
    """Read a zarr group written by this module (or zarr-python) into a Dataset."""
    group = ZarrGroup(path)
    data_vars = {}
    coords = {}
    for name in group.array_names():
        arr = group[name]
        dims = arr.dims
        data = arr.read()
        if dims == (name,):
            coords[name] = data
        else:
            attrs = {k: v for k, v in arr.attrs.items() if k != _DIM_KEY}
            data_vars[name] = Quantity(
                data, dims, units=attrs.get("units", ""), attrs=attrs
            )
    return Dataset(data_vars, coords, group.attrs)


def consolidate_metadata(path: str) -> str:
    """Write zarr v2 consolidated metadata (``.zmetadata``) for a group
    (reference workflows/post_process_run/fv3post/consolidate_metadata.py)
    so zarr-python/xarray clients open the store with one read."""
    meta = {}
    for name in (".zgroup", ".zattrs"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            with open(p) as f:
                meta[name] = json.load(f)
    group = ZarrGroup(path)
    for arr_name in group.array_names():
        for name in (".zarray", ".zattrs"):
            p = os.path.join(path, arr_name, name)
            if os.path.exists(p):
                with open(p) as f:
                    meta[f"{arr_name}/{name}"] = json.load(f)
    out = os.path.join(path, ".zmetadata")
    with open(out, "w") as f:
        json.dump({"metadata": meta, "zarr_consolidated_format": 1}, f)
    return out
