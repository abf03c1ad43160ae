"""Post-processing of run output: combine segments, rechunk, cast (port of
``fv3net_tpu/post_process.py``; reference:
workflows/post_process_run/fv3post).  Combining, rechunking and casting
are host code, copied; the regrid to lat-lon
(:func:`regrid_zarr_to_latlon`, in place of the reference's ``fregrid``
binary) runs on ``device`` through
:class:`fv3net_torch.ops.regrid_latlon.CubeToLatLon`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fv3net_torch.core import zarrio
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity


def cast_to_float32(ds: Dataset) -> Dataset:
    """(reference post_process.py cast_time / float casting)"""
    out = {}
    for name, q in ds.items():
        arr = q.values
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        out[name] = Quantity(arr, q.dims, q.units, dict(q.attrs))
    return Dataset(out, coords=dict(ds.coords))


def rechunk(ds: Dataset, chunks: Dict[str, int]) -> Dict[str, tuple]:
    """Resolve per-variable chunk tuples from a dim->size mapping
    (reference post_process.py rechunking config)."""
    out = {}
    for name, q in ds.items():
        out[name] = tuple(
            min(chunks.get(d, s), s) for d, s in zip(q.dims, q.shape)
        )
    return out


def append_segment_to_store(segment_zarr: str, store_path: str) -> None:
    """Append a segment's zarr along time to a growing store, shifting
    time indices (reference append.py:*: set_time_units / shift chunks)."""
    seg = zarrio.open_zarr(segment_zarr)
    if not os.path.isdir(store_path):
        zarrio.to_zarr(cast_to_float32(seg), store_path)
        return
    group = zarrio.ZarrGroup(store_path)
    for name in seg:
        if name not in group.array_names():
            continue
        za = group[name]
        t0 = za.shape[0]
        new = seg[name].values
        za.resize((t0 + new.shape[0],) + za.shape[1:])
        za[(slice(t0, t0 + new.shape[0]),)] = new.astype(za.dtype)
    # time coordinate
    if "time" in group.array_names() and "time" in seg.coords:
        za = group["time"]
        t0 = za.shape[0]
        new_t = np.asarray(seg.coords["time"])
        za.resize((t0 + len(new_t),))
        za[(slice(t0, t0 + len(new_t)),)] = new_t


def post_process(
    rundir: str,
    destination: str,
    chunks: Optional[Dict[str, int]] = None,
    names: Optional[Sequence[str]] = None,
) -> List[str]:
    """Combine every segment's diagnostics zarrs into per-name stores at
    ``destination`` (reference post_process.py:170-181 main flow)."""
    artifacts = os.path.join(rundir, "artifacts")
    segments = sorted(os.listdir(artifacts)) if os.path.isdir(artifacts) else []
    os.makedirs(destination, exist_ok=True)
    written = []
    for seg in segments:
        seg_dir = os.path.join(artifacts, seg)
        for entry in sorted(os.listdir(seg_dir)):
            if not entry.endswith(".zarr"):
                continue
            if names is not None and entry not in names:
                continue
            store = os.path.join(destination, entry)
            append_segment_to_store(os.path.join(seg_dir, entry), store)
            if store not in written:
                written.append(store)
    from fv3net_torch.core.zarrio import consolidate_metadata

    for store in written:
        # reference fv3post consolidates metadata after appends so
        # zarr/xarray clients open each store with a single read
        consolidate_metadata(store)
    return written


def regrid_zarr_to_latlon(
    input_zarr: str,
    output_zarr: str,
    nlat: int = 180,
    nlon: int = 360,
    device="cuda",
) -> None:
    """Regrid every cube-shaped variable of a zarr store to lat-lon on
    ``device`` (the reference shells out to the fregrid binary:
    workflows/post_process_run/fv3post/fregrid.py:16-56): each variable's
    leading axes are one batch of the regridder's scatter-add."""
    import torch

    from fv3net_torch.core.zarrio import open_zarr, to_zarr
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.ops.regrid_latlon import CubeToLatLon

    ds = open_zarr(input_zarr)
    regridder = None
    out = {}
    for name, q in ds.items():
        dims = tuple(q.dims)
        if "tile" not in dims or "y" not in dims or "x" not in dims:
            continue
        n = q.shape[dims.index("x")]
        if regridder is None:
            regridder = CubeToLatLon(make_grid(n), nlat=nlat, nlon=nlon,
                                     device=device)
        # move (tile, y, x) last, flatten the rest as batch
        other = [d for d in dims if d not in ("tile", "y", "x")]
        perm = [dims.index(d) for d in other] + [
            dims.index("tile"), dims.index("y"), dims.index("x")
        ]
        arr = torch.as_tensor(np.asarray(q.values),
                              device=regridder.device).permute(perm)
        batch = arr.reshape((-1,) + arr.shape[len(other):])
        ll = regridder(batch).reshape(tuple(arr.shape[: len(other)])
                                      + (nlat, nlon))
        out[name] = Quantity(ll.cpu().numpy(), tuple(other) + ("lat", "lon"),
                             q.units)
    if not out:
        raise ValueError(f"no cube-shaped variables found in {input_zarr}")
    coords = {
        k: v for k, v in ds.coords.items() if k in set(
            d for q in out.values() for d in q.dims
        )
    }
    to_zarr(Dataset(out, coords), output_zarr)
