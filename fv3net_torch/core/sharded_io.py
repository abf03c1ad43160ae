"""Sharded zarr IO of the sharded layout (port of
``fv3net_tpu/core/sharded_io.py``; reference: pace.util.ZarrMonitor
writes per-rank regions of one shared store,
runtime/diagnostics/manager.py:58-60, and pace.util.open_restart reads
per rank, runtime/nudging.py:133-139).

Each rank writes or reads only its own block's region of one store,
through the port's ``core/zarrio.py``.  The store is chunked by block
(one chunk per rank along y and x), so the writes touch disjoint chunk
files and need no lock; rank 0 creates the array, and the ranks meet at
a barrier before and after their writes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fv3net_torch.core.zarrio import ZarrArray, ZarrGroup
from fv3net_torch.parallel import sharded


def global_shape(block_shape, mesh) -> Tuple[int, ...]:
    """The global shape of an array whose trailing (y, x) axes are this
    layout's blocks."""
    py, px = mesh.layout
    return tuple(block_shape[:-2]) + (block_shape[-2] * py,
                                      block_shape[-1] * px)


def write_sharded(group: ZarrGroup, name: str, block: torch.Tensor,
                  dims: Optional[Tuple[str, ...]] = None,
                  mesh=None) -> ZarrArray:
    """Write each rank's ``block`` (the trailing (y, x) axes its block of
    the global array) into one array ``name`` of ``group``, created by
    rank 0 (if missing) with one chunk per block."""
    mesh = mesh or sharded.active()
    arr = block.detach().cpu().numpy()
    shape = global_shape(arr.shape, mesh)
    if mesh.rank == 0 and name not in group.array_names():
        group.create_array(name, shape=shape, dtype=arr.dtype,
                           chunks=arr.shape, dims=dims)
    dist.barrier(group=mesh.group)
    za = group[name]
    write_block(za, arr, mesh)
    dist.barrier(group=mesh.group)
    return za


def write_block(za: ZarrArray, block: np.ndarray, mesh, index=()) -> None:
    """Write this rank's ``block`` into its region of ``za`` (created and
    sized by rank 0), after the leading ``index`` (say, a time row)."""
    ys, xs = mesh.block(za.shape[-1])
    za[tuple(index) + (slice(None),) * (block.ndim - 2) + (ys, xs)] = block


def read_sharded(group: ZarrGroup, name: str, mesh=None,
                 device=None) -> torch.Tensor:
    """This rank's block of array ``name``: one chunk read where the store
    is chunked by block, else the region of a whole read."""
    mesh = mesh or sharded.active()
    za = group[name]
    ys, xs = mesh.block(za.shape[-1])
    my, mx = ys.stop - ys.start, xs.stop - xs.start
    lead = za.shape[:-2]
    if za.chunks == tuple(lead) + (my, mx):
        block = za._read_chunk((0,) * len(lead)
                               + (ys.start // my, xs.start // mx))
    else:
        block = za.read()[..., ys, xs]
    return torch.as_tensor(np.ascontiguousarray(block), device=device)
