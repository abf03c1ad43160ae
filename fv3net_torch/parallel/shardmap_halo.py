"""The block halo exchange of the sharded layout over ``torch.distributed``
(port of ``fv3net_tpu/parallel/shardmap_halo.py``; reference analog:
pace.util's corner-aware halo exchange between 6 x layout MPI ranks).

Each rank holds the same (r, c) block, my x mx cells, of all six tiles
(``parallel/sharded.py``).  :func:`halo_append_shardmap` gives the
block's extended window [6, ..., my+2h, mx+2h] of the global extended
array that ``halo_append`` builds on one device, bit for bit, corners
included: interior corners from the diagonal in-tile neighbours, edge
blocks from the rotated edge strips of other tiles, the 8 cube corners
from third tiles.

The reference moves the strips with ``lax.ppermute`` in rounds (west/east
from interiors, then south/north rows over the extended width, twice),
sub-split so that each round has unique sources (``_edge_geometry``,
``_round_perms``, ``_shift_perm``, ``_gather_edge_strip``).  Point-to-point
messages have no such constraint, so here one plan, built once per
(C``n``, h, layout), maps every cell of every window to the interior cell
it copies (the single-device append of a grid of cell indices,
``halo_append_numpy``) and so to its owner; a call then sends each peer
one contiguous buffer of all the cells it needs, in one round of
``batch_isend_irecv``, and copies its own cells locally.  With gloo,
CUDA buffers are staged through pinned host memory.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fv3net_torch.grid.geometry import NUM_TILES
from fv3net_torch.parallel import sharded
from fv3net_torch.parallel.halo import halo_append_numpy


@lru_cache(maxsize=None)
def _plan(n: int, h: int, py: int, px: int
          ) -> Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]]:
    """{(dst rank, src rank): (src block flat indices, dst window flat
    indices)}: the cells of dst's extended window [6, my+2h, mx+2h] that
    copy interior cells of src's block [6, my, mx]."""
    if n % py or n % px:
        raise ValueError(f"C{n} not divisible by layout ({py}, {px})")
    my, mx = n // py, n // px
    if h > min(my, mx):
        raise ValueError(f"halo {h} exceeds subdomain size ({my}, {mx})")
    # 1 + the global flat index of the interior cell each extended cell
    # copies (0: a cell the single-device append leaves zero)
    src_of = halo_append_numpy(
        np.arange(1, NUM_TILES * n * n + 1, dtype=np.int64).reshape(
            NUM_TILES, n, n), h)
    plan = {}
    for r in range(py):
        for c in range(px):
            win = src_of[:, r * my: r * my + my + 2 * h,
                         c * mx: c * mx + mx + 2 * h].reshape(-1)
            dst = np.nonzero(win)[0]
            t, j, i = np.unravel_index(win[dst] - 1, (NUM_TILES, n, n))
            owner = (j // my) * px + i // mx
            local = (t * my + j % my) * mx + i % mx
            for o in np.unique(owner):
                sel = owner == o
                plan[(r * px + c, int(o))] = (local[sel], dst[sel])
    return plan


@lru_cache(maxsize=None)
def _device_plan(n, h, py, px, rank, device):
    """This rank's sends ({peer: indices into my block}), receives
    ({peer: indices into my window}) and own copies, on ``device``."""
    plan = _plan(n, h, py, px)

    def t(a):
        return torch.as_tensor(a, dtype=torch.long, device=device)

    sends, recvs = {}, {}
    local = None
    for (dst, src), (s_idx, d_idx) in plan.items():
        if dst == rank and src == rank:
            local = (t(s_idx), t(d_idx))
        elif src == rank:
            sends[dst] = t(s_idx)
        elif dst == rank:
            recvs[src] = t(d_idx)
    return sends, recvs, local


def halo_append_shardmap(field: torch.Tensor, h: int, mesh) -> torch.Tensor:
    """This rank's block ``field`` [6, ..., my, mx] -> its extended window
    [6, ..., my+2h, mx+2h] of the global halo append, through one round
    of point-to-point messages among ``mesh``'s ranks."""
    py, px = mesh.layout
    my, mx = field.shape[-2:]
    n = my * py
    if mx * px != n or field.shape[0] != NUM_TILES:
        raise ValueError(f"block {tuple(field.shape)} does not tile a cube "
                         f"on layout {mesh.layout}")
    lead = tuple(field.shape[1:-2])
    B = int(np.prod(lead)) if lead else 1
    flat = field.reshape(NUM_TILES, B, my * mx).transpose(0, 1).reshape(
        B, NUM_TILES * my * mx)
    ext = field.new_zeros((B, NUM_TILES * (my + 2 * h) * (mx + 2 * h)))
    sends, recvs, local = _device_plan(n, h, py, px, mesh.rank,
                                       field.device)
    staged = sharded.staged(field, mesh)
    ops, landing = [], []
    for peer, idx in sends.items():
        buf = flat[:, idx]
        if staged:
            buf = torch.empty(buf.shape, dtype=buf.dtype,
                              pin_memory=True).copy_(buf)
        ops.append(dist.P2POp(dist.isend, buf, peer, group=mesh.group))
    for peer, idx in recvs.items():
        buf = torch.empty((B, idx.numel()), dtype=field.dtype,
                          device="cpu" if staged else field.device,
                          pin_memory=staged)
        landing.append((buf, idx))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if local is not None:
        ext[:, local[1]] = flat[:, local[0]]
    for buf, idx in landing:
        ext[:, idx] = buf.to(field.device, non_blocking=staged)
    ext = ext.reshape(B, NUM_TILES, my + 2 * h, mx + 2 * h).transpose(0, 1)
    return ext.reshape((NUM_TILES,) + lead + (my + 2 * h, mx + 2 * h))


def halo_blocks_shardmap(field: torch.Tensor, h: int, mesh) -> torch.Tensor:
    """Every rank's extended block, [6, ..., py, px, my+2h, mx+2h], on
    every rank (the reference's return shape; for checks)."""
    ext = halo_append_shardmap(field, h, mesh)
    py, px = mesh.layout
    blocks = torch.stack(sharded.all_gather(ext, mesh)).reshape(
        (py, px) + tuple(ext.shape))
    nd = ext.ndim
    # [py, px, 6, ..., a, b] -> [6, ..., py, px, a, b]
    perm = tuple(range(2, nd)) + (0, 1, nd, nd + 1)
    return blocks.permute(perm)


def blocks_to_global(blocks, h: int):
    """Reassemble block interiors [..., py, px, my+2h, mx+2h] into the
    global [..., ny, nx]."""
    *lead, py, px, me_y, me_x = blocks.shape
    my, mx = me_y - 2 * h, me_x - 2 * h
    interior = blocks[..., h: h + my, h: h + mx]
    out = interior.swapaxes(-3, -2)
    return out.reshape(tuple(lead) + (py * my, px * mx))


def block_slice(ext, r: int, c: int, m: int, h: int, mx: int = None):
    """Block (r, c)'s extended window inside the single-device extended
    array (global interior offset r*m, c*mx)."""
    if mx is None:
        mx = m
    return ext[..., r * m: r * m + m + 2 * h, c * mx: c * mx + mx + 2 * h]
