"""Cubed-sphere halo exchange on one device (port of
``fv3net_tpu/parallel/halo.py``).

Three forms:

- :func:`halo_append_numpy`: host-side float64-exact append over static
  gather tables, used to build geometry tables;
- :func:`halo_append_gather`: the same gather tables on tensors (the
  reference's gather-table form);
- :func:`halo_append`: the static-slice form (``halo_append_concat`` in
  the reference) on tensors.  Every neighbour block is a slice, flip or
  transpose of the neighbour tile, assembled with ``torch.cat``.

Two-phase fill: west/east halos first from neighbour interiors, then
south/north rows across the full extended width (twice), so the 8 cube
corners receive third-tile data.  Vector fields are exchanged
componentwise with no rotation: winds are 3-D Cartesian.

The sharded layout: while a mesh is registered (:func:`set_active_mesh`,
done by ``parallel.sharded.make_mesh``), each rank holds one (y, x)
block of all six tiles and :func:`halo_append` routes a block to the
exchange of ``parallel/shardmap_halo.py``, which gives the block's
window of the global extended array; :class:`no_explicit_halo` clears
the mesh for single-device work in the same process.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from fv3net_torch.grid.geometry import NUM_TILES, EdgeMatch

WEST, EAST, SOUTH, NORTH = 0, 1, 2, 3


def _neighbor_cell(ne: int, d: np.ndarray, s: np.ndarray, n: int):
    """Interior cell (j, i) at depth ``d`` from neighbor edge ``ne``,
    running index ``s`` along that edge."""
    if ne == WEST:
        return s, d
    if ne == EAST:
        return s, n - 1 - d
    if ne == SOUTH:
        return d, s
    if ne == NORTH:
        return n - 1 - d, s
    raise ValueError(ne)


def _neighbor_ext_row(ne: int, d: np.ndarray, s_ext: np.ndarray, n: int,
                      h: int):
    """Extended-array coords of neighbor cells at depth d from edge ne,
    where ``s_ext`` is an extended running index in [-h, n+h)."""
    if ne == WEST:
        return h + s_ext, h + d
    if ne == EAST:
        return h + s_ext, h + n - 1 - d
    if ne == SOUTH:
        return h + d, h + s_ext
    if ne == NORTH:
        return h + n - 1 - d, h + s_ext
    raise ValueError(ne)


@dataclasses.dataclass(frozen=True)
class HaloTables:
    """Static gather tables for halo width ``h`` on a C{n} cube."""

    n: int
    h: int
    # phase A: west/east halos [6, n, 2h] source indices
    we_tile: np.ndarray
    we_j: np.ndarray
    we_i: np.ndarray
    we_dst_i: np.ndarray
    # phase B: south/north rows [6, 2h, n+2h] source indices into EXT
    sn_tile: np.ndarray
    sn_j: np.ndarray
    sn_i: np.ndarray
    sn_dst_j: np.ndarray


def build_halo_tables(
    topology: Dict[Tuple[int, int], EdgeMatch], n: int, h: int
) -> HaloTables:
    we_tile = np.zeros((NUM_TILES, n, 2 * h), np.int32)
    we_j = np.zeros((NUM_TILES, n, 2 * h), np.int32)
    we_i = np.zeros((NUM_TILES, n, 2 * h), np.int32)
    we_dst_i = np.concatenate(
        [np.arange(h), h + n + np.arange(h)]
    ).astype(np.int32)

    dd = np.arange(h)
    S, D = np.meshgrid(np.arange(n), dd, indexing="ij")  # [n, h]
    for t in range(NUM_TILES):
        for e in (WEST, EAST):
            m = topology[(t, e)]
            s_nbr = (n - 1 - S) if m.reversed else S
            jj, ii = _neighbor_cell(m.neighbor_edge, D, s_nbr, n)
            cols = slice(0, h) if e == WEST else slice(h, 2 * h)
            we_tile[t, :, cols] = m.neighbor_tile
            # west halo: dst i = h-1-d -> store depth-reversed
            if e == WEST:
                we_j[t, :, 0:h] = jj[:, ::-1]
                we_i[t, :, 0:h] = ii[:, ::-1]
            else:
                we_j[t, :, h: 2 * h] = jj
                we_i[t, :, h: 2 * h] = ii

    width = n + 2 * h
    sn_tile = np.zeros((NUM_TILES, 2 * h, width), np.int32)
    sn_j = np.zeros((NUM_TILES, 2 * h, width), np.int32)
    sn_i = np.zeros((NUM_TILES, 2 * h, width), np.int32)
    sn_dst_j = np.concatenate(
        [np.arange(h), h + n + np.arange(h)]
    ).astype(np.int32)

    D2, SE = np.meshgrid(dd, np.arange(-h, n + h), indexing="ij")
    for t in range(NUM_TILES):
        for e in (SOUTH, NORTH):
            m = topology[(t, e)]
            s_nbr = (n - 1 - SE) if m.reversed else SE
            jj, ii = _neighbor_ext_row(m.neighbor_edge, D2, s_nbr, n, h)
            rows = slice(0, h) if e == SOUTH else slice(h, 2 * h)
            sn_tile[t, rows, :] = m.neighbor_tile
            if e == SOUTH:
                sn_j[t, 0:h, :] = jj[::-1, :]
                sn_i[t, 0:h, :] = ii[::-1, :]
            else:
                sn_j[t, h: 2 * h, :] = jj
                sn_i[t, h: 2 * h, :] = ii

    return HaloTables(
        n=n, h=h, we_tile=we_tile, we_j=we_j, we_i=we_i,
        we_dst_i=we_dst_i, sn_tile=sn_tile, sn_j=sn_j, sn_i=sn_i,
        sn_dst_j=sn_dst_j,
    )


@lru_cache(maxsize=None)
def _cached_topology():
    """The cube edge topology (independent of resolution)."""
    from fv3net_torch.grid.geometry import make_grid

    return make_grid(4).topology


@lru_cache(maxsize=None)
def _cached_tables(n: int, h: int) -> HaloTables:
    return build_halo_tables(_cached_topology(), n, h)


def halo_append_numpy(field: np.ndarray, h: int) -> np.ndarray:
    """Host-side float64-exact halo append (numpy fancy indexing over the
    gather tables).  Used for geometry-table construction, which must not
    round adjacent-center differences through the device dtype."""
    n = field.shape[-1]
    tables = _cached_tables(n, h)
    lead_shape = field.shape[1:-2]
    B = int(np.prod(lead_shape)) if lead_shape else 1
    f = np.ascontiguousarray(field).reshape(NUM_TILES, B, n, n)

    we = f[tables.we_tile[:, None, :, :], np.arange(B)[None, :, None, None],
           tables.we_j[:, None, :, :], tables.we_i[:, None, :, :]]
    ext = np.zeros((NUM_TILES, B, n + 2 * h, n + 2 * h), field.dtype)
    ext[:, :, h: h + n, h: h + n] = f
    ext[:, :, h: h + n, tables.we_dst_i] = we
    for _ in range(2):
        sn = ext[tables.sn_tile[:, None, :, :],
                 np.arange(B)[None, :, None, None],
                 tables.sn_j[:, None, :, :], tables.sn_i[:, None, :, :]]
        ext[:, :, tables.sn_dst_j, :] = sn
    return ext.reshape(
        (NUM_TILES,) + tuple(lead_shape) + (n + 2 * h, n + 2 * h)
    )


def halo_append_gather(field: torch.Tensor, h: int,
                       tables: HaloTables = None) -> torch.Tensor:
    """Halo append over the gather tables on tensors (the reference's
    gather-table form; :func:`halo_append` is the static-slice one).
    field [6, ..., n, n] -> [6, ..., n+2h, n+2h]."""
    n = field.shape[-1]
    if field.shape[-2] != n:
        raise ValueError(f"expected square tiles, got {tuple(field.shape)}")
    if tables is None:
        tables = _cached_tables(n, h)
    dev = field.device
    lead_shape = tuple(field.shape[1:-2])
    B = int(np.prod(lead_shape)) if lead_shape else 1
    f = field.reshape(NUM_TILES, B, n, n)

    def ix(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    b = torch.arange(B, device=dev)[None, :, None, None]
    # phase A: west/east halo blocks [6, B, n, 2h]
    we = f[ix(tables.we_tile)[:, None], b, ix(tables.we_j)[:, None],
           ix(tables.we_i)[:, None]]
    ext = field.new_zeros((NUM_TILES, B, n + 2 * h, n + 2 * h))
    ext[:, :, h: h + n, h: h + n] = f
    ext[:, :, h: h + n, ix(tables.we_dst_i)] = we
    # phase B, twice: south/north rows over the extended width; corner
    # cells whose source is a neighbour's own halo fill on the second pass
    sn_tile, sn_j, sn_i = (ix(tables.sn_tile)[:, None], ix(tables.sn_j)[:, None],
                           ix(tables.sn_i)[:, None])
    dst = ix(tables.sn_dst_j)
    for _ in range(2):
        ext[:, :, dst, :] = ext[sn_tile, b, sn_j, sn_i]
    return ext.reshape((NUM_TILES,) + lead_shape + (n + 2 * h, n + 2 * h))


def _oriented_block(src, ne: int, rev: bool, h: int, west_or_south: bool,
                    offset: int = 0):
    """The h-deep edge block of a neighbour tile's array ``src``
    [..., R, C] next to its edge ``ne``, oriented so that dim -2 runs
    along the shared edge and dim -1 is depth from the neighbour's edge.
    ``offset`` skips that many rows/cols at the array boundary (h when
    ``src`` is an extended array whose own halo must not be a source)."""
    C = src.shape[-1]
    R = src.shape[-2]
    if ne == WEST:
        block = src[..., :, offset: offset + h]
    elif ne == EAST:
        block = torch.flip(src[..., :, C - offset - h: C - offset], (-1,))
    elif ne == SOUTH:
        block = src[..., offset: offset + h, :].transpose(-1, -2)
    elif ne == NORTH:
        block = torch.flip(
            src[..., R - offset - h: R - offset, :], (-2,)
        ).transpose(-1, -2)
    else:
        raise ValueError(ne)
    if rev:
        block = torch.flip(block, (-2,))
    # the destination's west/south halo is ordered toward the interior
    # (depth decreasing), its east/north halo depth increasing
    if west_or_south:
        block = torch.flip(block, (-1,))
    return block


# ---------------------------------------------------------------------------
# the active mesh: the sharded layout's halo backend
# ---------------------------------------------------------------------------
_ACTIVE_MESH = None


def set_active_mesh(mesh) -> None:
    """Register (or clear, with None) the mesh (``parallel.sharded.Mesh``)
    whose blocks :func:`halo_append` exchanges."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


class no_explicit_halo:
    """Context manager: clear the active mesh for the block, so that a
    single-device computation in a process of a sharded run appends its
    halo (and reduces) on its own tensors."""

    def __enter__(self):
        global _ACTIVE_MESH
        self._saved = _ACTIVE_MESH
        _ACTIVE_MESH = None
        return self

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._saved
        return False


def halo_append(field: torch.Tensor, h: int) -> torch.Tensor:
    """Append an ``h``-deep halo to ``field`` of shape [6, ..., n, n].

    Returns [6, ..., n+2h, n+2h] whose interior equals ``field`` and whose
    border holds the adjacent tiles' data (corners included).  Bit-equal
    to :func:`halo_append_numpy`: only copies, no arithmetic.  While a
    mesh is active, ``field`` is this rank's block and the halo comes
    from the exchange (``shardmap_halo.halo_append_shardmap``).
    """
    if _ACTIVE_MESH is not None:
        from fv3net_torch.parallel.shardmap_halo import halo_append_shardmap

        return halo_append_shardmap(field, h, _ACTIVE_MESH)
    return halo_append_concat(field, h)


def halo_append_concat(field: torch.Tensor, h: int) -> torch.Tensor:
    """The static-slice halo append on one device (the reference's
    ``halo_append_concat``): neighbour blocks are slices, flips and
    transposes of the neighbour tile, assembled with ``torch.cat``."""
    n = field.shape[-1]
    if field.shape[-2] != n or field.shape[0] != NUM_TILES:
        raise ValueError(f"expected [6, ..., n, n] tiles, got {tuple(field.shape)}")
    topo = _cached_topology()
    lead_shape = tuple(field.shape[1:-2])
    B = int(np.prod(lead_shape)) if lead_shape else 1
    f = field.reshape(NUM_TILES, B, n, n)

    # phase A: [6, B, n, n+2h] rows with west/east halos in place
    rows_a = []
    for t in range(NUM_TILES):
        mw, me = topo[(t, WEST)], topo[(t, EAST)]
        wb = _oriented_block(f[mw.neighbor_tile], mw.neighbor_edge,
                             mw.reversed, h, west_or_south=True)
        eb = _oriented_block(f[me.neighbor_tile], me.neighbor_edge,
                             me.reversed, h, west_or_south=False)
        rows_a.append(torch.cat([wb, f[t], eb], dim=-1))
    wext = torch.stack(rows_a)

    # phase B: south/north rows over the extended width, twice (the second
    # pass fixes corners whose source was a neighbour's own halo)
    zrows = field.new_zeros((NUM_TILES, B, h, n + 2 * h))
    ext = torch.cat([zrows, wext, zrows], dim=-2)
    for _ in range(2):
        tiles = []
        for t in range(NUM_TILES):
            ms, mn = topo[(t, SOUTH)], topo[(t, NORTH)]
            sb = _oriented_block(ext[ms.neighbor_tile], ms.neighbor_edge,
                                 ms.reversed, h, west_or_south=True,
                                 offset=h)
            nb = _oriented_block(ext[mn.neighbor_tile], mn.neighbor_edge,
                                 mn.reversed, h, west_or_south=False,
                                 offset=h)
            tiles.append(torch.cat(
                [sb.transpose(-1, -2), ext[t, :, h: h + n, :],
                 nb.transpose(-1, -2)],
                dim=-2,
            ))
        ext = torch.stack(tiles)
    return ext.reshape((NUM_TILES,) + lead_shape + (n + 2 * h, n + 2 * h))
