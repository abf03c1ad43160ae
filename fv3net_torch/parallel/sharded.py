"""The sharded layout on ``torch.distributed`` (port of
``fv3net_tpu/parallel/sharded.py``; reference: pace.util
CubedSpherePartitioner over MPI, 6 tiles x layout ranks).

A (py, px) layout over the ranks of a process group: rank ``r * px + c``
holds the (r, c) block, ``ny/py`` by ``nx/px`` cells, of all six tiles,
as the reference's mesh ``("fv", "fv_x")`` shards the intra-tile (y, x)
axes.  The reference hands a global program to XLA's partitioner; PyTorch
has none, so each rank runs the dycore, physics and radiation on its
block, with the explicit halo exchange of ``parallel/shardmap_halo.py``
and the collectives below wherever the step reduces over the grid or
draws in the global column order.  Each helper is the identity while no
mesh is active, so the single-device step is unchanged.

The process group is the caller's (gloo on the CPU, or for several ranks
on one card; NCCL across cards); with gloo, CUDA tensors are staged
through pinned host memory.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fv3net_torch.parallel import halo as _halo


def default_layout(n_devices: int) -> Tuple[int, int]:
    """Squarest (py, px) factorization with py >= px."""
    px = int(np.floor(np.sqrt(n_devices)))
    while n_devices % px:
        px -= 1
    return n_devices // px, px


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (py, px) layout over ``group``'s ranks; this process is
    ``rank``, the (r, c) block."""

    layout: Tuple[int, int]
    rank: int
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.layout[0] * self.layout[1]

    @property
    def rc(self) -> Tuple[int, int]:
        return divmod(self.rank, self.layout[1])

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def block(self, n: int, rank: Optional[int] = None
              ) -> Tuple[slice, slice]:
        """The (y, x) slices of ``rank``'s block (default this rank's) of
        a C``n`` tile."""
        py, px = self.layout
        if n % py or n % px:
            raise ValueError(f"C{n} not divisible by layout {self.layout}")
        r, c = divmod(self.rank if rank is None else rank, px)
        my, mx = n // py, n // px
        return slice(r * my, (r + 1) * my), slice(c * mx, (c + 1) * mx)


def make_mesh(n_devices: Optional[int] = None,
              layout: Optional[Tuple[int, int]] = None) -> Mesh:
    """The layout over the ranks of the default process group, which must
    number ``py * px``; registered as the active mesh, so that
    ``halo_append`` exchanges blocks.  Raises the reference's
    ``ValueError`` without an initialised process group of that size."""
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if layout is None:
        layout = default_layout(n_devices or world)
    py, px = (int(v) for v in layout)
    need = py * px
    if n_devices is not None and n_devices != need:
        raise ValueError(f"layout {layout} != {n_devices} devices")
    if world != need or not dist.is_initialized():
        raise ValueError(
            f"namelist layout {(py, px)} needs {need} devices; {world} "
            "visible (run one process per block under torchrun, with an "
            "initialised torch.distributed process group)")
    mesh = Mesh((py, px), dist.get_rank())
    _halo.set_active_mesh(mesh)
    return mesh


def active() -> Optional[Mesh]:
    return _halo.active_mesh()


# ------------------------------------------------------------ cutting
def _cut(x, mesh: Mesh, n: int):
    """This rank's block of the trailing (y, x) axes of ``x``; an axis of
    n + 1 (the cell faces) keeps the block's closing face."""
    if not torch.is_tensor(x) or x.ndim < 2:
        return x
    ys, xs = mesh.block(n)
    a, b = x.shape[-2:]
    if a not in (n, n + 1) or b not in (n, n + 1):
        return x
    ys = slice(ys.start, ys.stop + (a - n))
    xs = slice(xs.start, xs.stop + (b - n))
    return x[..., ys, xs].contiguous()


def shard_state(state, mesh: Mesh):
    """This rank's block of a global DycoreState."""
    n = state.delp.shape[-1]
    return dataclasses.replace(
        state,
        delp=_cut(state.delp, mesh, n), pt=_cut(state.pt, mesh, n),
        wind=_cut(state.wind, mesh, n), phis=_cut(state.phis, mesh, n),
        w=None if state.w is None else _cut(state.w, mesh, n),
        delz=None if state.delz is None else _cut(state.delz, mesh, n),
        tracers={k: _cut(v, mesh, n) for k, v in state.tracers.items()},
    )


def shard_yx(field, mesh: Mesh):
    """This rank's block of the trailing (y, x) axes of any field of rank
    >= 2 ([6, ny, nx] surface fields, Noah's [nlayer, 6, ny, nx], ...);
    a field of rank < 2 (ak, bk, a scalar) every rank holds whole, as it
    does the model weights (the reference's ``shard_field2d`` and
    ``replicate``)."""
    if not torch.is_tensor(field) or field.ndim < 2:
        return field
    return _cut(field, mesh, field.shape[-1])


def shard_grid(g, mesh: Mesh):
    """This rank's block of a global ``GridArrays``: the cell tables cut
    to the block, the face tables with the block's closing face, and the
    global mean cell area carried along (the damping reads it)."""
    n = g.area.shape[-1]
    cut = {f.name: _cut(getattr(g, f.name), mesh, n)
           for f in dataclasses.fields(g) if f.name != "area_mean"}
    return dataclasses.replace(g, area_mean=g.area.mean(), **cut)


def gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global [..., ny, nx] array from every rank's block (on every
    rank)."""
    blocks = all_gather(x, mesh)
    py, px = mesh.layout
    rows = [torch.cat(blocks[r * px:(r + 1) * px], dim=-1)
            for r in range(py)]
    return torch.cat(rows, dim=-2)


def gather_state(state, mesh: Mesh):
    """The global DycoreState from every rank's block."""
    def g(x):
        return None if x is None else gather(x, mesh)

    return dataclasses.replace(
        state, delp=g(state.delp), pt=g(state.pt), wind=g(state.wind),
        phis=g(state.phis), w=g(state.w), delz=g(state.delz),
        tracers={k: g(v) for k, v in state.tracers.items()})


# --------------------------------------------------------- collectives
def staged(x: torch.Tensor, mesh: Mesh) -> bool:
    """gloo carries host tensors: CUDA tensors go through host memory
    (chosen by the backend's name)."""
    return x.is_cuda and mesh.backend == "gloo"


def all_gather(x: torch.Tensor, mesh: Mesh) -> list:
    """Every rank's ``x`` (of one shape), in rank order."""
    if staged(x, mesh):
        host = [torch.empty_like(x, device="cpu") for _ in range(mesh.size)]
        dist.all_gather(host, x.contiguous().cpu(), group=mesh.group)
        return [b.to(x.device) for b in host]
    blocks = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(blocks, x.contiguous(), group=mesh.group)
    return blocks


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the active mesh's ranks (a new tensor; ``x``
    itself without a mesh)."""
    mesh = active()
    if mesh is None:
        return x
    if staged(x, mesh):
        host = x.detach().to("cpu").clone()
        dist.all_reduce(host, op=op, group=mesh.group)
        return host.to(x.device)
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def global_max(x: torch.Tensor) -> torch.Tensor:
    return all_reduce(x, dist.ReduceOp.MAX)


def global_min(x: torch.Tensor) -> torch.Tensor:
    return all_reduce(x, dist.ReduceOp.MIN)


def global_mean(x: torch.Tensor, dim) -> torch.Tensor:
    """``x.mean(dim)`` over the whole grid: on a sharded block the sums
    are all-reduced over the ranks, whose blocks are of one size."""
    mesh = active()
    if mesh is None:
        return x.mean(dim=dim)
    count = int(np.prod([x.shape[d] for d in dim])) * mesh.size
    return all_reduce(x.sum(dim=dim)) / count


#: the most uniforms one ``torch.rand`` call of a McICA draw makes (512
#: MiB in float32); a larger draw is made in slabs of whole columns
DRAW_SLAB = 2 ** 27


def draw_columns(gen: torch.Generator, shapes, axis: int,
                 keep: Optional[torch.Tensor] = None, **kw) -> tuple:
    """Uniforms of each of ``shapes`` in turn from ``gen``, a column per
    index of ``axis``: one ``torch.rand`` of the whole shape where it
    holds at most DRAW_SLAB values, else one per slab of whole columns,
    slabs fixed by the shape alone.  ``keep`` (global column indices,
    ascending, on the host) keeps those columns only, so that a rank of a
    sharded layout holds a slab and its block, not the grid, and gets
    the values the whole draw gives its columns.  ``kw``: dtype and
    device."""
    out = []
    for shape in shapes:
        ncol = shape[axis]
        per_col = int(np.prod(shape)) // max(ncol, 1)
        step = max(1, DRAW_SLAB // max(per_col, 1))
        parts = []
        for start in range(0, max(ncol, 1), step):
            stop = min(ncol, start + step)
            slab = list(shape)
            slab[axis] = stop - start
            x = torch.rand(slab, generator=gen, **kw)
            if keep is not None:
                sel = keep[(keep >= start) & (keep < stop)] - start
                x = x.index_select(axis, sel.to(x.device))
            parts.append(x)
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts, axis))
    return tuple(out)


def column_draws(draw: Callable, fold: int, lead: tuple, nz: int):
    """``draw(fold, ncol, nz)`` (a driver's McICA uniforms) for the
    columns of ``lead``.  While a mesh is active, ``lead`` is the block
    [6, my, mx]: the draw is the global grid's, in its column order, of
    which ``draw(..., keep=)`` keeps this block's columns (see
    :func:`draw_columns`), so that a column's draw does not depend on
    the layout."""
    mesh = active()
    ncol = int(np.prod(lead)) if lead else 1
    if mesh is None:
        return draw(fold, ncol, nz)
    if len(lead) != 3 or lead[0] != 6:
        raise ValueError(f"a sharded radiation call takes [6, my, mx] "
                         f"columns; got {lead}")
    py, px = mesh.layout
    n = lead[1] * py
    ys, xs = mesh.block(n)
    keep = torch.arange(6 * n * n).reshape(6, n, n)[:, ys, xs].reshape(-1)
    return draw(fold, 6 * n * n, nz, keep=keep)


# -------------------------------------------------------------- launch
def _check_group(world_size: int, token: str):
    """Raises unless this rank's process group is the one its launch made:
    ``world_size`` ranks, every one of them holding ``token``."""
    if dist.get_world_size() != world_size:
        raise RuntimeError(
            f"rank {dist.get_rank()} is in a group of "
            f"{dist.get_world_size()} ranks, not its launch's {world_size}")
    tokens = [None] * world_size
    dist.all_gather_object(tokens, token)
    if any(t != token for t in tokens):
        raise RuntimeError(
            f"rank {dist.get_rank()} is not in its own group: its launch's "
            f"token {token!r}, the group's {tokens}")


def _rank_main(rank: int, world_size: int, store: str, token: str,
               backend: str, fn: Callable, args: tuple, out_dir: str):
    import pickle

    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world_size, rank=rank)
    try:
        _check_group(world_size, token)
        result = fn(*args)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        _halo.set_active_mesh(None)
        if dist.is_initialized():  # a failed segment tore it down
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: tuple = (),
           backend: str = "gloo") -> list:
    """Run ``fn(*args)`` in ``world_size`` new processes that form one
    process group (``backend``); returns each rank's result, in rank order.
    ``fn`` must be importable by name (a module level function).  Raises
    if any rank fails.

    The group meets through a file store in the launch's own temporary
    directory, so that no other launch can join it (a TCP port picked in
    the parent and released could be taken, or picked by another launch,
    before rank 0 bound it), and every rank checks that its group holds
    ``world_size`` ranks with the token this launch made."""
    import os
    import pickle
    import secrets
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="fv3net_ranks_") as out:
        mp.start_processes(
            _rank_main,
            args=(world_size, os.path.join(out, "store"),
                  secrets.token_hex(16), backend, fn, args, out),
            nprocs=world_size, join=True, start_method="spawn")
        results = []
        for r in range(world_size):
            with open(f"{out}/rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results
