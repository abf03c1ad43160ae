"""Block coarsening on tensors (port of ``fv3net_tpu/ops/coarsen.py`` and
of the dispatcher in ``fv3net_tpu/ops/pallas_kernels.py``).

A reshape exposes the (factor x factor) blocks of the last two axes
(..., y, x) as two extra axes and every reduction runs over them, so the
functions batch over (tile, z, time, ...) leading axes.

:func:`weighted_block_average` is the C384 -> C48 diagnostics workload:
on CUDA tensors it runs the fused kernel K5
(:mod:`fv3net_torch.ops.coarsen_cuda`), on CPU tensors its plain version
:func:`weighted_block_average_plain`; ``impl`` "cuda" or "torch" forces
one.  On a CUDA tensor the kernel launches or raises; there is no
fallback.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from fv3net_torch.ops import coarsen_cuda


def _blockify(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., y, x) -> (..., y/f, f, x/f, f)."""
    *lead, ny, nx = x.shape
    if ny % factor or nx % factor:
        raise ValueError(
            f"spatial shape ({ny},{nx}) not divisible by factor {factor}"
        )
    return x.reshape(*lead, ny // factor, factor, nx // factor, factor)


def _block_values(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., y, x) -> (..., y/f, x/f, f*f): each block's values last."""
    b = _blockify(x, factor)
    *lead, nyc, f1, nxc, f2 = b.shape
    return b.movedim(-3, -2).reshape(*lead, nyc, nxc, f1 * f2)


def block_reduce(x, factor: int, reduction: Callable = torch.sum):
    """Blockwise reduction over (factor x factor) tiles of the last two
    axes; ``reduction(blocks, dim=(-3, -1))``."""
    return reduction(_blockify(x, factor), dim=(-3, -1))


def block_sum(x, factor: int):
    return block_reduce(x, factor, torch.sum)


def block_mean(x, factor: int):
    return block_reduce(x, factor, torch.mean)


def block_median(x, factor: int):
    """Blockwise median: the mean of the two middle values of an even
    count; NaN where the block holds one."""
    v = _block_values(x, factor)
    s = v.sort(dim=-1).values
    n = v.shape[-1]
    med = (s[..., (n - 1) // 2] + s[..., n // 2]) / 2
    if v.is_floating_point():
        med = torch.where(torch.isnan(v).any(dim=-1), torch.nan, med)
    return med


def block_min(x, factor: int):
    return block_reduce(x, factor, torch.amin)


def block_max(x, factor: int):
    return block_reduce(x, factor, torch.amax)


def block_mode(x, factor: int, where=None):
    """Blockwise mode (the "dominant" reduction of categorical surface
    fields): each block is sorted and its longest run found; ties break
    toward the smallest value.

    ``where``: optional boolean mask (broadcastable to x); excluded cells
    are left out of the count."""
    v = _block_values(x, factor)
    if where is not None:
        m = _block_values(torch.as_tensor(where, device=x.device)
                          .expand(x.shape), factor)
        # masked entries go past every real value, so the sorted runs of
        # valid values stay together at the front
        order = torch.where(m, v, torch.inf).argsort(dim=-1, stable=True)
        s = v.gather(-1, order)
        sm = m.gather(-1, order)
        eq = (s[..., :, None] == s[..., None, :]) & sm[..., None, :]
        counts = torch.where(sm, eq.sum(dim=-1), -1)
    else:
        s = v.sort(dim=-1, stable=True).values
        counts = (s[..., :, None] == s[..., None, :]).sum(dim=-1)
    # the first index of the largest count: the smallest value on ties
    best = counts.argmax(dim=-1, keepdim=True)
    return s.gather(-1, best)[..., 0]


def weighted_block_average_plain(x, weights, factor: int):
    """Area/mass-weighted block average, ``sum(x * w) / sum(w)`` per
    block; ``weights`` broadcasts against ``x`` over leading axes.  The
    plain version of K5."""
    num = block_sum(x * weights, factor)
    den = block_sum(weights.expand(x.shape), factor)
    return num / den


def weighted_block_average(x, weights, factor: int,
                           impl: Optional[str] = None):
    """Area/mass-weighted block average: K5 on CUDA tensors, else the
    plain version (see :func:`weighted_block_average_plain`)."""
    if impl not in (None, "cuda", "torch"):
        raise ValueError(f"coarsening impl must be None, 'cuda' or 'torch'; "
                         f"got {impl!r}")
    if impl == "torch" or (impl is None and not x.is_cuda):
        return weighted_block_average_plain(x, weights, factor)
    dtype = torch.result_type(x, weights)
    return coarsen_cuda.weighted_block_average_cuda(
        x.to(dtype).contiguous(), weights.to(dtype).contiguous(), factor
    )


def _axis_block_sum(x, factor: int, axis: int):
    ax = axis % x.ndim
    n = x.shape[ax]
    if n % factor:
        raise ValueError(f"axis size {n} not divisible by factor {factor}")
    shape = x.shape[:ax] + (n // factor, factor) + x.shape[ax + 1:]
    return x.reshape(shape).sum(dim=ax + 1)


def _edge_axes(edge: str):
    if edge not in ("x", "y"):
        raise ValueError(f"edge must be 'x' or 'y', got {edge!r}")
    return (-1, -2) if edge == "x" else (-2, -1)


def _subsample(x, factor: int, axis: int):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(None, None, factor)
    return x[tuple(idx)]


def edge_weighted_block_average(x, spacing, factor: int, edge: str = "x"):
    """Coarsen an edge-staggered field: weighted average along the edge
    direction, subsample along the other.

    edge='x': coarsen along the last (x) axis, subsample y;
    edge='y': coarsen along the second-to-last (y) axis, subsample x."""
    axis, sub_axis = _edge_axes(edge)
    num = _axis_block_sum(x * spacing, factor, axis)
    den = _axis_block_sum(spacing.expand(x.shape), factor, axis)
    return _subsample(num / den, factor, sub_axis)


def block_edge_sum(x, factor: int, edge: str = "x"):
    """Sum along the edge direction, subsample the other (edge lengths)."""
    axis, sub_axis = _edge_axes(edge)
    return _subsample(_axis_block_sum(x, factor, axis), factor, sub_axis)


def block_upsample(x, factor: int):
    """Repeat each coarse cell into a (factor x factor) fine block."""
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor,
                                                                 dim=-1)


_REDUCTIONS = {
    "sum": block_sum,
    "mean": block_mean,
    "median": block_median,
    "min": block_min,
    "max": block_max,
    "mode": block_mode,
}


def block_coarsen(x, factor: int, method: str = "sum"):
    """Named-method dispatch."""
    try:
        fn = _REDUCTIONS[method]
    except KeyError:
        raise ValueError(
            f"unknown coarsening method {method!r}; one of "
            f"{sorted(_REDUCTIONS)}"
        )
    return fn(x, factor)


def shift_edge_var_to_center(x_edge, axis: int = -1):
    """Average an edge-staggered variable (n+1 points along ``axis``) onto
    cell centers."""
    n = x_edge.shape[axis]
    return 0.5 * (x_edge.narrow(axis, 0, n - 1) + x_edge.narrow(axis, 1, n - 1))


def coarsen_coords(factor: int, n_fine: int):
    """Coarse-grid 1-based coordinate labels after block coarsening: fine
    index i maps to coarse cell (i-1)//factor + 1."""
    if n_fine % factor:
        raise ValueError(f"{n_fine} not divisible by factor {factor}")
    return np.arange(1, n_fine // factor + 1)


#: reference-name aliases: both reduce blocks of the trailing two (y, x)
#: axes with an arbitrary reduction, which block_reduce already is
horizontal_block_reduce = block_reduce
xarray_block_reduce = block_reduce
