"""Vertical regridding to coarsened pressure levels (port of
``fv3net_tpu/ops/regridz.py``; reference:
external/vcm/vcm/cubedsphere/regridz.py and
``vcm.interpolate_to_pressure_levels``, external/vcm/vcm/interpolate.py).

3-D fields are (..., y, x, z) with z innermost, so the PPM remap
(:func:`fv3net_torch.ops.remap.remap_ppm`) runs over all columns at once;
the horizontal block averages move z out of the way.  The area-weighted
coarse pressure thickness is a :func:`fv3net_torch.ops.coarsen.
weighted_block_average`: the kernel K5 on CUDA tensors.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from fv3net_torch.core.constants import TOA_PRESSURE
from fv3net_torch.ops import coarsen as _coarsen
from fv3net_torch.ops import remap as _remap
from fv3net_torch.ops import thermo as _thermo

# NCEP-style standard output pressure levels [Pa]
# (reference: external/vcm/vcm/interpolate.py:28-72 PRESSURE_GRID)
PRESSURE_GRID = np.array(
    [
        2500.0, 5000.0, 7500.0, 10000.0, 12500.0, 15000.0, 17500.0, 20000.0,
        22500.0, 25000.0, 27500.0, 30000.0, 32500.0, 35000.0, 37500.0, 40000.0,
        42500.0, 45000.0, 47500.0, 50000.0, 52500.0, 55000.0, 57500.0, 60000.0,
        62500.0, 65000.0, 67500.0, 70000.0, 72500.0, 75000.0, 77500.0, 80000.0,
        82500.0, 85000.0, 87500.0, 90000.0, 92500.0, 95000.0, 97500.0, 100000.0,
    ]
)


def _hcoarsen_weighted(x_yxz, weights_yx, factor: int):
    """Weighted block average over the (y, x) axes of a (..., y, x, z)
    tensor; the weights' plane is shared by the levels."""
    x = x_yxz.movedim(-1, -3)  # (..., z, y, x)
    w = weights_yx.unsqueeze(-3)  # align (..., y, x) under the z axis
    out = _coarsen.weighted_block_average(x, w, factor)
    return out.movedim(-3, -1)


def _hupsample(x_yxz, factor: int):
    out = _coarsen.block_upsample(x_yxz.movedim(-1, -3), factor)
    return out.movedim(-3, -1)


def regrid_to_area_weighted_pressure(
    fields: Dict[str, torch.Tensor],
    delp: torch.Tensor,
    area: torch.Tensor,
    coarsening_factor: int,
    toa_pressure: float = TOA_PRESSURE,
    extrapolate: bool = False,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Vertically regrid cell-centered fields to coarsened pressure levels
    and mask the area weights below the fine surface pressure.

    Args:
        fields: name -> (..., y, x, z) tensors on the fine grid
        delp: fine pressure thicknesses (..., y, x, z)
        area: cell areas (..., y, x)
        coarsening_factor: horizontal factor for the coarse pressure field
        extrapolate: if True, mask against coarse layer *midpoints* instead
            of bottom interfaces (allows limited nearest-neighbor extrap)

    Returns:
        (regridded fields on the fine horizontal grid but coarse pressure
        coordinate, masked weights (..., y, x, z))
    """
    delp_coarse = _hcoarsen_weighted(delp, area, coarsening_factor)
    delp_coarse_on_fine = _hupsample(delp_coarse, coarsening_factor)
    return _regrid_given_delp(
        fields, delp, delp_coarse_on_fine, area, toa_pressure, extrapolate
    )


def regrid_to_edge_weighted_pressure(
    fields: Dict[str, torch.Tensor],
    delp_staggered: torch.Tensor,
    length: torch.Tensor,
    coarsening_factor: int,
    toa_pressure: float = TOA_PRESSURE,
    edge: str = "x",
    extrapolate: bool = False,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Edge-staggered analog of :func:`regrid_to_area_weighted_pressure`:
    edge-weighted coarse delp along the edge direction, subsampled in the
    other.  ``delp_staggered`` must already be at the edge positions
    (see :func:`stagger_center_to_edge`)."""
    delp_stag = delp_staggered.movedim(-1, -3)
    coarse = _coarsen.edge_weighted_block_average(
        delp_stag, length.unsqueeze(-3), coarsening_factor, edge=edge
    )
    # back to the fine staggered grid: block_upsample repeats both axes,
    # then trimmed to the staggered fine shape
    coarse_up = _coarsen.block_upsample(coarse, coarsening_factor)
    coarse_up = coarse_up[..., : delp_stag.shape[-2], : delp_stag.shape[-1]]
    delp_coarse_on_fine = coarse_up.movedim(-3, -1)
    return _regrid_given_delp(
        fields,
        delp_staggered,
        delp_coarse_on_fine,
        length,
        toa_pressure,
        extrapolate,
    )


def stagger_center_to_edge(delp: torch.Tensor, axis: int) -> torch.Tensor:
    """Interpolate a cell-centered (..., y, x, z) field to edge positions
    along ``axis`` (-2 for x edges, -3 for y edges): midpoint average in the
    interior, nearest center at the domain boundary."""
    ax = axis % delp.ndim
    n = delp.shape[ax]
    mid = 0.5 * (delp.narrow(ax, 0, n - 1) + delp.narrow(ax, 1, n - 1))
    return torch.cat([delp.narrow(ax, 0, 1), mid, delp.narrow(ax, n - 1, 1)],
                     dim=ax)


def _regrid_given_delp(
    fields, delp_fine, delp_coarse_on_fine, weights, toa_pressure, extrapolate
):
    phalf_coarse = _thermo.pressure_at_interface(
        delp_coarse_on_fine, toa_pressure=toa_pressure
    )
    phalf_fine = _thermo.pressure_at_interface(delp_fine,
                                               toa_pressure=toa_pressure)
    regridded = {
        name: _remap.remap_ppm(phalf_fine, f, phalf_coarse, iv=1, kord=1)
        for name, f in fields.items()
    }
    if extrapolate:
        pfull_coarse = _thermo.pressure_at_midpoint_log(
            delp_coarse_on_fine, toa_pressure=toa_pressure
        )
        mask = pfull_coarse < phalf_fine[..., -1:]
    else:
        # <= with a rounding tolerance, as the reference package has it
        # (vcm's own comparison is a strict <): at equality the coarse
        # layer lies within the fine column, and cumsum rounding must not
        # flip the comparison
        ps_fine = phalf_fine[..., -1:]
        tol = 8 * torch.finfo(ps_fine.dtype).eps * ps_fine
        mask = phalf_coarse[..., 1:] <= ps_fine + tol
    masked_weights = torch.where(mask, weights[..., None], 0.0)
    return regridded, masked_weights


def interpolate_to_pressure_levels(
    field: torch.Tensor,
    delp: torch.Tensor,
    levels: torch.Tensor = None,
    ptop: float = TOA_PRESSURE,
) -> torch.Tensor:
    """Linear interpolation of a (..., z) field onto fixed pressure levels;
    NaN outside the column's pressure range."""
    if levels is None:
        levels = torch.as_tensor(PRESSURE_GRID, dtype=field.dtype,
                                 device=field.device)
    pmid = _thermo.pressure_at_midpoint_log(delp, toa_pressure=ptop)
    target = levels.expand(field.shape[:-1] + (levels.shape[-1],))
    return _remap.interpolate_1d(target, pmid, field)
