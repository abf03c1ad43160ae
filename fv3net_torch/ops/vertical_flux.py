"""Vertical flux <-> tendency reconstruction (port of
``fv3net_tpu/ops/vertical_flux.py``; reference semantics:
external/vcm/vcm/calc/vertical_flux.py).

The reference solves a least-squares problem per column; the difference
operator is fixed for a given ``nz``, so its pseudoinverse is computed
once on the host (numpy, cached per (nz, dtype)) and the reconstruction
of every column is one matrix product.  Columns take z last
(``[..., nz]``).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "convergence_cell_center",
    "convergence_cell_interface",
    "fit_field_as_flux",
]


def _center_to_interface(f):
    """Linear interp of cell-center values to the nz+1 interfaces, with
    linear extrapolation at both boundaries (constant index spacing)."""
    f_low = 2.0 * f[..., :1] - f[..., 1:2]
    f_high = 2.0 * f[..., -1:] - f[..., -2:-1]
    pad = torch.cat([f_low, f, f_high], dim=-1)
    return 0.5 * (pad[..., :-1] + pad[..., 1:])


def convergence_cell_center(eddy, delp):
    """Vertical convergence ``-d(eddy)/dp`` of a cell-centred flux: the
    flux is interpolated to interfaces (extrapolated at the boundaries),
    then differenced."""
    interface = _center_to_interface(eddy)
    return -torch.diff(interface, dim=-1) / delp


def convergence_cell_interface(flux, delp):
    """Vertical convergence ``-dF/dp`` of an interface flux: ``flux`` has
    nz+1 interface levels on its last axis, ``delp`` nz thicknesses."""
    return (flux[..., :-1] - flux[..., 1:]) / delp


@lru_cache(maxsize=8)
def _interior_flux_pinv(nz: int, dtype_name: str) -> np.ndarray:
    """Pseudoinverse of the (nz, nz-1) interface-difference operator M with
    M[0,0]=-1, M[-1,-1]=1, M[i,i]=-1, M[i,i-1]=1, transposed to
    (nz, nz-1).  Host-side, cached per (nz, dtype)."""
    M = np.zeros((nz, nz - 1))
    M[0, 0] = -1.0
    M[-1, -1] = 1.0
    for i in range(1, nz - 1):
        M[i, i] = -1.0
        M[i, i - 1] = 1.0
    return np.linalg.pinv(M).T.astype(dtype_name)


def fit_field_as_flux(field, delp, first_level_flux, last_level_flux):
    """Least-squares interface flux F with ``-dF/dp ~= field`` and the
    first/last interface fluxes fixed.

    Args:
        field: ``[..., nz]`` mass-normalized field (e.g. kg/kg/s).
        delp: ``[..., nz]`` layer thickness in Pa.
        first_level_flux, last_level_flux: ``[...]`` boundary fluxes at the
            top (z=0) and bottom (z=-1) interfaces, positive in the
            +index direction.

    Returns:
        ``[..., nz+1]`` interface flux whose first and last values are the
        boundary fluxes.
    """
    like = dict(dtype=field.dtype, device=field.device)
    first = torch.as_tensor(first_level_flux, **like)
    last = torch.as_tensor(last_level_flux, **like)
    nz = field.shape[-1]
    rhs = field * delp
    rhs = torch.cat([rhs[..., :1] - first[..., None], rhs[..., 1:-1],
                     rhs[..., -1:] + last[..., None]], dim=-1)
    pinv_t = torch.from_numpy(_interior_flux_pinv(
        nz, str(rhs.dtype).removeprefix("torch."))).to(rhs.device)
    middle = rhs @ pinv_t
    first, last = (torch.broadcast_to(f, middle.shape[:-1])
                   for f in (first, last))
    return torch.cat([first[..., None], middle, last[..., None]], dim=-1)
