"""Nonhydrostatic extension on tensors (port of
``fv3net_tpu/dycore/nonhydro.py``): prognostic vertical velocity ``w`` and
geometric layer thickness ``delz`` with a semi-implicit vertical acoustic
solver.

Formulation (z index 0 = model top; ``delz`` > 0 here, unlike FV3's
negative-``delz`` convention; ``pi`` = hydrostatic pressure):

- equation of state on a Lagrangian layer whose theta_v is materially
  conserved during the acoustic step::

      p = p00 * (rho * Rd * theta_v / p00) ** gamma,   gamma = cp / cv
      rho = delp / (g * delz)

- vertical momentum at layer interfaces: dw/dt = g * dp'/dpi, with
  p' = p - pi_mid;
- layer thickness: d(delz_k)/dt = w_if[k] - w_if[k+1].

Backward Euler in (w_if, delz) with p' linearized around the current
state gives a diagonally dominant tridiagonal system per column for the
interface velocities; ``delz`` and the layer-centred ``w`` are updated
from the implicit increments.  Boundary conditions: p' = 0 above the
model top and w_if = w_surf at the ground.

The reference solves the columns with XLA's native tridiagonal solve.
Here each column's system is one [nz, nz] matrix and all columns go to
one batched LU solve (``torch.linalg.solve_ex``: a few launches a
substep where a Thomas sweep in Python would take 2 nz).  The system is
diagonally dominant, so partial pivoting swaps no rows and the
elimination is the Thomas algorithm's.
"""
from __future__ import annotations

import torch

from fv3net_torch.core.constants import (
    CP_AIR,
    CV_AIR,
    GRAVITY,
    KAPPA,
    RDGAS,
    REFERENCE_SURFACE_PRESSURE,
)
from fv3net_torch.ops import zscan

GAMMA = CP_AIR / CV_AIR  # cp/cv = 1/(1-kappa)


def hydrostatic_delz(delp, pt, ptop: float):
    """Geometric thickness in hydrostatic balance: dz = R Tv dlnp / g.

    Args are z-mid layout [6, nz, ny, nx]; ``pt`` is theta_v.
    """
    pe = torch.cat(
        [torch.full_like(delp[:, :1], ptop),
         ptop + zscan.cumsum(delp, axis=1)],
        dim=1,
    )
    dlnp = torch.log(pe[:, 1:]) - torch.log(pe[:, :-1])
    pmid = delp / dlnp
    tv = pt * (pmid / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    return RDGAS * tv * dlnp / GRAVITY


def full_pressure(delp, pt, delz):
    """Layer full pressure from the equation of state (any layout; the
    three fields shape-aligned).  ``pt`` is theta_v."""
    rho = delp / (GRAVITY * delz)
    return REFERENCE_SURFACE_PRESSURE * (
        rho * RDGAS * pt / REFERENCE_SURFACE_PRESSURE
    ) ** GAMMA


def _tridiag_solve(a, b, c, r):
    """Solve ``a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = r[i]`` along the
    FIRST axis, batched over the rest (a[0] and c[-1] ignored), as one
    batched dense solve of the columns' [n, n] systems."""
    last = lambda x: x.movedim(0, -1)  # noqa: E731
    a, b, c, r = last(a), last(b), last(c), last(r)
    m = (torch.diag_embed(b) + torch.diag_embed(a[..., 1:], offset=-1)
         + torch.diag_embed(c[..., :-1], offset=1))
    x, _ = torch.linalg.solve_ex(m, r[..., None])
    return x[..., 0].movedim(-1, 0)


def vertical_solver(w, delz, delp, pt, dt: float, ptop: float, w_surf=None):
    """One backward-Euler vertical acoustic step.

    Args (z-mid layout [6, nz, ny, nx]): ``w`` layer-centred vertical
    velocity (m/s, positive up), ``delz`` geometric thickness (m, > 0),
    ``delp`` pressure thickness (Pa), ``pt`` theta_v (K).  ``w_surf``:
    optional [6, ny, nx] surface interface velocity (material BC over
    terrain); zero by default.  Returns (w, delz) updated.
    """
    zf = lambda x: x.movedim(1, 0)  # noqa: E731  z first: [nz, 6, ny, nx]
    w_z, dz_z, dp_z, pt_z = zf(w), zf(delz), zf(delp), zf(pt)

    pe = torch.cat(
        [torch.full_like(dp_z[:1], ptop), ptop + torch.cumsum(dp_z, dim=0)],
        dim=0,
    )
    dlnp = torch.log(pe[1:]) - torch.log(pe[:-1])
    pi_mid = dp_z / dlnp
    p = full_pressure(dp_z, pt_z, dz_z)
    pp = p - pi_mid  # nonhydrostatic perturbation p'

    B = GAMMA * p * dt / dz_z
    # interface pressure increments; the top half-layer uses pi_mid[0] - ptop
    dpi_if = torch.cat([pi_mid[:1] - ptop, pi_mid[1:] - pi_mid[:-1]], dim=0)
    alpha = GRAVITY * dt / dpi_if

    # interface velocity estimate from the centred w (dz-weighted linear
    # interpolation; copy at the top, the boundary value at the bottom)
    w_bot = torch.zeros_like(w_z[0]) if w_surf is None else w_surf
    w_if_int = (dz_z[1:] * w_z[:-1] + dz_z[:-1] * w_z[1:]) / (
        dz_z[:-1] + dz_z[1:]
    )
    w_if = torch.cat([w_z[:1], w_if_int, w_bot[None]], dim=0)

    # tridiagonal system for interfaces 0..nz-1 (interface nz is the
    # Dirichlet surface condition)
    B_above = torch.cat([torch.zeros_like(B[:1]), B[:-1]], dim=0)
    a = -alpha * B_above
    b = 1.0 + alpha * (B + B_above)
    c = -alpha * B
    pp_above = torch.cat([torch.zeros_like(pp[:1]), pp[:-1]], dim=0)
    r = w_if[:-1] + alpha * (pp - pp_above)
    r = torch.cat([r[:-1], (r[-1] + alpha[-1] * B[-1] * w_bot)[None]], dim=0)

    x = _tridiag_solve(a, b, c, r)
    w_if_new = torch.cat([x, w_bot[None]], dim=0)

    dz_new = dz_z + dt * (w_if_new[:-1] - w_if_new[1:])
    dwd = w_if_new - w_if  # implicit interface increments
    w_new = w_z + 0.5 * (dwd[:-1] + dwd[1:])

    zl = lambda x: x.movedim(0, 1)  # noqa: E731
    return zl(w_new), zl(dz_new)
