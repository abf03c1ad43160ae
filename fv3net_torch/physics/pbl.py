"""Boundary-layer vertical diffusion (port of
``fv3net_tpu/physics/pbl.py``): the Hong-Pan nonlocal K profile and the
backward-Euler column solve, whose tridiagonal Thomas sweeps are Python
loops over z.
"""
from __future__ import annotations

import dataclasses

import torch

from fv3net_torch.ops import zscan


@dataclasses.dataclass(frozen=True)
class PBLParams:
    k_max: float = 15.0  # m^2/s eddy diffusivity in the boundary layer
    sigma_pbl: float = 0.8  # diffusion active below this sigma level


def diffusivity_profile(sigma_interface, params: PBLParams = PBLParams()):
    """K at interior interfaces (..., nz-1): smooth ramp from 0 above the
    PBL top to k_max at the surface."""
    s = sigma_interface
    x = torch.clamp((s - params.sigma_pbl) / (1.0 - params.sigma_pbl),
                    0.0, 1.0)
    return params.k_max * x * x * (3.0 - 2.0 * x)


def implicit_diffusion(X, K_if, dz_if, dm, dt: float):
    """Backward-Euler vertical diffusion of X (..., nz).

    Args:
        X: (..., nz) field
        K_if: (..., nz-1) diffusivity at interior interfaces [m^2/s]
        dz_if: (..., nz-1) distance between adjacent midpoints [m]
        dm: (..., nz) layer masses [kg/m^2]
        dt: timestep
    """
    rho_if = 0.5 * (dm[..., :-1] + dm[..., 1:]) / torch.clamp(dz_if, min=1e-3)
    g_if = K_if * rho_if / torch.clamp(dz_if, min=1e-3)

    # tridiagonal system: -a_k X_{k-1} + b_k X_k - c_k X_{k+1} = X_old
    zero = torch.zeros_like(X[..., :1])
    a = torch.cat([zero, dt * g_if / dm[..., 1:]], dim=-1)
    c = torch.cat([dt * g_if / dm[..., :-1], zero], dim=-1)
    b = 1.0 + a + c

    # Thomas algorithm: forward elimination, back substitution
    nz = X.shape[-1]
    cp = torch.zeros(X.shape[:-1], dtype=X.dtype, device=X.device)
    dp = torch.zeros_like(cp)
    cps, dps = [], []
    for k in range(nz):
        a_k = a[..., k]
        denom = b[..., k] - a_k * cp
        cp = c[..., k] / denom
        dp = (X[..., k] + a_k * dp) / denom
        cps.append(cp)
        dps.append(dp)
    out = [None] * nz
    x_next = torch.zeros_like(cp)
    for k in range(nz - 1, -1, -1):
        x_next = dps[k] + cps[k] * x_next
        out[k] = x_next
    return torch.stack(out, dim=-1)


@dataclasses.dataclass(frozen=True)
class KProfileParams:
    """Hong-Pan (1996) nonlocal K-profile closure, the GFS PBL family."""

    ric: float = 0.25  # critical bulk Richardson number for PBL top
    b_cg: float = 7.8  # countergradient coefficient
    theta_excess_max: float = 3.0  # K cap on the thermal excess
    prandtl_unstable: float = 0.8
    l_asymptotic: float = 150.0  # m, free-troposphere mixing length
    k_max: float = 300.0  # m^2/s diffusivity cap
    k_background: float = 0.1  # m^2/s floor
    h_max_fraction: float = 0.4  # PBL top no higher than this sigma depth


def _pick(x, idx):
    """x[..., nz] at per-column index idx[...]."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def kprofile_diffusivity(
    thv, speed, dz, ustar, lmo_inv, wthv,
    params: KProfileParams = KProfileParams(),
):
    """Nonlocal K profile, PBL height and countergradient term.

    Args (z-LAST, level 0 = model top): thv (..., nz) virtual potential
    temperature [K]; speed (..., nz) [m/s]; dz (..., nz) positive layer
    thicknesses [m]; ustar, lmo_inv, wthv (...) surface-layer outputs.

    Returns (K_m_if, K_h_if, gamma_h, hpbl): diffusivities and the
    countergradient term at interior interfaces (..., nz-1), PBL depth.
    """
    k = 0.4
    # surface-first views
    thv_s = torch.flip(thv, (-1,))
    spd_s = torch.flip(speed, (-1,))
    dz_s = torch.flip(dz, (-1,))
    zsum = zscan.cumsum(dz_s, axis=-1)
    zmid = zsum - 0.5 * dz_s
    zif = zsum[..., :-1]

    unstable = wthv > 0.0
    ws0 = torch.clamp(ustar, min=0.05)
    theta_ex = torch.where(
        unstable,
        torch.clamp(params.b_cg * wthv / ws0, max=params.theta_excess_max),
        0.0,
    )
    thv_parcel = thv_s[..., 0] + theta_ex

    u2 = torch.clamp(spd_s * spd_s, min=1.0)
    rib = (
        9.80665 * zmid * (thv_s - thv_parcel[..., None])
        / (thv_parcel[..., None] * u2)
    )
    exceed = rib >= params.ric
    zcap = params.h_max_fraction * torch.sum(dz_s, dim=-1)
    exceed = exceed | (zmid >= zcap[..., None])
    # first True (surface-first); the cap guarantees one exists
    kstar = torch.argmax(exceed.to(torch.uint8), dim=-1)
    kstar = torch.clamp(kstar, min=1)
    z_hi = _pick(zmid, kstar)
    z_lo = _pick(zmid, kstar - 1)
    r_hi = _pick(rib, kstar)
    r_lo = _pick(rib, kstar - 1)
    frac = torch.clamp(
        (params.ric - r_lo) / torch.where(
            torch.abs(r_hi - r_lo) > 1e-6, r_hi - r_lo, 1e-6
        ),
        0.0, 1.0,
    )
    hpbl = torch.maximum(z_lo + frac * (z_hi - z_lo), dz_s[..., 0])

    zeta_h = torch.clamp(0.1 * hpbl * lmo_inv, -10.0, 2.0)
    phi_m = torch.where(
        zeta_h < 0.0,
        (1.0 - 16.0 * zeta_h) ** -0.25,
        1.0 + 5.0 * zeta_h,
    )
    ws = torch.clamp(ustar / phi_m, min=1e-3)

    # nonlocal profile K = k ws z (1 - z/h)^2 below h
    zr = torch.clamp(zif / hpbl[..., None], 0.0, 1.0)
    K_pbl = k * ws[..., None] * zif * (1.0 - zr) ** 2

    # free-troposphere local K: mixing length + Richardson damping
    dthv_if = thv_s[..., 1:] - thv_s[..., :-1]
    dz_if = 0.5 * (dz_s[..., 1:] + dz_s[..., :-1])
    shear = torch.abs(spd_s[..., 1:] - spd_s[..., :-1]) / dz_if
    thv_if = 0.5 * (thv_s[..., 1:] + thv_s[..., :-1])
    ri_loc = (
        9.80665 * dthv_if / dz_if
        / (thv_if * torch.clamp(shear, min=1e-6) ** 2)
    )
    l_mix = 1.0 / (1.0 / (k * torch.clamp(zif, min=1.0))
                   + 1.0 / params.l_asymptotic)
    f_stab = torch.where(
        ri_loc >= 0.0,
        torch.clamp(1.0 - 5.0 * torch.clamp(ri_loc, max=0.2), min=0.0) ** 2,
        torch.sqrt(1.0 - 16.0 * torch.clamp(ri_loc, min=-10.0)),
    )
    K_loc = l_mix * l_mix * shear * f_stab

    inside = zif < hpbl[..., None]
    K_m = torch.where(inside, torch.maximum(K_pbl, K_loc), K_loc)
    K_m = torch.clamp(K_m, params.k_background, params.k_max)
    K_h = torch.where(unstable[..., None], K_m / params.prandtl_unstable,
                      K_m)

    gamma = torch.where(
        unstable[..., None] & inside,
        params.b_cg * wthv[..., None]
        / (ws[..., None] * torch.clamp(hpbl[..., None], min=1.0)),
        0.0,
    )

    # back to top-first interface ordering
    def flip(x):
        return torch.flip(x, (-1,))

    return flip(K_m), flip(K_h), flip(gamma), hpbl
