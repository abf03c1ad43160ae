"""Bulk mass-flux convection, simplified Arakawa-Schubert family (port of
``fv3net_tpu/physics/convection_mf.py``).

Parcel origin by maximum moist static energy, an entraining updraft (a
Python loop over z), a CAPE-relaxation closure, compensating subsidence,
cloud-top detrainment, convective momentum transport, and closed column
energy, water and momentum budgets.  The flagship runs it as the shallow
stage (:data:`SHALLOW_PARAMS`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fv3net_torch.core.constants import (
    CP_AIR,
    GRAVITY,
    LATENT_HEAT_VAPORIZATION_0_C as LV,
)
from fv3net_torch.ops import thermo, zscan
from fv3net_torch.physics.microphysics import saturation_specific_humidity


@dataclasses.dataclass(frozen=True)
class MassFluxParams:
    entrainment: float = 1.0e-4  # 1/m fractional entrainment rate
    tau: float = 3600.0  # s, CAPE relaxation timescale
    cape_crit: float = 100.0  # J/kg threshold to trigger
    precip_efficiency: float = 0.9  # condensate fraction raining out
    max_mass_fraction: float = 0.25  # CFL cap: M dt <= this * min dm
    source_depth: int = 4  # levels above the surface scanned for the
    # maximum-MSE parcel origin
    # shallow-scheme cap: buoyancy zeroed where p/ps < sigma_top_min
    sigma_top_min: float = 0.0
    min_depth_layers: int = 2  # minimum cloud depth in layers
    # convective momentum transport with the pressure-gradient
    # correction pgcon (GFS SAS cnvgwd)
    momentum_transport: bool = True
    pgcon: float = 0.55


#: GFS shalcnv-style shallow cumulus: confined below ~0.65 p/ps, high
#: entrainment, weak mass flux, no precipitation.
SHALLOW_PARAMS = MassFluxParams(
    entrainment=3.0e-4,
    tau=1800.0,
    cape_crit=5.0,
    precip_efficiency=0.0,
    max_mass_fraction=0.1,
    source_depth=2,
    sigma_top_min=0.65,
    min_depth_layers=0,
)


def _pick(x, idx):
    """x[..., nz] at per-column index idx[...] (broadcast over leading
    dims of ``x``)."""
    idx = idx.expand(x.shape[:-1])
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _first_true(mask):
    """Index of the first True along the last axis (0 if none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _ascend(x_s, x_src, is_src, eps_dz):
    """Entraining-plume ascent of x from the source level upward
    (surface-first index): x_u = x_env at the source, else
    (x_u_prev + eps x_env) / (1 + eps)."""
    out = []
    xu = x_src
    for k in range(x_s.shape[-1]):
        eps_k = eps_dz[..., k]
        xu = torch.where(is_src[..., k], x_s[..., k],
                         (xu + eps_k * x_s[..., k]) / (1.0 + eps_k))
        out.append(xu)
    return torch.stack(out, dim=-1)


def mass_flux_convection(
    T, q, pmid, delp, dt: float,
    params: MassFluxParams = MassFluxParams(),
    wind=None,
) -> Tuple[torch.Tensor, ...]:
    """Apply bulk mass-flux convection.

    Args: T, q, pmid, delp (..., nz) z-last, level 0 = model top;
    ``wind``: optional (ncomp, ..., nz) momentum components, which add a
    fifth output ``dwind`` (the momentum increment over dt).

    Returns (T_new, q_new, qc_detrained, precip_rate[kg/m^2/s][, dwind]).
    """
    nz = T.shape[-1]
    dm = thermo.layer_mass(delp)
    qsat = saturation_specific_humidity(T, pmid)
    dz = torch.abs(thermo.hydrostatic_dz(T, q, delp))

    def rev(x):
        return torch.flip(x, (-1,))

    T_s, q_s, dz_s, dm_s, qs_s = map(rev, (T, q, dz, dm, qsat))
    z_s = zscan.cumsum(dz_s, axis=-1) - 0.5 * dz_s

    h = CP_AIR * T_s + GRAVITY * z_s + LV * q_s
    hsat = CP_AIR * T_s + GRAVITY * z_s + LV * qs_s

    kidx = torch.arange(nz, device=T.device)
    # parcel origin: max MSE within the lowest source_depth levels
    ksrc = torch.argmax(
        torch.where(kidx < params.source_depth, h, -torch.inf), dim=-1
    )
    h_src = _pick(h, ksrc)

    eps_dz = params.entrainment * dz_s
    is_src = kidx == ksrc[..., None]
    h_u = _ascend(h, h_src, is_src, eps_dz)

    above = kidx >= ksrc[..., None]
    buoy = (h_u - hsat) / (CP_AIR * T_s)
    buoyant = above & (buoy > 0.0)
    if params.sigma_top_min > 0.0:
        sigma_s = rev(pmid) / rev(pmid)[..., :1]
        buoyant = buoyant & (sigma_s >= params.sigma_top_min)
    cape = (GRAVITY * torch.where(buoyant, buoy, 0.0) * dz_s).sum(dim=-1)

    any_buoyant = buoyant.any(dim=-1)
    ktop = torch.where(
        any_buoyant, (nz - 1) - _first_true(torch.flip(buoyant, (-1,))), 0
    )
    kbase = _first_true(buoyant)
    active = (
        (cape > params.cape_crit)
        & any_buoyant
        & (ktop >= kbase + params.min_depth_layers)
    )

    # CAPE-relaxation closure for the cloud-base mass flux, CFL-capped
    rho_b = _pick(rev(pmid), kbase) / (287.05 * _pick(T_s, kbase))
    w_conv = torch.sqrt(torch.clamp(cape, min=0.0)) * (dt / params.tau)
    Mb = torch.where(active, rho_b * torch.clamp(w_conv, max=0.2), 0.0)
    dm_min = dm_s.min(dim=-1).values
    Mb = torch.minimum(Mb, params.max_mass_fraction * dm_min / dt)

    incloud = (kidx >= kbase[..., None]) & (kidx <= ktop[..., None])

    def sub(X):
        # compensating subsidence, upwind from above (index k+1)
        X_above = torch.cat([X[..., 1:], X[..., -1:]], dim=-1)
        return torch.where(incloud, Mb[..., None] * (X_above - X) / dm_s, 0.0)

    dT_s = sub(T_s) + torch.where(
        incloud, Mb[..., None] * GRAVITY * dz_s / CP_AIR / dm_s, 0.0
    )
    dq_s = sub(q_s)

    # cloud-top detrainment of the plume's saturated vapor
    at_top = kidx == ktop[..., None]
    q_u_top = _pick(qs_s, ktop)
    dm_top = _pick(dm_s, ktop)
    dq_s = dq_s + torch.where(
        at_top,
        (Mb * (q_u_top - _pick(q_s, ktop)))[..., None] / dm_top[..., None],
        0.0,
    )

    dT = rev(dT_s) * dt
    dq = rev(dq_s) * dt
    q_new = torch.clamp(q + dq, min=1e-10)
    dq = q_new - q

    # exact water closure
    dq_col = -(dq * dm).sum(dim=-1)
    residual = torch.clamp(dq_col, min=0.0)
    precip = params.precip_efficiency * residual / dt
    at_top_rev = rev(at_top.to(T.dtype))
    qc_det = (
        at_top_rev
        * ((1.0 - params.precip_efficiency) * residual)[..., None]
        / dm_top[..., None]
    )
    # energy closure over the convective layers
    w = torch.where(rev(incloud), dm, 0.0)
    wsum = torch.clamp(w.sum(dim=-1), min=1.0)
    excess = LV * residual - CP_AIR * (dT * dm).sum(dim=-1)
    dT = dT + torch.where(
        rev(incloud), excess[..., None] / (CP_AIR * wsum[..., None]), 0.0
    )
    T_new = T + dT
    if wind is None:
        return T_new, q_new, qc_det, precip
    if not params.momentum_transport:
        return T_new, q_new, qc_det, precip, torch.zeros_like(wind)

    # ---- convective momentum transport ---------------------------------
    u_s = torch.flip(wind, (-1,))
    u_src = _pick(u_s, ksrc)
    u_p = _ascend(u_s, u_src, is_src, eps_dz)
    du_s = sub(u_s)
    anomaly = (1.0 - params.pgcon) * (_pick(u_p, ktop) - _pick(u_s, ktop))
    du_s = du_s + torch.where(
        at_top, (Mb * anomaly)[..., None] / dm_top[..., None], 0.0
    )
    # exact column-momentum closure
    total = (du_s * dm_s).sum(dim=-1)
    du_s = du_s - torch.where(incloud, (total / wsum)[..., None], 0.0)
    dwind = torch.flip(du_s, (-1,)) * dt
    return T_new, q_new, qc_det, precip, dwind
