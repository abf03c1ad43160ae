"""Simplified Betts-Miller moist convective adjustment (port of
``fv3net_tpu/physics/convection.py``)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fv3net_torch.core.constants import CP_AIR, KAPPA, RVGAS
from fv3net_torch.ops import thermo
from fv3net_torch.physics.microphysics import saturation_specific_humidity


@dataclasses.dataclass(frozen=True)
class ConvectionParams:
    tau: float = 7200.0  # relaxation timescale [s]
    rh_ref: float = 0.7  # reference profile relative humidity
    p_top: float = 1.0e4  # no adjustment above this pressure [Pa]
    buoyancy_cap: float = 10.0  # max parcel excess over environment [K]


def _parcel_profile(T, q, pmid):
    """Temperature of a surface parcel lifted along a dry adiabat plus
    one linearized correction for the latent heat of its excess vapor."""
    p_sfc = pmid[..., -1:]
    T_sfc = T[..., -1:]
    q_sfc = q[..., -1:]
    T_dry = T_sfc * (pmid / p_sfc) ** KAPPA
    T_lim = torch.clamp(T_dry, min=150.0)
    qsat = saturation_specific_humidity(T_lim, pmid)
    lv = thermo.latent_heat_vaporization(T_dry)
    excess = torch.clamp(q_sfc - qsat, min=0.0)
    dqsat_dT = lv * qsat / (RVGAS * T_lim ** 2)
    dT = lv * excess / (CP_AIR * (1.0 + lv / CP_AIR * dqsat_dT))
    return T_dry + dT


def betts_miller(
    T, q, pmid, delp, dt: float,
    params: ConvectionParams = ConvectionParams(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Convective adjustment; returns (T, q, convective_precip_rate).

    Columns where the lifted parcel is warmer than the environment relax
    T toward the parcel and q toward ``rh_ref`` saturation over ``tau``,
    with the Frierson (2007) corrections that keep precipitation
    non-negative and column moist enthalpy conserved.
    """
    T_ref = _parcel_profile(T, q, pmid)
    w = (T_ref > T) & (pmid > params.p_top)

    T_ref = torch.minimum(T_ref, T + params.buoyancy_cap)
    q_ref = params.rh_ref * saturation_specific_humidity(T_ref, pmid)

    dT = torch.where(w, (T_ref - T) * dt / params.tau, 0.0)
    dq = torch.where(w, (q_ref - q) * dt / params.tau, 0.0)
    dq = torch.maximum(dq, -q)

    dm = thermo.layer_mass(delp)
    lv = thermo.latent_heat_vaporization(T)
    wm = (w * dm).sum(dim=-1, keepdim=True)

    # (1) shift the humidity reference so the column precipitates
    col_dq = (dq * dm).sum(dim=-1, keepdim=True)
    dq_shift = torch.where(
        wm > 0, torch.clamp(col_dq, min=0.0) / torch.clamp(wm, min=1.0), 0.0
    )
    dq = torch.where(w, dq - dq_shift, 0.0)
    # clamp to dq >= -q, then remove the clamp's water residual from the
    # layers that can spare it
    dq = torch.maximum(dq, -q)
    col_dq = (dq * dm).sum(dim=-1, keepdim=True)
    excess = torch.clamp(col_dq, min=0.0)
    cap = torch.clamp(q + dq, min=0.0) * dm * w
    cap_sum = cap.sum(dim=-1, keepdim=True)
    take = torch.where(
        cap_sum > 0.0,
        excess * cap / torch.clamp(cap_sum, min=1e-30) / dm,
        0.0,
    )
    dq = dq - take
    # (2) shift dT so cp<dT> + Lv<dq> = 0 for the final dq
    col_h = (CP_AIR * dT * dm + lv * dq * dm).sum(dim=-1, keepdim=True)
    corr = torch.where(
        wm > 0, col_h / (CP_AIR * torch.clamp(wm, min=1.0)), 0.0
    )
    dT = torch.where(w, dT - corr, 0.0)

    precip = torch.clamp(-(dq * dm).sum(dim=-1) / dt, min=0.0)
    return T + dT, q + dq, precip
