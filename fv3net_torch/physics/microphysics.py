"""Zhao-Carr large-scale microphysics, gscond + precpd (port of
``fv3net_tpu/physics/microphysics.py``).

``gscond``: Sundqvist critical-RH condensation with a saturation
adjustment and rate-limited cloud evaporation.  ``precpd``: liquid and
ice autoconversion, rain and snow fluxes falling through the column
(a Python loop over z) with melting, freezing, re-evaporation and
sublimation.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fv3net_torch.core.constants import (
    CP_AIR,
    LATENT_HEAT_FUSION,
    RDGAS,
    RVGAS,
)
from fv3net_torch.ops import thermo

EPS = RDGAS / RVGAS  # ~0.622
T_FREEZE = 273.16
T_ICE_ALL = 258.16  # all-ice below -15 C


def saturation_specific_humidity(T, p):
    """qsat from Magnus saturation pressure (consistent with ops.thermo)."""
    es = thermo.saturation_pressure(T)
    es = torch.minimum(es, 0.9 * p)  # guard very low pressure levels
    return EPS * es / (p - (1.0 - EPS) * es)


def ice_fraction(T):
    """Cloud-ice fraction: 0 above freezing, 1 below -15 C, linear ramp."""
    return torch.clamp((T_FREEZE - T) / (T_FREEZE - T_ICE_ALL), 0.0, 1.0)


def _latent_heat(T):
    """Condensation latent heat including fusion for the ice fraction."""
    return (
        thermo.latent_heat_vaporization(T)
        + ice_fraction(T) * LATENT_HEAT_FUSION
    )


def _condensation_adjustment(T, q, p, lv):
    """Linearized saturation adjustment: amount to condense (>0) or the
    saturation deficit (<0)."""
    qsat = saturation_specific_humidity(T, p)
    dqsat_dT = lv * qsat / (RVGAS * T * T)
    return (q - qsat) / (1.0 + (lv / CP_AIR) * dqsat_dT)


@dataclasses.dataclass(frozen=True)
class MicrophysicsParams:
    u00: float = 0.80  # critical RH for condensation onset
    evap_timescale: float = 1800.0  # s, cloud evaporation toward u00
    n_adjust: int = 2  # saturation-adjustment iterations
    auto_conversion_rate: float = 1.0e-3  # c00, 1/s
    qc_crit: float = 2.0e-4  # qc0 autoconversion scale kg/kg
    snow_auto_rate: float = 1.0e-3  # 1/s ice -> snow autoconversion
    qi_crit: float = 1.0e-4  # ice autoconversion scale kg/kg
    accretion_rate: float = 2.0  # 1/s per unit condensate
    evap_rate: float = 2.0e-5  # rain re-evaporation efficiency
    sub_rate: float = 1.0e-5  # snow sublimation efficiency
    melt_timescale: float = 600.0  # s, snow melting above freezing


def gscond(T, q, qc, p, dt: float,
           params: MicrophysicsParams = MicrophysicsParams()):
    """Grid-scale condensation/evaporation; (..., nz) in and out."""
    for _ in range(params.n_adjust):
        lv = _latent_heat(T)
        qsat = saturation_specific_humidity(T, p)
        rh = torch.clamp(q / torch.clamp(qsat, min=1e-12), 0.0, 2.0)
        dq_full = _condensation_adjustment(T, q, p, lv)
        cond = torch.clamp(dq_full, min=0.0)
        room = torch.clamp(-dq_full, min=0.0)
        evap_frac = torch.where(
            rh < params.u00,
            torch.clamp(
                (params.u00 - rh) / params.u00
                * (dt / params.evap_timescale + 1.0),
                0.0,
                1.0,
            ),
            0.0,
        )
        evap = torch.minimum(qc, room) * evap_frac
        dqc = cond - evap
        T = T + (lv / CP_AIR) * dqc
        q = q - dqc
        qc = qc + dqc
    return T, q, qc


def sundqvist_cloud_fraction(
    T, q, qc, p, params: MicrophysicsParams = MicrophysicsParams()
):
    """Cloud fraction consistent with the gscond closure:
    ``b = 1 - sqrt((1-rh)/(1-u00))`` for rh > u00 (Sundqvist et al.
    1989), zero where there is no condensate (the radiation's cloud
    optics read it)."""
    qsat = saturation_specific_humidity(T, p)
    rh = (q / qsat.clamp(min=1e-12)).clamp(0.0, 1.0)
    arg = ((1.0 - rh) / max(1.0 - params.u00, 1e-6)).clamp(0.0, 1.0)
    return torch.where(qc > 1e-8, 1.0 - torch.sqrt(arg), 0.0)


def precpd(
    T, q, qc, p, delp, dt: float,
    params: MicrophysicsParams = MicrophysicsParams(),
):
    """Precipitation production and fall.  Returns (T, q, qc,
    precip_rate, snow_rate), rates in kg/m^2/s; ``precip_rate`` is rain
    plus snow reaching the surface."""
    fi = ice_fraction(T)
    qliq = (1.0 - fi) * qc
    qice = fi * qc
    praut = (
        params.auto_conversion_rate
        * (1.0 - torch.exp(-((qliq / params.qc_crit) ** 2)))
        + params.accretion_rate * qc
    ) * qliq
    cold = torch.clamp((T_FREEZE - T) / 15.0, 0.0, 2.0)
    psaut = (
        params.snow_auto_rate
        * (1.0 - torch.exp(-((qice / params.qi_crit) ** 2)))
        * (1.0 + cold)
        + params.accretion_rate * qc
    ) * qice

    d_rain = torch.minimum(praut * dt, qliq)
    d_snow = torch.minimum(psaut * dt, qice)
    qc = qc - d_rain - d_snow

    lv = thermo.latent_heat_vaporization(T)
    ls = lv + LATENT_HEAT_FUSION
    qsat = saturation_specific_humidity(T, p)
    deficit = torch.clamp(qsat - q, min=0.0)
    dm = thermo.layer_mass(delp)
    warm = torch.clamp(T - T_FREEZE, min=0.0)
    cold = torch.clamp(T_FREEZE - T, min=0.0)
    melt_frac = torch.clamp(dt / params.melt_timescale * warm / 2.0, max=1.0)
    frz_frac = torch.clamp(dt / params.melt_timescale * cold / 2.0, max=1.0)

    rain = torch.zeros(T.shape[:-1], dtype=T.dtype, device=T.device)
    snow = torch.zeros_like(rain)
    dq_evap, dq_sub, dmelt = [], [], []
    for k in range(T.shape[-1]):
        dm_k = dm[..., k]
        rain = rain + d_rain[..., k] * dm_k / dt
        snow = snow + d_snow[..., k] * dm_k / dt
        # snow melts above freezing, supercooled rain freezes below
        melt = snow * melt_frac[..., k]
        frz = rain * frz_frac[..., k]
        snow = snow - melt + frz
        rain = rain + melt - frz
        # re-evaporation / sublimation in subsaturated air
        evap_r = torch.minimum(
            params.evap_rate * deficit[..., k] * dt * rain, rain
        )
        evap_s = torch.minimum(
            params.sub_rate * deficit[..., k] * dt * snow, snow
        )
        rain = rain - evap_r
        snow = snow - evap_s
        dq_evap.append(evap_r * dt / dm_k)
        dq_sub.append(evap_s * dt / dm_k)
        dmelt.append((melt - frz) * dt / dm_k)
    dq_evap = torch.stack(dq_evap, dim=-1)
    dq_sub = torch.stack(dq_sub, dim=-1)
    dmelt = torch.stack(dmelt, dim=-1)

    q = q + dq_evap + dq_sub
    T = (
        T
        - (lv / CP_AIR) * dq_evap
        - (ls / CP_AIR) * dq_sub
        - (LATENT_HEAT_FUSION / CP_AIR) * dmelt
    )
    return T, q, qc, rain + snow, snow


def microphysics_step(
    T, q, qc, p, delp, dt: float,
    params: MicrophysicsParams = MicrophysicsParams(),
) -> Tuple[torch.Tensor, ...]:
    """Full Zhao-Carr step: gscond then precpd.  Returns (T, q, qc,
    surface_precipitation_rate, snow_rate)."""
    T, q, qc = gscond(T, q, qc, p, dt, params)
    return precpd(T, q, qc, p, delp, dt, params)
