"""Column thermodynamics on tensors (port of the parts of
``fv3net_tpu/ops/thermo.py`` the port's slices call).

The vertical axis is positional (default: last); level 0 is the model
top.  Formulas and constants match the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from fv3net_torch.core.constants import (
    CP_AIR,
    CV_AIR,
    FREEZING_TEMPERATURE,
    GRAVITY,
    LATENT_HEAT_VAPORIZATION_0_C,
    RDGAS,
    RVGAS,
    SPECIFIC_ENTHALPY_LIQUID,
    SPECIFIC_ENTHALPY_VAPOR,
    TOA_PRESSURE,
)
from fv3net_torch.ops import zscan


def latent_heat_vaporization(temperature):
    """Temperature-dependent Lv."""
    return LATENT_HEAT_VAPORIZATION_0_C + (
        SPECIFIC_ENTHALPY_LIQUID - SPECIFIC_ENTHALPY_VAPOR
    ) * (temperature - FREEZING_TEMPERATURE)


def saturation_pressure(temperature):
    """August-Roche-Magnus saturation vapor pressure."""
    tc = temperature - 273.15
    return 610.94 * torch.exp(17.625 * tc / (tc + 243.04))


def layer_mass(delp):
    """kg/m^2 per layer."""
    return delp / GRAVITY


def moist_static_energy_tendency(dT_dt, dq_dt,
                                 temperature=FREEZING_TEMPERATURE):
    """c_v*dT/dt + Lv(T)*dq/dt, W/kg."""
    return CV_AIR * dT_dt + latent_heat_vaporization(temperature) * dq_dt


def temperature_tendency(mse_tendency, dq_dt,
                         temperature=FREEZING_TEMPERATURE):
    """Invert moist_static_energy_tendency for dT/dt."""
    return (
        mse_tendency - latent_heat_vaporization(temperature) * dq_dt
    ) / CV_AIR


def pressure_at_interface(delp, toa_pressure: float = TOA_PRESSURE,
                          axis: int = -1):
    """Interface pressures [p_toa, p_toa + cumsum(delp)], one longer than
    ``delp`` along ``axis``."""
    ax = axis % delp.ndim
    top = torch.full_like(delp.narrow(ax, 0, 1), toa_pressure)
    return zscan.cumsum(torch.cat([top, delp], dim=ax), axis=ax)


def pressure_at_midpoint_log(delp, toa_pressure: float = TOA_PRESSURE,
                             axis: int = -1):
    """Simmons & Burridge (1981) Eq 3.17: delp / dlog(p)."""
    pi = pressure_at_interface(delp, toa_pressure, axis)
    dlogp = torch.diff(torch.log(pi), dim=axis)
    return delp / dlogp


def virtual_temperature(temperature, specific_humidity):
    """Tv = T (1 + (Rv/Rd - 1) q)."""
    return temperature * (1 + (RVGAS / RDGAS - 1) * specific_humidity)


def hydrostatic_dz(T, q, delp, toa_pressure: float = TOA_PRESSURE,
                   axis: int = -1):
    """dz = -dlog(p) Rd Tv / g; negative like FV3."""
    pi = pressure_at_interface(delp, toa_pressure, axis)
    dlogp = torch.diff(torch.log(pi), dim=axis)
    tv = virtual_temperature(T, q)
    return -dlogp * RDGAS * tv / GRAVITY


def mass_integrate(field, delp, axis: int = -1):
    """Mass-weighted vertical integral, sum(f * delp / g)."""
    return torch.sum(field * delp / GRAVITY, dim=axis)


def column_integrated_heating_from_isobaric_transition(dT_dt, delp,
                                                      axis: int = -1):
    """cp-weighted column heating, W/m^2."""
    return CP_AIR * mass_integrate(dT_dt, delp, axis)


def column_integrated_heating_from_isochoric_transition(dT_dt, delp,
                                                       axis: int = -1):
    """cv-weighted column heating, W/m^2."""
    return CV_AIR * mass_integrate(dT_dt, delp, axis)


def non_negative_sphum(sphum, dQ1, dQ2,
                       dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale (dQ1, dQ2) where the moistening would drive q negative."""
    reduction_ratio = (-sphum) / (dt * dQ2)
    ok = sphum + dQ2 * dt >= 0
    return (torch.where(ok, dQ1, reduction_ratio * dQ1),
            torch.where(ok, dQ2, reduction_ratio * dQ2))


def update_moisture_tendency_to_ensure_non_negative_humidity(sphum, q2,
                                                             dt: float):
    return torch.where(sphum + q2 * dt >= 0, q2, -sphum / dt)


def update_temperature_tendency_to_conserve_mse(q1, q2_old, q2_new):
    mse = moist_static_energy_tendency(q1, q2_old)
    return temperature_tendency(mse, q2_new)


def non_negative_sphum_mse_conserving(
    sphum, q2, dt: float, q1: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """MSE-conserving humidity limiter of the ML correction."""
    q2_new = update_moisture_tendency_to_ensure_non_negative_humidity(
        sphum, q2, dt
    )
    q1_new = (
        update_temperature_tendency_to_conserve_mse(q1, q2, q2_new)
        if q1 is not None
        else None
    )
    return q2_new, q1_new
