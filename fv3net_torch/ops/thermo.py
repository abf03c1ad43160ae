"""Column thermodynamics on tensors (port of
``fv3net_tpu/ops/thermo.py``).

The vertical axis is positional (default: last); level 0 is the model
top.  Formulas and constants match the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from fv3net_torch.core.constants import (
    CP_AIR,
    CV_AIR,
    DEFAULT_SURFACE_TEMPERATURE,
    EARTH_RADIUS,
    FREEZING_TEMPERATURE,
    GRAVITY,
    KG_M2_TO_MM,
    KG_M2S_TO_MM_DAY,
    LATENT_HEAT_FUSION,
    LATENT_HEAT_VAPORIZATION_0_C,
    POISSON_CONST,
    RDGAS,
    REFERENCE_SURFACE_PRESSURE,
    RVGAS,
    SEC_PER_DAY,
    SPECIFIC_ENTHALPY_LIQUID,
    SPECIFIC_ENTHALPY_VAPOR,
    TOA_PRESSURE,
)
from fv3net_torch.ops import zscan


def potential_temperature(pressure, temperature):
    """theta = T * (p0 / p)^kappa."""
    return temperature * (REFERENCE_SURFACE_PRESSURE / pressure) ** POISSON_CONST


def temperature_from_potential_temperature(pressure, theta):
    return theta * (pressure / REFERENCE_SURFACE_PRESSURE) ** POISSON_CONST


def latent_heat_vaporization(temperature):
    """Temperature-dependent Lv."""
    return LATENT_HEAT_VAPORIZATION_0_C + (
        SPECIFIC_ENTHALPY_LIQUID - SPECIFIC_ENTHALPY_VAPOR
    ) * (temperature - FREEZING_TEMPERATURE)


def saturation_pressure(temperature):
    """August-Roche-Magnus saturation vapor pressure."""
    tc = temperature - 273.15
    return 610.94 * torch.exp(17.625 * tc / (tc + 243.04))


def relative_humidity(temperature, specific_humidity, density):
    """RH from T, q, rho."""
    partial_pressure = RVGAS * specific_humidity * density * temperature
    return partial_pressure / saturation_pressure(temperature)


def relative_humidity_from_pressure(temperature, specific_humidity, pressure):
    """RH from T, q, p (Wallace & Hobbs Eq 3.59)."""
    mixing_ratio = specific_humidity / (1 - specific_humidity)
    partial_pressure = pressure * mixing_ratio / (mixing_ratio + RDGAS / RVGAS)
    return partial_pressure / saturation_pressure(temperature)


def specific_humidity_from_rh(temperature, rh, density):
    """q from T, RH, rho."""
    partial_pressure = rh * saturation_pressure(temperature)
    return partial_pressure / RVGAS / density / temperature


def density(delp, delz):
    """rho = |delp / delz / g|."""
    return torch.abs(delp / delz / GRAVITY)


def pressure_thickness(rho, delz):
    """delp = |rho * delz * g|."""
    return torch.abs(rho * delz * GRAVITY)


def layer_mass(delp):
    """kg/m^2 per layer."""
    return delp / GRAVITY


def internal_energy(temperature):
    """c_v * T."""
    return CV_AIR * temperature


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


def net_heating(
    dlw_sfc,
    dsw_sfc,
    ulw_sfc,
    ulw_toa,
    usw_sfc,
    usw_toa,
    dsw_toa,
    shf,
    surface_rain_rate,
    surface_temperature=FREEZING_TEMPERATURE + 10,
):
    """Net column heating from physics, W/m^2."""
    lv = latent_heat_vaporization(surface_temperature)
    return (
        -dlw_sfc
        - dsw_sfc
        + ulw_sfc
        - ulw_toa
        + usw_sfc
        - usw_toa
        + dsw_toa
        + shf
        + surface_rain_rate * lv
    )


def latent_heat_flux_to_evaporation(
    lhf, surface_temperature=DEFAULT_SURFACE_TEMPERATURE
):
    """Evaporation kg/m^2/s from latent heat flux."""
    return lhf / latent_heat_vaporization(surface_temperature)


def surface_evaporation_mm_day_from_latent_heat_flux(latent_heat_flux):
    """Surface evaporation in mm/day."""
    return KG_M2S_TO_MM_DAY * latent_heat_flux_to_evaporation(latent_heat_flux)


def net_precipitation(lhf, prate):
    """(P - E) in mm/day."""
    return (prate - latent_heat_flux_to_evaporation(lhf)) * SEC_PER_DAY


def total_water(sphum, ice_water, liquid_water, rain_water, snow_water,
                graupel_water):
    """Total water species mixing ratio."""
    return sphum + ice_water + liquid_water + rain_water + snow_water + graupel_water


def liquid_ice_temperature(
    temperature, ice_water, liquid_water, rain_water, snow_water, graupel_water
):
    """T_LI = T - Lv/cp (ql+qr) - (Lv+Lf)/cp (qi+qs+qg)."""
    lv = latent_heat_vaporization(temperature)
    liquid_adjustment = (lv / CP_AIR) * (rain_water + liquid_water)
    ice_adjustment = ((lv + LATENT_HEAT_FUSION) / CP_AIR) * (
        ice_water + snow_water + graupel_water
    )
    return temperature - liquid_adjustment - ice_adjustment


# vertically dependent: the vertical axis is ``axis`` (default -1); level 0
# is the model top, level nz-1 the surface


def mass_cumsum(field, delp, axis: int = -1):
    """Mass-weighted cumulative sum."""
    return torch.cumsum(field * delp / GRAVITY, dim=axis)


def mass_divergence(field_interface, delp, axis: int = -1):
    """g * d(field)/dp from an interface array."""
    return GRAVITY * torch.diff(field_interface, dim=axis) / delp


def pressure_at_interface(delp, toa_pressure: float = TOA_PRESSURE,
                          axis: int = -1):
    """Interface pressures [p_toa, p_toa + cumsum(delp)], one longer than
    ``delp`` along ``axis``."""
    ax = axis % delp.ndim
    top = torch.full_like(delp.narrow(ax, 0, 1), toa_pressure)
    return zscan.cumsum(torch.cat([top, delp], dim=ax), axis=ax)


def pressure_at_midpoint(delp, toa_pressure: float = TOA_PRESSURE,
                         axis: int = -1):
    """Midpoint pressure by linear interpolation of interfaces."""
    pi = pressure_at_interface(delp, toa_pressure, axis)
    return _interface_to_midpoint(pi, axis)


def pressure_at_midpoint_log(delp, toa_pressure: float = TOA_PRESSURE,
                             axis: int = -1):
    """Simmons & Burridge (1981) Eq 3.17: delp / dlog(p)."""
    pi = pressure_at_interface(delp, toa_pressure, axis)
    dlogp = torch.diff(torch.log(pi), dim=axis)
    return delp / dlogp


def _interface_to_midpoint(field_interface, axis: int = -1):
    n = field_interface.shape[axis]
    return (field_interface.narrow(axis, 0, n - 1)
            + field_interface.narrow(axis, 1, n - 1)) / 2


def height_at_interface(dz, phis, axis: int = -1):
    """Interface heights from (negative) layer thicknesses and the surface
    geopotential: the bottom interface is phis / g, summed upward.  One
    longer than ``dz`` along ``axis``."""
    ax = axis % dz.ndim
    bottom = torch.as_tensor(phis / GRAVITY, dtype=dz.dtype,
                             device=dz.device).unsqueeze(ax)
    bottom = bottom.expand(
        tuple(1 if i == ax else s for i, s in enumerate(dz.shape)))
    dzv = -torch.flip(dz, (ax,))
    stacked = torch.cat([bottom, dzv], dim=ax)
    return torch.flip(torch.cumsum(stacked, dim=ax), (ax,))


def height_at_midpoint(dz, phis, axis: int = -1):
    """Midpoint heights."""
    return _interface_to_midpoint(height_at_interface(dz, phis, axis), axis)


def dz_and_top_to_phis(top_height, dz, axis: int = -1):
    """phis = g * (top_height + sum dz)."""
    return GRAVITY * (top_height + torch.sum(dz, dim=axis))


def surface_pressure_from_delp(delp, p_toa: float = 300.0, axis: int = -1):
    """ps = sum(delp) + p_toa."""
    return torch.sum(delp, dim=axis) + p_toa


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


def column_integrated_liquid_water_equivalent(sphum, delp, axis: int = -1):
    """Precipitable water in mm."""
    return KG_M2_TO_MM * mass_integrate(sphum, delp, axis)


def minus_column_integrated_moistening(dq_dt, delp, axis: int = -1):
    """-<dq/dt> in mm/day."""
    return -KG_M2S_TO_MM_DAY * mass_integrate(dq_dt, delp, axis)


def mass_streamfunction(v_zonal_mean, pressure, lat_deg, axis: int = -1):
    """Meridional mass streamfunction psi(lat, p) in 1e9 kg/s:
    psi = 2 pi a cos(lat)/g * int_0^p v dp', integrated from the model
    top.

    Args:
        v_zonal_mean: zonal-mean northward wind with the pressure axis at
            ``axis``.
        pressure: 1-D pressure coordinate [Pa] along that axis.
        lat_deg: latitudes broadcastable against the non-pressure axes.
    """
    like = dict(dtype=v_zonal_mean.dtype, device=v_zonal_mean.device)
    (dp,) = torch.gradient(torch.as_tensor(pressure, **like))
    shape = [1] * v_zonal_mean.ndim
    ax = axis % v_zonal_mean.ndim
    shape[ax] = len(dp)
    integrand = v_zonal_mean * dp.reshape(shape)
    psi = torch.cumsum(integrand, dim=ax) * (
        2 * math.pi * EARTH_RADIUS / GRAVITY
    )
    lat = torch.deg2rad(torch.as_tensor(lat_deg, **like))
    return psi * torch.cos(lat) / 1e9


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
