"""Monin-Obukhov surface layer (port of
``fv3net_tpu/physics/surface_layer.py``).

Businger-Dyer stability functions, a bulk-Richardson first guess, a fixed
number of similarity iterations and Charnock ocean roughness closed
against u*; elementwise over all columns.  A land fraction blends in a
fixed land roughness, and an evaporation factor (the land models'
beta) scales the evaporation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from fv3net_torch.core.constants import CP_AIR, GRAVITY, RDGAS, RVGAS
from fv3net_torch.ops import thermo
from fv3net_torch.physics.microphysics import saturation_specific_humidity

VONKARMAN = 0.4
ZVIR = RVGAS / RDGAS - 1.0  # ~0.608


@dataclasses.dataclass(frozen=True)
class SurfaceLayerParams:
    charnock: float = 0.014  # Charnock constant for ocean z0
    z0_land: float = 0.1  # m, roughness over land (vegetated default)
    z0_min: float = 1e-5  # m, smooth-ocean floor
    z0_max: float = 1.0  # m
    gustiness: float = 1.0  # m/s floor on wind speed
    n_iter: int = 3  # fixed M-O iterations
    zeta_min: float = -10.0  # unstable clamp on z/L
    zeta_max: float = 2.0  # stable clamp on z/L
    ocean_evaporation_factor: float = 1.0


def _psi_functions(zeta):
    """Integrated Businger-Dyer corrections psi_m, psi_h."""
    x = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** 0.25
    psi_m_un = (
        2.0 * torch.log((1.0 + x) / 2.0)
        + torch.log((1.0 + x * x) / 2.0)
        - 2.0 * torch.arctan(x)
        + math.pi / 2.0
    )
    psi_h_un = 2.0 * torch.log((1.0 + x * x) / 2.0)
    psi_st = -5.0 * torch.clamp(zeta, min=0.0)
    unstable = zeta < 0.0
    return (torch.where(unstable, psi_m_un, psi_st),
            torch.where(unstable, psi_h_un, psi_st))


def monin_obukhov_fluxes(
    t_air, q_air, p_sfc, delp_sfc, wind_speed, t_surface,
    params: SurfaceLayerParams = SurfaceLayerParams(),
    land_frac=None,
    evap_factor=None,
) -> Dict[str, torch.Tensor]:
    """Surface fluxes with Monin-Obukhov similarity: the
    ``bulk_surface_fluxes`` dict plus ``ustar`` [m/s], ``obukhov_inv``
    [1/m], ``hpbl_flux`` (kinematic w'thv' [K m/s]) and ``z1`` [m].
    ``land_frac`` [0, 1] blends the land roughness into the ocean's;
    ``evap_factor`` multiplies the evaporation."""
    k = VONKARMAN
    rho = p_sfc / (RDGAS * t_air)
    v = torch.clamp(wind_speed, min=params.gustiness)
    tv_air = t_air * (1.0 + ZVIR * q_air)
    z1 = 0.5 * RDGAS * tv_air * delp_sfc / (p_sfc * GRAVITY)
    z1 = torch.clamp(z1, min=2.0)

    qsat_s = saturation_specific_humidity(t_surface, p_sfc)
    tv_sfc = t_surface * (1.0 + ZVIR * qsat_s)
    dthv = tv_air - tv_sfc  # >0 stable, <0 unstable

    rib = GRAVITY * z1 * dthv / (0.5 * (tv_air + tv_sfc) * v * v)
    rib = torch.clamp(rib, -10.0, 0.2)

    # neutral first guess: smooth ocean, the land roughness over land
    # (without a land fraction the blends below are the ocean's values
    # exactly, and are skipped)
    z0 = torch.full_like(v, 1e-4)
    if land_frac is not None:
        z0 = z0 * (1.0 - land_frac) + params.z0_land * land_frac
    zeta = torch.where(rib < 0.0, rib * 2.0, rib / (1.0 - 5.0 * rib + 1e-6))
    zeta = torch.clamp(zeta, params.zeta_min, params.zeta_max)

    for _ in range(params.n_iter):
        psi_m, psi_h = _psi_functions(zeta)
        ln_m = torch.log(z1 / z0)
        ln_h = torch.log(z1 / (0.1 * z0))
        cm_sqrt = k / torch.clamp(ln_m - psi_m, min=0.1)
        ustar = cm_sqrt * v
        ch = k * cm_sqrt / torch.clamp(ln_h - psi_h, min=0.1)
        wthv = -ch * v * dthv
        lmo_inv = -k * GRAVITY * wthv / (
            torch.clamp(ustar, min=0.05) ** 3 * tv_air
        )
        zeta = torch.clamp(z1 * lmo_inv, params.zeta_min, params.zeta_max)
        # Charnock closure over the ocean
        z0_oc = torch.clamp(
            params.charnock * ustar * ustar / GRAVITY + 1.1e-5,
            params.z0_min, params.z0_max,
        )
        z0 = (z0_oc if land_frac is None else
              z0_oc * (1.0 - land_frac) + params.z0_land * land_frac)

    psi_m, psi_h = _psi_functions(zeta)
    ln_m = torch.log(z1 / z0)
    ln_h = torch.log(z1 / (0.1 * z0))
    cm = (k / torch.clamp(ln_m - psi_m, min=0.1)) ** 2
    ch = k * k / (
        torch.clamp(ln_m - psi_m, min=0.1) * torch.clamp(ln_h - psi_h, min=0.1)
    )
    ustar = torch.sqrt(cm) * v

    shf = rho * CP_AIR * ch * v * (t_surface - t_air)
    evap = (
        params.ocean_evaporation_factor
        * rho * ch * v * torch.clamp(qsat_s - q_air, min=0.0)
    )
    if evap_factor is not None:
        evap = evap * evap_factor
    lv = thermo.latent_heat_vaporization(t_surface)
    mass_sfc = delp_sfc / GRAVITY
    wthv = ch * v * (-dthv) + ZVIR * 0.5 * (tv_air + tv_sfc) * (evap / rho)
    lmo_inv = -VONKARMAN * GRAVITY * wthv / (
        torch.clamp(ustar, min=0.05) ** 3 * tv_air
    )
    return {
        "SHTFLsfc": shf,
        "LHTFLsfc": lv * evap,
        "evaporation": evap,
        "drag_factor": rho * cm * v / mass_sfc,
        "ustar": ustar,
        "obukhov_inv": lmo_inv,
        "hpbl_flux": wthv,
        "z1": z1,
    }
