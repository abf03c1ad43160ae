"""Bulk-aerodynamic surface fluxes (port of
``fv3net_tpu/physics/surface.py``)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from fv3net_torch.core.constants import CP_AIR, GRAVITY, RDGAS
from fv3net_torch.ops import thermo
from fv3net_torch.physics.microphysics import saturation_specific_humidity


@dataclasses.dataclass(frozen=True)
class SurfaceParams:
    drag_coefficient: float = 1.2e-3  # C_d = C_h = C_q
    gustiness: float = 1.0  # m/s floor on wind speed
    ocean_evaporation_factor: float = 1.0


def bulk_surface_fluxes(
    t_air, q_air, p_sfc, delp_sfc, wind_speed, t_surface,
    params: SurfaceParams = SurfaceParams(),
    evap_factor=None,
) -> Dict[str, torch.Tensor]:
    """Sensible/latent heat fluxes and momentum drag over a saturated
    surface with constant exchange coefficients.  Returns LHTFLsfc,
    SHTFLsfc [W/m^2], evaporation [kg/m^2/s] and drag_factor [1/s].
    ``evap_factor`` (the land models' beta) multiplies the
    evaporation."""
    rho = p_sfc / (RDGAS * t_air)
    v = torch.clamp(wind_speed, min=params.gustiness)
    ch = params.drag_coefficient
    shf = rho * CP_AIR * ch * v * (t_surface - t_air)
    qsat_s = saturation_specific_humidity(t_surface, p_sfc)
    evap = (
        params.ocean_evaporation_factor
        * rho * ch * v * torch.clamp(qsat_s - q_air, min=0.0)
    )
    if evap_factor is not None:
        evap = evap * evap_factor
    lv = thermo.latent_heat_vaporization(t_surface)
    mass_sfc = delp_sfc / GRAVITY
    return {
        "SHTFLsfc": shf,
        "LHTFLsfc": lv * evap,
        "evaporation": evap,
        "drag_factor": rho * ch * v / mass_sfc,
    }
