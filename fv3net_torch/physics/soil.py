"""Noah-style multi-layer land surface: soil heat, soil water, snowpack
(port of ``fv3net_tpu/physics/soil.py``), batched over all land columns.

- Soil temperature (4 layers, 0.1/0.3/0.6/1.0 m as in Noah): implicit
  heat diffusion with a moisture-dependent conductivity; the top boundary
  is the ground heat flux from the skin, the bottom the deep soil
  temperature tg3.
- Soil water (the same 4 layers): Clapp-Hornberger (1978) diffusivity and
  conductivity; infiltration of rain + snowmelt capped by a
  saturation-limited maximum (the excess runs off); gravitational
  drainage at the base; evapotranspiration from the layers.
- Snowpack: prognostic snow water equivalent fed by frozen precipitation,
  melting when the skin is above freezing.

The column's water closes to roundoff and the soil heat content changes
by the time-integrated boundary fluxes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from fv3net_torch.core.constants import LATENT_HEAT_FUSION

RHO_WATER = 1000.0  # kg/m^3
T_FREEZE = 273.16


@dataclasses.dataclass(frozen=True)
class SoilParams:
    # Noah layer thicknesses, top -> bottom [m]
    dz: Tuple[float, ...] = (0.1, 0.3, 0.6, 1.0)
    # Clapp-Hornberger hydraulics (loam-like defaults)
    theta_sat: float = 0.45  # porosity
    theta_fc: float = 0.30  # field capacity
    theta_wilt: float = 0.10  # wilting point
    b_ch: float = 4.9  # Clapp-Hornberger exponent
    k_sat: float = 3.4e-6  # m/s saturated conductivity
    psi_sat: float = -0.36  # m, saturated matric potential
    # thermal
    c_soil: float = 2.2e6  # J/m^3/K dry volumetric heat capacity
    c_water: float = 4.18e6  # J/m^3/K water volumetric heat capacity
    k_dry: float = 0.2  # W/m/K dry thermal conductivity
    k_wet: float = 1.6  # W/m/K saturated thermal conductivity
    # vegetation / evaporation partition
    veg_frac: float = 0.6  # green-vegetation fraction (transpiration)
    root_weights: Tuple[float, ...] = (0.25, 0.35, 0.25, 0.15)
    # snow
    swe_half: float = 0.01  # m SWE at 50% snow cover
    melt_timescale: float = 3600.0  # s, skin-excess melt relaxation
    skin_heat_capacity: float = 8.2e6  # J/m^2/K (the 2 m thin-slab land)
    snow_albedo: float = 0.65


def _sat(theta, p: SoilParams):
    return torch.clamp(theta / p.theta_sat, 0.02, 1.0)


def hydraulic_conductivity(theta, p: SoilParams = SoilParams()):
    """K(theta) = K_sat s^(2b+3), Clapp-Hornberger."""
    return p.k_sat * _sat(theta, p) ** (2.0 * p.b_ch + 3.0)


def hydraulic_diffusivity(theta, p: SoilParams = SoilParams()):
    """D(theta) = -b K_sat psi_sat s^(b+2) / theta_sat [m^2/s]."""
    s = _sat(theta, p)
    return (
        -p.b_ch * p.k_sat * p.psi_sat / p.theta_sat * s ** (p.b_ch + 2.0)
    )


def thermal_conductivity(theta, p: SoilParams = SoilParams()):
    """Simplified Johansen: dry/wet blend by saturation."""
    s = _sat(theta, p)
    return p.k_dry + (p.k_wet - p.k_dry) * s


def snow_cover_fraction(swe, p: SoilParams = SoilParams()):
    """Monotone 0..1 cover from SWE [m] (half cover at swe_half)."""
    return swe / (swe + p.swe_half)


def evaporation_efficiency(smc, p: SoilParams = SoilParams()):
    """beta in [0, 1] over land: the direct-evaporation part from the top
    layer's plant-available water and the transpiration part from the
    root-weighted column, blended by the green-vegetation fraction."""
    def avail(th):
        return torch.clamp(
            (th - p.theta_wilt) / (p.theta_fc - p.theta_wilt), 0.0, 1.0
        )

    beta_dir = avail(smc[0])
    beta_root = sum(
        p.root_weights[i] * avail(smc[i]) for i in range(len(p.dz))
    )
    return (1.0 - p.veg_frac) * beta_dir + p.veg_frac * beta_root


def soil_thermal_step(stc, tg3, ground_flux, smc, dt: float,
                      p: SoilParams = SoilParams()):
    """Implicit 4-layer heat diffusion: stc [nl, ...] (0 = top), tg3 the
    deep temperature below the last layer, ground_flux W/m^2 into the soil
    at the top, smc [nl, ...] for the conductivity.  The tridiagonal
    system is solved by a Thomas elimination unrolled over the layers."""
    nl = len(p.dz)
    dz = [float(d) for d in p.dz]
    lam = thermal_conductivity(smc, p)  # [nl, ...]
    heat_cap = p.c_soil + p.c_water * smc  # [nl, ...] J/m^3/K

    # interface conductances between layers i and i+1 [W/m^2/K]
    g = []
    for i in range(nl - 1):
        d = 0.5 * (dz[i] + dz[i + 1])
        lam_if = 0.5 * (lam[i] + lam[i + 1])
        g.append(lam_if / d)
    # bottom conductance to tg3 (half the last layer)
    g_bot = lam[nl - 1] / (0.5 * dz[nl - 1])

    a = [None] * nl  # sub (couples to i-1)
    c = [None] * nl  # super (couples to i+1)
    b = [None] * nl
    d = [None] * nl
    for i in range(nl):
        cap = heat_cap[i] * dz[i] / dt
        a[i] = -g[i - 1] if i > 0 else torch.zeros_like(cap)
        c[i] = -g[i] if i < nl - 1 else torch.zeros_like(cap)
        b[i] = cap - a[i] - c[i]
        d[i] = cap * stc[i]
    d[0] = d[0] + ground_flux
    b[nl - 1] = b[nl - 1] + g_bot
    d[nl - 1] = d[nl - 1] + g_bot * tg3

    cp = [None] * nl
    dp = [None] * nl
    cp[0] = c[0] / b[0]
    dp[0] = d[0] / b[0]
    for i in range(1, nl):
        den = b[i] - a[i] * cp[i - 1]
        cp[i] = c[i] / den
        dp[i] = (d[i] - a[i] * dp[i - 1]) / den
    out = [None] * nl
    out[nl - 1] = dp[nl - 1]
    for i in range(nl - 2, -1, -1):
        out[i] = dp[i] - cp[i] * out[i + 1]
    return torch.stack(out)


def soil_water_step(
    smc, infiltration, evap_direct, transpiration, dt: float,
    p: SoilParams = SoilParams(),
):
    """Explicit Richards-type update of the layer moistures: smc [nl, ...]
    volumetric; infiltration [...] m/s reaching the soil; evap_direct m/s
    from layer 0; transpiration m/s root-weighted.  Returns ``(smc_new,
    drainage [m/s], sub_runoff [m/s])``; the saturation excess and the
    over-evaporation clamp go to the runoff so the column closes."""
    nl = len(p.dz)
    dz = [float(d) for d in p.dz]
    # Darcy fluxes at the interior interfaces, positive downward
    flux = []
    for i in range(nl - 1):
        d_if = 0.5 * (dz[i] + dz[i + 1])
        theta_if = 0.5 * (smc[i] + smc[i + 1])
        D = hydraulic_diffusivity(theta_if, p)
        K = hydraulic_conductivity(theta_if, p)
        q = -D * (smc[i + 1] - smc[i]) / d_if + K
        # limited to the water the donor layer holds this step
        qmax_dn = (smc[i] - p.theta_wilt * 0.1) * dz[i] / dt
        qmax_up = (smc[i + 1] - p.theta_wilt * 0.1) * dz[i + 1] / dt
        q = torch.clamp(q, -torch.clamp(qmax_up, min=0.0),
                        torch.clamp(qmax_dn, min=0.0))
        flux.append(q)
    drainage = hydraulic_conductivity(smc[nl - 1], p)
    drainage = torch.minimum(
        drainage, torch.clamp(smc[nl - 1] - p.theta_wilt * 0.1, min=0.0)
        * dz[nl - 1] / dt
    )

    new = []
    for i in range(nl):
        q_in = infiltration if i == 0 else flux[i - 1]
        q_out = drainage if i == nl - 1 else flux[i]
        sink = transpiration * p.root_weights[i] + (
            evap_direct if i == 0 else 0.0
        )
        new.append(smc[i] + dt * (q_in - q_out - sink) / dz[i])
    smc_new = torch.stack(new)
    excess = sum(
        torch.clamp(new[i] - p.theta_sat, min=0.0) * dz[i] for i in range(nl)
    )
    deficit = sum(
        torch.clamp(0.01 - new[i], min=0.0) * dz[i] for i in range(nl)
    )
    sub_runoff = (excess - deficit) / dt
    smc_new = torch.clamp(smc_new, 0.01, p.theta_sat)
    return smc_new, drainage, sub_runoff


def noah_land_step(
    stc,  # [nl, ...] soil temperatures
    smc,  # [nl, ...] volumetric soil moisture
    swe,  # [...] snow water equivalent, m
    tg3,  # [...] deep soil temperature
    t_skin,  # [...] current land skin temperature
    rain_rate,  # [...] kg/m^2/s liquid precip reaching the surface
    snow_rate,  # [...] kg/m^2/s frozen precip
    evap_rate,  # [...] kg/m^2/s actual evapotranspiration
    dt: float,
    p: SoilParams = SoilParams(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One land-surface step (snow, soil heat, soil water): ``(stc_new,
    smc_new, swe_new, diags)``.  ``diags`` holds ``ground_heat_flux`` and
    ``snow_melt_heat`` [W/m^2] (to be subtracted from the skin budget),
    ``RUNOFFsfc``/``DRAINsfc`` [kg/m^2/s], ``snow_cover`` and
    ``SNODsfc``."""
    # ---- snowpack -------------------------------------------------------
    swe1 = swe + dt * snow_rate / RHO_WATER
    # energy-limited melt: the skin's excess over freezing drains into
    # fusion over melt_timescale
    melt_energy = (
        p.skin_heat_capacity
        * torch.clamp(t_skin - T_FREEZE, min=0.0)
        / p.melt_timescale
    )  # W/m^2
    melt_potential = melt_energy / (RHO_WATER * LATENT_HEAT_FUSION)  # m/s
    melt = torch.minimum(melt_potential, swe1 / dt)
    swe_new = swe1 - dt * melt
    snow_melt_heat = melt * RHO_WATER * LATENT_HEAT_FUSION  # W/m^2

    # ---- partition evaporation; infiltration and surface runoff --------
    evap_ms = evap_rate / RHO_WATER  # m/s
    evap_direct = (1.0 - p.veg_frac) * evap_ms
    transp = p.veg_frac * evap_ms
    water_in = rain_rate / RHO_WATER + melt  # m/s at the soil surface
    cap = p.k_sat * (
        1.0 + 4.0 * torch.clamp(
            (p.theta_sat - smc[0]) / p.theta_sat, 0.0, 1.0
        )
    )
    infil = torch.minimum(water_in, cap)
    surf_runoff = water_in - infil

    smc_new, drainage, sub_runoff = soil_water_step(
        smc, infil, evap_direct, transp, dt, p
    )

    # ---- soil heat ------------------------------------------------------
    lam0 = thermal_conductivity(smc[0], p)
    ground_flux = lam0 / (0.5 * float(p.dz[0])) * (t_skin - stc[0])
    stc_new = soil_thermal_step(stc, tg3, ground_flux, smc_new, dt, p)

    diags = {
        "ground_heat_flux": ground_flux,
        "snow_melt_heat": snow_melt_heat,
        "RUNOFFsfc": (surf_runoff + sub_runoff) * RHO_WATER,
        "DRAINsfc": drainage * RHO_WATER,
        "snow_cover": snow_cover_fraction(swe_new, p),
        "SNODsfc": swe_new,
    }
    return stc_new, smc_new, swe_new, diags
