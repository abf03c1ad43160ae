"""One physics interval with the prognostic surface updates (port of
``fv3net_tpu/runtime/surface_step.py``): slab ocean, sea ice, bucket land
and Noah soil around ``physics_step``, as the production chunk
(``runtime/fused.py::build_fused_production_chunk``) runs them."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from fv3net_torch.dycore.state import DycoreState
from fv3net_torch.physics import PhysicsConfig, physics_step
from fv3net_torch.physics import land as bucket
from fv3net_torch.physics import sea_ice, slab_ocean, soil
from fv3net_torch.runtime import names


def _where_land(mask, land_value, other):
    """``land_value`` where the mask reads land (> 0.5), else ``other``;
    ``land_value`` everywhere without a mask."""
    if mask is None:
        return land_value
    return torch.where(mask > 0.5, land_value, other)


def surface_coupling_factors(
    surface: Dict[str, torch.Tensor], nml
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(evap_factor, ice_frac)`` from the current surface state.

    evap_factor: land evaporation efficiency (Noah beta over soil
    moisture, or the bucket beta), 1 over ocean.  ice_frac: sea-ice
    fraction for the radiative albedo feedback, with snow-covered land
    blended in under the Noah model.
    """
    evap_factor = None
    mask = surface.get(names.MASK)
    if nml.land_model == "noah":
        beta = soil.evaporation_efficiency(surface["soil_moisture_layers"])
        evap_factor = _where_land(mask, beta, 1.0)
    elif nml.bucket_land:
        land_p = bucket.BucketLandParams(
            field_capacity_m=nml.bucket_capacity_m)
        beta = bucket.evaporation_efficiency(surface["soil_moisture"], land_p)
        evap_factor = _where_land(mask, beta, 1.0)

    ice_frac = None
    if nml.sea_ice:
        ice_frac = sea_ice.ice_fraction(surface["ice_thickness"])
    if nml.land_model == "noah":
        # snow-covered land is radiatively white like sea ice
        snow_cov = soil.snow_cover_fraction(surface["snow_water_equivalent"])
        snow_cov = _where_land(mask, snow_cov, 0.0)
        ice_frac = (snow_cov if ice_frac is None
                    else torch.maximum(ice_frac, snow_cov))
    return evap_factor, ice_frac


def physics_with_surface(
    dycore: DycoreState,
    surface: Dict[str, torch.Tensor],
    cosz: torch.Tensor,
    lat: torch.Tensor,
    dt: float,
    nml,
    phys_cfg: PhysicsConfig,
    radiation_fn=None,
) -> Tuple[DycoreState, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One physics interval and the prognostic surface updates.

    Returns ``(new_dycore, new_surface, raw_diags)``.  ``surface`` is not
    mutated; the returned dict carries the updated prognostic surface
    fields (TSFC/SST under the slab ocean, ice thickness, soil and snow
    states, this step's TOTAL_PRECIP).
    """
    surface = dict(surface)
    mask = surface.get(names.MASK)
    evap_factor, ice_frac = surface_coupling_factors(surface, nml)

    new_dycore, raw = physics_step(
        dycore, surface[names.TSFC], cosz, lat, dt, phys_cfg,
        radiation_fn=radiation_fn,
        # subgrid-orography std enables mountain-wave drag where a
        # surface field provides it
        sgh=surface.get("sgh"),
        evap_factor=evap_factor,
        land_frac=mask,
        ice_frac=ice_frac,
    )

    if nml.land_model == "noah":
        snow_rate = raw.get("SNOWsfc", torch.zeros_like(raw["PRATEsfc"]))
        rain_rate = torch.clamp(raw["PRATEsfc"] - snow_rate, min=0.0)
        stc1, smc1, swe1, sdiags = soil.noah_land_step(
            surface["soil_temperature"],
            surface["soil_moisture_layers"],
            surface["snow_water_equivalent"],
            surface["deep_soil_temperature"],
            surface[names.TSFC],
            rain_rate,
            snow_rate,
            raw["evaporation"],
            dt,
        )
        if mask is not None:  # Noah only on land points
            land = mask > 0.5
            stc1 = torch.where(land[None], stc1, surface["soil_temperature"])
            smc1 = torch.where(land[None], smc1,
                               surface["soil_moisture_layers"])
            swe1 = torch.where(land, swe1, 0.0)
            for k in ("ground_heat_flux", "snow_melt_heat",
                      "RUNOFFsfc", "DRAINsfc"):
                sdiags[k] = torch.where(land, sdiags[k], 0.0)
        surface["soil_temperature"] = stc1
        surface["soil_moisture_layers"] = smc1
        surface["snow_water_equivalent"] = swe1
        # ground and snowmelt heat leave the skin budget (subtracted by
        # slab_ocean.net_surface_flux through GHFLXsfc)
        raw["GHFLXsfc"] = sdiags["ground_heat_flux"] + sdiags["snow_melt_heat"]
        raw["RUNOFFsfc"] = sdiags["RUNOFFsfc"]
        raw["DRAINsfc"] = sdiags["DRAINsfc"]
        raw["SNODsfc"] = swe1
        raw["snow_cover"] = sdiags["snow_cover"]
    elif nml.bucket_land:
        land_p = bucket.BucketLandParams(
            field_capacity_m=nml.bucket_capacity_m)
        w_new, runoff = bucket.bucket_hydrology_update(
            surface["soil_moisture"], raw["PRATEsfc"], raw["evaporation"],
            dt, land_p,
        )
        if mask is not None:  # the bucket only on land points
            w_new = torch.where(mask > 0.5, w_new, surface["soil_moisture"])
            runoff = torch.where(mask > 0.5, runoff, 0.0)
        surface["soil_moisture"] = w_new
        raw["soil_moisture"] = w_new
        raw["RUNOFFsfc"] = runoff

    if nml.slab_ocean:
        tsfc = surface[names.TSFC]
        # band radiation leaves out the upward surface fluxes: close the
        # budget with sigma*Ts^4 and the ocean albedo
        raw.setdefault("ULWRFsfc", 5.670374e-8 * tsfc ** 4)
        raw.setdefault("USWRFsfc", 0.06 * raw["DSWRFsfc"])
        ocean_params = slab_ocean.SlabOceanParams(
            mixed_layer_depth_m=nml.mixed_layer_depth_m)
        if nml.sea_ice:
            new_tsfc, h_new = sea_ice.slab_ocean_seaice_update(
                tsfc, surface["ice_thickness"], raw, dt, ocean_params,
                land_mask=mask,
            )
            surface["ice_thickness"] = h_new
            raw["ice_thickness"] = h_new
            raw["ice_fraction"] = sea_ice.ice_fraction(h_new)
        else:
            new_tsfc = slab_ocean.slab_ocean_update(
                tsfc, raw, dt, ocean_params, land_mask=mask)
        surface[names.TSFC] = new_tsfc
        surface[names.SST] = new_tsfc

    # this step's physics precipitation [m], the TOTAL_PRECIP state the
    # postphysics precipitation sum builds on
    surface[names.TOTAL_PRECIP] = raw["PRATEsfc"] * dt / 1000.0
    return new_dycore, surface, raw
