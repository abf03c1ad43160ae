"""Zero-layer thermodynamic sea ice coupled to the slab ocean (port of
``fv3net_tpu/physics/sea_ice.py``).

When the mixed layer's updated temperature falls below freezing, the
deficit freezes ice instead of supercooling the water; above freezing
under existing ice, the excess melts ice before the water warms.  The
exchange is exact::

    C (T_new - T*) = rho_i L_f (h_new - h)

with C the slab heat capacity.  The ice fraction (the radiation's albedo
feedback) saturates over ``h_ref``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fv3net_torch.physics.slab_ocean import (
    SlabOceanParams,
    net_surface_flux,
    slab_depth,
)


@dataclasses.dataclass(frozen=True)
class SeaIceParams:
    rho_ice: float = 917.0  # kg/m^3
    latent_fusion: float = 3.34e5  # J/kg
    t_freeze: float = 271.35  # K, freezing seawater
    h_ref: float = 0.3  # m: thickness at which the cell reads ~fully icy
    albedo_vis: float = 0.73  # GFS-like bare sea-ice albedos
    albedo_nir: float = 0.33


def ice_fraction(ice_h: torch.Tensor,
                 params: SeaIceParams = SeaIceParams()) -> torch.Tensor:
    """Cell ice cover in [0, 1] from thickness (saturating ramp)."""
    return torch.clamp(ice_h / params.h_ref, 0.0, 1.0)


def slab_ice_exchange(
    t_star: torch.Tensor,
    ice_h: torch.Tensor,
    heat_capacity,
    params: SeaIceParams = SeaIceParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exchange heat between the slab (unclamped temperature ``t_star``)
    and the ice reservoir: returns ``(t_new, ice_h_new)`` on the exact
    ledger above; the surface sits at ``t_freeze`` while ice remains."""
    le = params.rho_ice * params.latent_fusion  # J/m^3 of ice
    deficit = torch.clamp(params.t_freeze - t_star, min=0.0)
    growth = deficit * heat_capacity / le
    excess = torch.clamp(t_star - params.t_freeze, min=0.0)
    melt = torch.minimum(ice_h, excess * heat_capacity / le)
    h_new = ice_h + growth - melt
    t_new = torch.where(
        h_new > 0.0,
        params.t_freeze,
        t_star + deficit - melt * le / heat_capacity,
    )
    return t_new, h_new


def slab_ocean_seaice_update(
    t_surface: torch.Tensor,
    ice_h: torch.Tensor,
    diags,
    dt: float,
    ocean_params: SlabOceanParams = SlabOceanParams(),
    ice_params: SeaIceParams = SeaIceParams(),
    land_mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the coupled mixed-layer + zero-layer-ice budget: the
    slab integrates F_net without the freezing clamp, then the ice
    exchange moves the imbalance into latent heat of fusion.  Land points
    keep the thin-slab temperature and their ice."""
    f_net = net_surface_flux(diags)
    heat_capacity = (ocean_params.rho_water * ocean_params.cp_water
                     * slab_depth(ocean_params, land_mask))
    t_star = t_surface + dt * f_net / heat_capacity
    t_new, h_new = slab_ice_exchange(t_star, ice_h, heat_capacity,
                                     ice_params)
    if land_mask is not None:  # no sea ice on land
        t_new = torch.where(land_mask > 0.5, t_star, t_new)
        h_new = torch.where(land_mask > 0.5, ice_h, h_new)
    return t_new, h_new
