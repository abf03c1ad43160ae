"""Slab (mixed-layer) ocean: prognostic surface temperature (port of
``fv3net_tpu/physics/slab_ocean.py``).

A well-mixed water column of depth ``h`` integrates the net surface
energy flux::

    dT_s/dt = F_net / (rho_w * c_w * h)
    F_net = DSWRFsfc - USWRFsfc + DLWRFsfc - ULWRFsfc - SHTFLsfc - LHTFLsfc

(W/m^2, positive as named; F_net positive warms the slab).  Land points
(mask > 0.5) use a much thinner effective layer.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SlabOceanParams:
    mixed_layer_depth_m: float = 50.0
    land_depth_m: float = 2.0  # thin effective layer over land
    rho_water: float = 1025.0  # kg/m^3
    cp_water: float = 3990.0  # J/kg/K
    t_min: float = 271.35  # freezing seawater floor, K


def net_surface_flux(diags) -> torch.Tensor:
    """F_net [W/m^2], positive warming the surface, from the physics
    step's flux diagnostics; ``GHFLXsfc`` (ground and snowmelt heat into
    the Noah soil column) is subtracted when present."""
    f = (
        diags["DSWRFsfc"]
        - diags["USWRFsfc"]
        + diags["DLWRFsfc"]
        - diags["ULWRFsfc"]
        - diags["SHTFLsfc"]
        - diags["LHTFLsfc"]
    )
    if "GHFLXsfc" in diags:
        f = f - diags["GHFLXsfc"]
    return f


def slab_depth(params: SlabOceanParams, land_mask=None):
    """The slab's depth: the mixed layer's, the thin land layer's where
    ``land_mask`` > 0.5."""
    depth = params.mixed_layer_depth_m
    if land_mask is not None:
        depth = torch.where(land_mask > 0.5,
                            land_mask.new_tensor(params.land_depth_m),
                            land_mask.new_tensor(depth))
    return depth


def slab_ocean_update(
    t_surface: torch.Tensor,
    diags,
    dt: float,
    params: SlabOceanParams = SlabOceanParams(),
    land_mask=None,
) -> torch.Tensor:
    """One step of the mixed-layer energy budget; returns new T_s."""
    f_net = net_surface_flux(diags)
    heat_capacity = (params.rho_water * params.cp_water
                     * slab_depth(params, land_mask))
    t_new = t_surface + dt * f_net / heat_capacity
    floored = torch.clamp(t_new, min=params.t_min)
    if land_mask is not None:
        # the floor is seawater freezing: ocean points only
        return torch.where(land_mask > 0.5, t_new, floored)
    return floored
