"""Held-Suarez (1994) idealized forcing (port of
``fv3net_tpu/physics/held_suarez.py``): Newtonian relaxation of
temperature toward a prescribed equilibrium profile and Rayleigh
friction in the boundary layer, the standard dynamical-core
benchmark."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fv3net_torch.core.constants import KAPPA, REFERENCE_SURFACE_PRESSURE


@dataclasses.dataclass(frozen=True)
class HeldSuarezParams:
    sigma_b: float = 0.7
    k_f: float = 1.0 / 86400.0  # surface friction rate [1/s]
    k_a: float = 1.0 / (40.0 * 86400.0)  # free-atmosphere relaxation
    k_s: float = 1.0 / (4.0 * 86400.0)  # surface relaxation
    delta_T_y: float = 60.0  # equator-pole temperature contrast [K]
    delta_theta_z: float = 10.0  # static-stability parameter [K]
    T_min: float = 200.0  # stratospheric floor [K]
    p0: float = REFERENCE_SURFACE_PRESSURE


def equilibrium_temperature(pmid, lat, params: HeldSuarezParams):
    """T_eq(lat, p) of Held & Suarez (1994) Eq. 3."""
    p_ratio = pmid / params.p0
    T = (
        315.0
        - params.delta_T_y * torch.sin(lat) ** 2
        - params.delta_theta_z * torch.log(p_ratio) * torch.cos(lat) ** 2
    ) * p_ratio ** KAPPA
    return T.clamp(min=params.T_min)


def held_suarez_forcing(
    T, wind, pmid, ps, lat, dt: float,
    params: HeldSuarezParams = HeldSuarezParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forcing step on z-last columns: T (..., nz), wind [3, ..., nz]
    Cartesian winds, pmid (..., nz) midlayer pressure, ps (...) surface
    pressure, lat (...) radians.  Returns (T_new, wind_new)."""
    sigma = pmid / ps[..., None]
    lat_b = lat[..., None]
    ramp = ((sigma - params.sigma_b) / (1.0 - params.sigma_b)).clamp(
        0.0, 1.0)
    # temperature relaxation at a latitude- and height-dependent rate
    # (HS94 Eq. 4)
    k_T = params.k_a + (params.k_s - params.k_a) * torch.cos(lat_b) ** 4 * ramp
    T_eq = equilibrium_temperature(pmid, lat_b, params)
    T_new = T + dt * k_T * (T_eq - T)
    # Rayleigh friction below sigma_b
    k_v = params.k_f * ramp
    wind_new = wind * (1.0 - dt * k_v)[None]
    return T_new, wind_new
