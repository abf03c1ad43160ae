"""Bucket land-surface hydrology, Manabe (1969) (port of
``fv3net_tpu/physics/land.py``)::

    beta = min(1, W / (f * W_max))          evaporation efficiency
    dW/dt = P - beta * E_pot                (runoff clamps W at W_max)

with the field capacity W_max = 0.15 m and f = 0.75.  The land's surface
temperature rides the thin-slab branch of ``physics/slab_ocean.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

RHO_WATER = 1000.0  # kg/m^3


@dataclasses.dataclass(frozen=True)
class BucketLandParams:
    field_capacity_m: float = 0.15  # W_max, m of liquid water
    beta_threshold_frac: float = 0.75  # evap unlimited above f * W_max
    initial_fraction: float = 0.5  # spin-up fill level


def evaporation_efficiency(
    soil_moisture: torch.Tensor, params: BucketLandParams = BucketLandParams()
) -> torch.Tensor:
    """beta in [0, 1]: the fraction of potential evaporation the soil can
    supply."""
    wcrit = params.beta_threshold_frac * params.field_capacity_m
    return torch.clamp(soil_moisture / wcrit, 0.0, 1.0)


def bucket_hydrology_update(
    soil_moisture: torch.Tensor,
    precip_rate: torch.Tensor,  # kg/m^2/s reaching the surface
    evap_rate: torch.Tensor,  # kg/m^2/s evaporated (beta-limited)
    dt: float,
    params: BucketLandParams = BucketLandParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the bucket water budget: ``(soil_moisture_new [m],
    runoff_rate [kg/m^2/s])`` with dW * rho_w = (P - E - R) * dt exactly
    (runoff is the overflow above field capacity plus the clamp that
    keeps W >= 0)."""
    w_star = soil_moisture + dt * (precip_rate - evap_rate) / RHO_WATER
    w_new = torch.clamp(w_star, 0.0, params.field_capacity_m)
    runoff = (w_star - w_new) * RHO_WATER / dt
    return w_new, runoff
