"""Linearized ozone photochemistry on tensors (port of
``fv3net_tpu/physics/ozone.py``): the prognostic o3mr tracer relaxes
toward the radiation package's climatological profile with a
pressure-dependent timescale, days in the mid-stratosphere and months in
the troposphere::

    d(o3)/dt = (o3_clim(p, lat) - o3) / tau(p)
    log tau linear in log p between (p_strat, tau_strat) and
    (p_trop, tau_trop)
"""
from __future__ import annotations

import dataclasses
import math

import torch

from fv3net_torch.physics.radiation import gases


@dataclasses.dataclass(frozen=True)
class OzoneParams:
    tau_strat_days: float = 5.0  # at/above p_strat
    tau_trop_days: float = 180.0  # at/below p_trop
    p_strat: float = 3000.0  # Pa (30 hPa)
    p_trop: float = 30000.0  # Pa (300 hPa)


def ozone_tendency(o3, pmid, lat,
                   params: OzoneParams = OzoneParams()) -> torch.Tensor:
    """d(o3)/dt [kg/kg/s] (z-last columns; lat [...] broadcast)."""
    clim = gases.ozone_profile(pmid, lat)
    frac = torch.clamp(
        (torch.log(pmid) - math.log(params.p_strat))
        / (math.log(params.p_trop) - math.log(params.p_strat)),
        0.0, 1.0,
    )
    log_tau = math.log(params.tau_strat_days) + frac * (
        math.log(params.tau_trop_days) - math.log(params.tau_strat_days))
    tau = torch.exp(log_tau) * 86400.0
    return (clim - o3) / tau
