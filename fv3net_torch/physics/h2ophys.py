"""Stratospheric water-vapour photochemistry (methane oxidation) on
tensors (port of ``fv3net_tpu/physics/h2ophys.py``, the GFS ``h2o_phys``
role): specific humidity relaxes toward an equilibrium profile, ~3 ppmv
at the hygropause rising to ~6.5 ppmv near the stratopause, with a
timescale of months::

    dq/dt = (q_eq(p) - q) / tau        for p < p_bottom (stratosphere)

The troposphere is untouched.  It adds water by design; runs that assert
exact water closure keep it off (``stratospheric_h2o``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

# kg/kg per ppmv of H2O (Mw/Md * 1e-6)
_PPMV = 18.015 / 28.964 * 1e-6


@dataclasses.dataclass(frozen=True)
class H2OPhysParams:
    q_hygropause_ppmv: float = 3.0  # entry value at the cold point
    q_stratopause_ppmv: float = 6.5  # after full methane oxidation
    p_bottom: float = 10000.0  # Pa; no update below (troposphere)
    p_top_eq: float = 100.0  # Pa; q_eq saturates to the stratopause value
    tau_days: float = 100.0  # photochemical relaxation timescale


def h2o_tendency(q, pmid,
                 params: H2OPhysParams = H2OPhysParams()) -> torch.Tensor:
    """dq/dt [kg/kg/s] for z-last columns; zero below ``p_bottom``."""
    lo = math.log(params.p_bottom)
    hi = math.log(params.p_top_eq)
    # 0 at/below p_bottom -> 1 at/above p_top_eq (log-pressure ramp)
    frac = torch.clamp((lo - torch.log(pmid)) / (lo - hi), 0.0, 1.0)
    q_eq = (
        params.q_hygropause_ppmv
        + frac * (params.q_stratopause_ppmv - params.q_hygropause_ppmv)
    ) * _PPMV
    tau = params.tau_days * 86400.0
    in_strat = (pmid < params.p_bottom).to(q.dtype)
    return in_strat * (q_eq - q) / tau
