"""Orographic gravity-wave drag (port of
``fv3net_tpu/physics/gravity_wave_drag.py``): a column-batched
linear-theory scheme of the McFarlane (1987) / Palmer et al. (1986)
family.

1. A reference-level wave stress launched by flow over subgrid
   orography of standard deviation ``sgh``,
   ``tau_0 = kappa_gwd * rho_ref * N_ref * U_ref * sgh_eff^2``, with
   ``sgh_eff`` capped so that the low-level Froude number N h / U <= Fc;
2. upward propagation with saturation: the stress carried at each level
   cannot exceed ``kappa_gwd * rho * U^3 / N``; the excess deposits as
   drag ``du/dt = -g d(tau)/dp`` against the reference-level wind;
3. the drag is projected onto the reference-level wind direction.

The upward sweep ``tau[k] = min(tau[k+1], tau_sat[k])`` from ``tau_0`` is
a running minimum, taken in one ``torch.cummin`` over the flipped levels.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fv3net_torch.core.constants import GRAVITY, KAPPA, RDGAS


@dataclasses.dataclass(frozen=True)
class GWDParams:
    kappa_gwd: float = 2.0e-5  # efficiency x inverse horizontal wavelength, 1/m
    froude_crit: float = 1.0  # cap on N sgh / U (blocked-flow limit)
    u_min: float = 1.0  # m/s floor on the reference wind
    n_min: float = 1.0e-4  # 1/s floor on buoyancy frequency
    # reference level: lowest model layers averaged over this sigma depth
    sigma_ref: float = 0.9


def _buoyancy_frequency(T, pmid, dz):
    """N^2 = (g/theta) dtheta/dz at layer midpoints (z-last, level 0 =
    top), one-sided at the top."""
    theta = T * (1.0e5 / pmid) ** KAPPA
    dth = theta[..., :-1] - theta[..., 1:]  # upper minus lower (z up)
    dzm = 0.5 * (dz[..., :-1] + dz[..., 1:])
    n2_int = GRAVITY / theta[..., 1:] * dth / torch.clamp(dzm, min=1.0)
    return torch.cat([n2_int[..., :1], n2_int], dim=-1)


def orographic_gwd(
    wind, T, delp, pmid, sgh, dt: float, params: GWDParams = GWDParams()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wind tendencies from subgrid mountain waves.

    z-last, level 0 = model top: wind [ncomp, ..., nz] in any fixed basis;
    T, delp, pmid [..., nz]; sgh [...] subgrid orography standard
    deviation (m).  Returns ``(dwind_dt [ncomp, ..., nz], tau_sfc)``, the
    second the launched stress (N/m^2).
    """
    rho = pmid / (RDGAS * T)
    dz = delp / (rho * GRAVITY)
    n2 = torch.clamp(_buoyancy_frequency(T, pmid, dz), min=params.n_min ** 2)
    N = torch.sqrt(n2)

    # reference level: mass-weighted average over the lowest layers
    ps = pmid[..., -1:]
    w_ref = torch.where(pmid > params.sigma_ref * ps, delp, 0.0)
    wsum = torch.clamp(w_ref.sum(dim=-1, keepdim=True), min=1.0)

    def refavg(x):
        return (x * w_ref).sum(dim=-1) / wsum[..., 0]

    wind_ref = torch.stack([refavg(wind[c]) for c in range(wind.shape[0])])
    U_ref = torch.clamp(torch.sqrt((wind_ref ** 2).sum(dim=0)),
                        min=params.u_min)
    N_ref = refavg(N)
    rho_ref = refavg(rho)

    # effective mountain height capped by the blocked-flow Froude limit
    h_eff = torch.minimum(sgh, params.froude_crit * U_ref / N_ref)
    tau0 = params.kappa_gwd * rho_ref * N_ref * U_ref * h_eff ** 2

    # wind component along the reference direction at every level
    e_ref = wind_ref / U_ref  # [ncomp, ...]
    u_par = (wind * e_ref[..., None]).sum(dim=0)

    # saturation stress per layer; a critical level where u_par <= 0
    u_pos = torch.clamp(u_par, min=0.0)
    tau_sat = params.kappa_gwd * rho * u_pos ** 3 / N

    # the surface-upward sweep: [tau0, tau(nz-1), ..., tau(0)] is the
    # running minimum of [tau0, sat(nz-1), ..., sat(0)]; each layer
    # deposits the stress from below less its own
    tau = torch.cummin(torch.cat([tau0[..., None], tau_sat.flip(-1)],
                                 dim=-1), dim=-1).values
    dep = (tau[..., :-1] - tau[..., 1:]).flip(-1)
    # stress carried through the model top deposits in the top layer
    dep = torch.cat([dep[..., :1] + tau[..., -1:], dep[..., 1:]], dim=-1)

    accel = GRAVITY * dep / delp  # m/s^2 along -e_ref
    # the parallel wind cannot reverse within one step
    accel = torch.minimum(accel, torch.clamp(u_par, min=0.0) / dt)
    return -accel[None] * e_ref[..., None], tau0
