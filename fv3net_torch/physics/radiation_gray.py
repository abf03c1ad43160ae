"""Gray-gas radiation, Frierson et al. (2006) style (port of
``fv3net_tpu/physics/radiation_gray.py``).

LW: two-stream gray gas with optical depth
tau = tau0(lat) * (f_l * sigma + (1 - f_l) * sigma^4).  SW: insolation
from cos-zenith, a uniform atmospheric absorption by mass, the rest to the
surface.  Arrays are (..., nz) columns, level 0 = top; the two LW sweeps
are Python loops over z.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from fv3net_torch.core.constants import (
    CP_AIR,
    GRAVITY,
    SOLAR_CONSTANT,
    STEFAN_BOLTZMANN,
)


@dataclasses.dataclass(frozen=True)
class GrayRadiationParams:
    tau_equator: float = 6.0
    tau_pole: float = 1.5
    linear_frac: float = 0.1  # f_l: linear-in-sigma fraction of tau
    sw_absorption: float = 0.1  # fraction of TOA SW absorbed by mass
    albedo: float = 0.27


def _lw_optical_depth(sigma_interface, lat, params):
    """tau at interfaces, (..., nz+1)."""
    tau0 = params.tau_equator + (params.tau_pole - params.tau_equator) * (
        torch.sin(lat) ** 2
    )
    s = sigma_interface
    return tau0[..., None] * (
        params.linear_frac * s + (1.0 - params.linear_frac) * s ** 4
    )


def gray_radiation(
    T, delp, t_surface, cos_zenith, lat,
    params: GrayRadiationParams = GrayRadiationParams(),
    albedo=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Radiative heating rate [K/s] and flux diagnostics (DSWRFtoa,
    DSWRFsfc, USWRFtoa, USWRFsfc, DLWRFsfc, ULWRFsfc, ULWRFtoa,
    net_surface_shortwave).  ``albedo``: optional per-point surface
    albedo overriding the scalar parameter."""
    ps = delp.sum(dim=-1, keepdim=True)
    pe_frac = torch.cat(
        [torch.zeros_like(delp[..., :1]), torch.cumsum(delp, dim=-1)],
        dim=-1,
    )
    sigma_if = pe_frac / ps
    tau = _lw_optical_depth(sigma_if, lat, params)
    dtau = tau[..., 1:] - tau[..., :-1]
    trans = torch.exp(-dtau)
    B = STEFAN_BOLTZMANN * T ** 4
    Bs = STEFAN_BOLTZMANN * t_surface ** 4
    nz = T.shape[-1]

    # downward: D_0 = 0 at TOA; D_{k+1} = D_k e^-dtau_k + B_k (1 - e^-dtau_k)
    D = [torch.zeros(T.shape[:-1], dtype=T.dtype, device=T.device)]
    for k in range(nz):
        tr = trans[..., k]
        D.append(D[-1] * tr + B[..., k] * (1.0 - tr))
    # upward from the surface emission
    U = [None] * (nz + 1)
    U[nz] = Bs
    for k in range(nz - 1, -1, -1):
        tr = trans[..., k]
        U[k] = U[k + 1] * tr + B[..., k] * (1.0 - tr)
    D_if = torch.stack(D, dim=-1)
    U_if = torch.stack(U, dim=-1)

    sw_toa = SOLAR_CONSTANT * torch.clamp(cos_zenith, min=0.0)
    absorbed = params.sw_absorption * sw_toa
    sw_sfc_down = sw_toa - absorbed
    alb = params.albedo if albedo is None else albedo
    sw_sfc_net = sw_sfc_down * (1.0 - alb)
    sw_heat = absorbed[..., None] * (delp / ps) * GRAVITY / (CP_AIR * delp)

    # LW heating: dT/dt = g/cp * d(U - D)/dp
    Fnet = U_if - D_if
    lw_heat = (GRAVITY / CP_AIR) * (Fnet[..., 1:] - Fnet[..., :-1]) / delp

    heating = lw_heat + sw_heat
    diags = {
        "DSWRFtoa": sw_toa,
        "DSWRFsfc": sw_sfc_down,
        "USWRFtoa": (sw_toa - absorbed) * alb,
        "USWRFsfc": sw_sfc_down * alb,
        "DLWRFsfc": D_if[..., -1],
        "ULWRFsfc": Bs,
        "ULWRFtoa": U_if[..., 0],
        "net_surface_shortwave": sw_sfc_net,
    }
    return heating, diags
