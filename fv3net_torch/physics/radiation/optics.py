"""Optical properties of the radiation (port of
``fv3net_tpu/physics/radiation/optics.py``): the synthetic band model's
gas optical depth (one contraction over gases of closed-form
pressure/temperature scaled column paths), Rayleigh scattering, cloud
optics, McICA subcolumns and the boundary-layer aerosol, and the surface
albedo and emissivity that the RRTMG driver reads too.

Shapes: columns [ncol, nlay] in, [ncol, ngpt, nlay] out; level 0 = top.
Constants take the dtype of the inputs (float32 in the synthband driver,
as in the reference).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fv3net_torch.core.constants import GRAVITY
from fv3net_torch.physics.radiation import params as P
from fv3net_torch.physics.radiation import spectra


def _const(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=like.dtype,
                           device=like.device)


class GasOptics(NamedTuple):
    """Spectral data on the device (built once from a spectra.KDist)."""

    weight: torch.Tensor       # [ngas, ngpt] combined major+minor k map
    k_self_gpt: torch.Tensor   # [ngpt] h2o e-type continuum
    p_exp: torch.Tensor        # [ngas]
    t_coef: torch.Tensor       # [ngas]
    gwt: torch.Tensor          # [ngpt]
    band_of_gpt: torch.Tensor  # [ngpt] int64
    nbands: int


def build_gas_optics(kd: spectra.KDist, nbands: int, dtype=torch.float32,
                     device=None) -> GasOptics:
    ngpt = kd.kmaj.shape[0]
    weight = np.zeros((P.NGAS, ngpt))
    for g in range(ngpt):
        b = kd.band_of_gpt[g]
        weight[:, g] = kd.kminor[b]
        weight[kd.major_gas[g], g] += kd.kmaj[g]

    def t(x):
        # rounded to float32 first, as the reference stores them
        return torch.as_tensor(np.asarray(x, np.float32), device=device).to(
            dtype)

    return GasOptics(
        weight=t(weight),
        k_self_gpt=t(kd.k_self[kd.band_of_gpt]),
        p_exp=t(kd.p_exp),
        t_coef=t(kd.t_coef),
        gwt=t(kd.gwt),
        band_of_gpt=torch.as_tensor(kd.band_of_gpt.astype(np.int64),
                                    device=device),
        nbands=nbands,
    )


def gas_optical_depth(go: GasOptics, play, tlay, dp, mmr: dict):
    """tau [ncol, ngpt, nlay] from the layer state and the gases' mass
    mixing ratios (every gas of params.GASES; "h2o" is the specific
    humidity)."""
    u = torch.stack([mmr[g] for g in P.GASES], dim=-1) * (
        dp[..., None] / GRAVITY)  # [ncol, nlay, ngas] column mass paths
    scale = (play[..., None] / spectra.P_REF) ** go.p_exp * torch.exp(
        go.t_coef * (tlay[..., None] - spectra.T_REF))
    tau = torch.einsum("lzn,ng->lgz", u * scale, go.weight)
    # h2o e-type self continuum, scaled by the vapor pressure
    q = mmr["h2o"]
    e = q * play / (0.622 + 0.378 * q)  # Pa
    tau_self = ((u[..., 0] * e / 1000.0)[:, None, :]
                * go.k_self_gpt[None, :, None])
    return tau + tau_self


def rayleigh_tau(dp):
    """SW Rayleigh scattering tau [ncol, nbands_sw, nlay] (per-band
    Hansen-Travis column fit scaled by the layer's mass fraction)."""
    coeff = _const(np.float32(spectra.rayleigh_band_coeff()), dp)
    return coeff[None, :, None] * (dp[:, None, :] / 101325.0)


# ---------------------------------------------------------------- clouds
class CloudOptics(NamedTuple):
    tau_lw: torch.Tensor   # [ncol, nbands_lw, nlay] in-cloud absorption
    tau_sw: torch.Tensor   # [ncol, nbands_sw, nlay] in-cloud extinction
    ssa_sw: torch.Tensor   # [ncol, nbands_sw, nlay]
    asy_sw: torch.Tensor   # [ncol, nbands_sw, nlay]
    cldfrac: torch.Tensor  # [ncol, nlay]


# single-scattering co-albedo per SW band (NIR bands absorb, visible ~none)
_SW_LAM_UM = 1.0e4 / np.sqrt(P.WVN1_SW * P.WVN2_SW)
_LIQ_COALB = np.where(_SW_LAM_UM > 1.0, 6.0e-3, 1.0e-6).astype(np.float32)
_ICE_COALB = np.where(_SW_LAM_UM > 1.0, 1.2e-2, 2.0e-6).astype(np.float32)


def cloud_optics(lwp, iwp, re_liq, re_ice, cldfrac) -> CloudOptics:
    """In-cloud optical properties from water paths [g/m^2] and effective
    radii [um] (liquid: tau = 3/2 LWP/re after Hu & Stamnes 1993; ice
    after Ebert & Curry 1992 / Fu 1996 coefficient forms)."""
    tau_liq_sw = lwp * (0.02 + 1.5 / re_liq)
    tau_ice_sw = iwp * (0.003448 + 2.431 / re_ice)
    tau_liq_lw = lwp * 0.09
    tau_ice_lw = iwp * (0.002 + 1.2 / re_ice)
    ncol, nlay = lwp.shape
    tau_lw = (tau_liq_lw + tau_ice_lw)[:, None, :].expand(
        ncol, P.NBANDS_LW, nlay)
    tau_sw = (tau_liq_sw + tau_ice_sw)[:, None, :].expand(
        ncol, P.NBANDS_SW, nlay)
    coalb = (tau_liq_sw[:, None, :] * _const(_LIQ_COALB, lwp)[None, :, None]
             + tau_ice_sw[:, None, :] * _const(_ICE_COALB, lwp)[None, :, None])
    ssa_sw = 1.0 - coalb / tau_sw.clamp(min=1e-12)
    asy = ((tau_liq_sw[:, None, :] * 0.85 + tau_ice_sw[:, None, :] * 0.80)
           / tau_sw.clamp(min=1e-12))
    return CloudOptics(tau_lw, tau_sw, ssa_sw.clamp(0.0, 1.0),
                       asy.clamp(0.0, 1.0), cldfrac)


def mcica_subcolumns(cldfrac, u, iovr: int = 1):
    """Binary cloud mask [ncol, ngpt, nlay] from uniforms ``u`` [nlay,
    ncol, ngpt].

    ``iovr=1``: maximum-random overlap (the reference's default):
    adjacent cloudy layers share a deviate, layers separated by clear air
    draw anew.  ``iovr=0``: random overlap (a deviate per layer).  The
    overlap recursion runs down the column as a loop over layers."""
    cf = cldfrac.movedim(-1, 0)[:, :, None]  # [nlay, ncol, 1]
    if iovr == 0:
        return (u < cf).movedim(0, -1)
    x = u[0] * 0.0
    cf_prev = torch.zeros_like(cf[0])
    cloudy = []
    for k in range(u.shape[0]):
        x = torch.where(x > (1.0 - cf_prev), x, u[k] * (1.0 - cf_prev))
        cloudy.append(x > (1.0 - cf[k]))
        cf_prev = cf[k]
    return torch.stack(cloudy, dim=-1)  # [ncol, ngpt, nlay] bool


# --------------------------------------------------------------- aerosols
def aerosol_optics(play, dp, land_frac):
    """Boundary-layer aerosol: a land/ocean AOD with an Angstrom-law
    spectral slope.  Returns (tau, ssa, asy), each [ncol, nbands_sw,
    nlay]."""
    aod550 = 0.12 * land_frac + 0.06 * (1.0 - land_frac)  # [ncol]
    w = dp * (play > 7.0e4)
    w = w / w.sum(-1, keepdim=True).clamp(min=1.0)  # [ncol, nlay]
    spectral = _const(np.float32((_SW_LAM_UM / 0.55) ** -1.3), dp)
    tau = aod550[:, None, None] * spectral[None, :, None] * w[:, None, :]
    return tau, torch.full_like(tau, 0.95), torch.full_like(tau, 0.70)


# ---------------------------------------------------------------- surface
_SW_IS_VIS = (_SW_LAM_UM < 0.7).astype(np.float64)  # [nbands_sw]


def surface_albedo(cosz, land_frac, ice_frac=None):
    """Per-band direct/diffuse albedo [ncol, nbands_sw] (reference:
    radiation_sfc.py setalb; ocean direct albedo after Briegleb 1992,
    bare sea-ice albedos on the icy part of the ocean fraction)."""
    # float32 whatever cosz's dtype: the reference forms the band albedos
    # (0.18 * is_vis + ...) from a float32 mask, so float64 runs carry
    # float32-rounded constants there too
    is_vis = torch.as_tensor(_SW_IS_VIS, dtype=torch.float32,
                             device=cosz.device)
    mu = cosz.clamp(min=0.01)
    ocean_dir = 0.026 / (mu ** 1.7 + 0.065) + 0.15 * (mu - 0.1) * (
        mu - 0.5
    ) * (mu - 1.0)
    ocean_dif = torch.full_like(cosz, 0.06)
    land_alb = 0.18 * is_vis + 0.30 * (1.0 - is_vis)  # [nb]
    if ice_frac is not None:
        ice_alb = 0.73 * is_vis + 0.33 * (1.0 - is_vis)
        fi = ice_frac[:, None]
        sea_dir = fi * ice_alb[None, :] + (1.0 - fi) * ocean_dir[:, None]
        sea_dif = fi * ice_alb[None, :] + (1.0 - fi) * ocean_dif[:, None]
    else:
        sea_dir = ocean_dir[:, None]
        sea_dif = ocean_dif[:, None]
    dir_alb = (land_frac[:, None] * land_alb[None, :]
               + (1.0 - land_frac)[:, None] * sea_dir)
    dif_alb = (land_frac[:, None] * land_alb[None, :]
               + (1.0 - land_frac)[:, None] * sea_dif)
    return dir_alb.clamp(0.0, 1.0), dif_alb.clamp(0.0, 1.0)


def surface_emissivity(land_frac):
    """Broadband LW emissivity (radiation_sfc.py setemis)."""
    return 0.97 * land_frac + 0.984 * (1.0 - land_frac)
