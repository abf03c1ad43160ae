"""Shortwave solver of the synthetic band model (port of
``fv3net_tpu/physics/radiation/sw.py``): delta-scaled two-stream with
PIFM coefficients in the Meador-Weaver solution and the adding method
over layers.

Per-g-point layer reflectances and transmittances are elementwise on
[nlay, ncol, ngpt] tensors; the direct beam is one cumulative sum; the
adding method is two loops over layers (bottom-up albedo and source
accumulation, top-down flux resolution; the reference's two scans).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fv3net_torch.core.constants import CP_AIR, GRAVITY


class SWFluxes(NamedTuple):
    up: torch.Tensor      # [ncol, nlev]
    dn: torch.Tensor      # [ncol, nlev] total (direct + diffuse)
    dn_dir: torch.Tensor  # [ncol, nlev] direct beam
    htr: torch.Tensor     # [ncol, nlay] K/s


def delta_scale(tau, ssa, g):
    """Delta-Eddington scaling of the forward peak (f = g^2)."""
    f = g * g
    wf = ssa * f
    tau_s = (1.0 - wf) * tau
    ssa_s = (ssa - wf) / (1.0 - wf).clamp(min=1e-12)
    g_s = (g - f) / (1.0 - f).clamp(min=1e-12)
    return tau_s, ssa_s, g_s


def two_stream(tau, ssa, g, mu0):
    """PIFM two-stream layer coefficients (Zdunkowski 1980 gammas in the
    Meador & Weaver 1980 solution).  Inputs broadcast together; mu0 > 0.
    Returns (rdif, tdif, rdir, tdir, t0): diffuse reflectance and
    transmittance, direct-to-diffuse upward and downward conversion, and
    the surviving direct-beam transmittance."""
    w = ssa.clamp(0.0, 1.0 - 1e-6)
    g1 = (8.0 - w * (5.0 + 3.0 * g)) * 0.25
    g2 = 3.0 * (w * (1.0 - g)) * 0.25
    g3 = (2.0 - 3.0 * mu0 * g) * 0.25
    g4 = 1.0 - g3

    k = torch.sqrt(((g1 - g2) * (g1 + g2)).clamp(min=1e-12))
    e1 = torch.exp(-(k * tau).clamp(max=80.0))
    e2 = e1 * e1
    rt = 1.0 / (k * (1.0 + e2) + g1 * (1.0 - e2))
    rdif = rt * g2 * (1.0 - e2)
    tdif = rt * 2.0 * k * e1

    t0 = torch.exp(-(tau / mu0).clamp(max=80.0))
    k_mu = k * mu0
    # resonance guard at k mu0 -> 1
    d = 1.0 - k_mu * k_mu
    d = torch.where(d.abs() < 1e-4,
                    torch.where(d < 0, -1e-4, 1e-4).to(d.dtype), d)
    rt_dir = w * rt / d
    a1 = g1 * g4 + g2 * g3
    a2 = g1 * g3 + g2 * g4
    rdir = rt_dir * (
        (1.0 - k_mu) * (a2 + k * g3)
        - (1.0 + k_mu) * (a2 - k * g3) * e2
        - 2.0 * (k * g3 - a2 * k_mu) * e1 * t0
    )
    tdir = -rt_dir * (
        (1.0 + k_mu) * (a1 + k * g4) * t0
        - (1.0 - k_mu) * (a1 - k * g4) * e2 * t0
        - 2.0 * (k * g4 + a1 * k_mu) * e1
    )
    # energy guards (the absorbed direct fraction stays non-negative)
    rdir = torch.minimum(rdir.clamp(min=0.0), 1.0 - t0)
    tdir = torch.minimum(tdir.clamp(min=0.0), 1.0 - t0 - rdir)
    return rdif, tdif, rdir, tdir, t0


def sw_transfer(tau, ssa, g, mu0, src_gpt, alb_dir, alb_dif, dp):
    """Shortwave fluxes for one sky condition.

    tau/ssa/g: [ncol, ngpt, nlay]; mu0: [ncol]; src_gpt: [ncol, ngpt]
    TOA beam irradiance per g-point (normal to the beam; the mu0 factor
    is applied here); alb_dir/alb_dif: [ncol, ngpt]; dp: [ncol, nlay].
    """
    daylit = mu0 > 1e-3
    mu = torch.where(daylit, mu0, 1.0)

    tau_s, ssa_s, g_s = delta_scale(tau.movedim(-1, 0), ssa.movedim(-1, 0),
                                    g.movedim(-1, 0))
    mu_l = mu[None, :, None]  # [1, ncol, 1]
    rdif, tdif, rdir, tdir, t0 = two_stream(tau_s, ssa_s, g_s, mu_l)

    # direct beam at levels [nlev, ncol, ngpt]
    path = torch.cumsum(tau_s / mu_l, dim=0)
    toa = mu0[:, None] * src_gpt  # flux on a horizontal surface
    dir_lev = torch.cat([torch.ones_like(path[:1]),
                         torch.exp(-path.clamp(max=80.0))], dim=0) * toa[None]
    dir_top = dir_lev[:-1]  # at the top of each layer

    src_up = rdir * dir_top
    src_dn = tdir * dir_top
    nlay = tau_s.shape[0]

    # bottom-up: the albedo and upward source below each level
    albedo = alb_dif.expand_as(src_gpt)
    src = alb_dir * dir_lev[-1]
    alb_below, src_below, denom = [None] * nlay, [None] * nlay, [None] * nlay
    for k in reversed(range(nlay)):
        alb_below[k], src_below[k] = albedo, src
        den = 1.0 / (1.0 - rdif[k] * albedo)
        denom[k] = den
        albedo, src = (rdif[k] + tdif[k] * tdif[k] * albedo * den,
                       src_up[k] + tdif[k] * den * (src + albedo * src_dn[k]))
    src_top = src

    # top-down: the diffuse fluxes
    f = torch.zeros_like(src_top)
    fdn_dif, fup = [f], [src_top]
    for k in range(nlay):
        f = (tdif[k] * f + rdif[k] * src_below[k] + src_dn[k]) * denom[k]
        fdn_dif.append(f)
        fup.append(alb_below[k] * f + src_below[k])
    fup = torch.stack(fup)
    fdn_dif = torch.stack(fdn_dif)

    day = daylit[:, None].to(tau.dtype)
    up_tot = fup.sum(-1).movedim(0, -1) * day
    dn_dir = dir_lev.sum(-1).movedim(0, -1) * day
    dn_tot = (fdn_dif + dir_lev).sum(-1).movedim(0, -1) * day
    net_dn = dn_tot - up_tot
    htr = (net_dn[..., :-1] - net_dn[..., 1:]) * GRAVITY / (CP_AIR * dp)
    return SWFluxes(up_tot, dn_tot, dn_dir, htr)
