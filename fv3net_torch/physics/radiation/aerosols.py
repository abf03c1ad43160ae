"""Climatological aerosol optics (port of
``fv3net_tpu/physics/radiation/aerosols.py``).

Each layer falls in one of five vertical domains (mixing layer, mineral
transport layer, free troposphere, stratosphere, upper stratosphere);
tropospheric layers mix up to six OPAC-style components, whose
hygroscopic optical properties are interpolated linearly over the
reference's eight relative-humidity classes; the per-band aggregation
follows the reference's radclimaer:

    ext = sum_c m_c ext_c         tau = ext * denn * dz[km]
    ssa = sum_c m_c ssa_c ext_c / ext
    asy = sum_c m_c asy_c sca_c / sca

``make_aerosol_tables`` (numpy) fabricates the documented-shape tables
exactly as the reference package does.  The RH-class interpolation is a
two-row gather-and-lerp here, where the TPU package built one-hot
weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from fv3net_torch.ops import zscan

# the reference's RH classes (radiation_aerosols.py:344)
RHLEV = np.array([0.0, 0.5, 0.7, 0.8, 0.9, 0.95, 0.98, 0.99])
NRH = len(RHLEV)

# component order: RH-independent first (reference NCM1 split)
COMPONENTS = ("inso", "soot", "minm", "waso", "ssam", "sscm")
N_RHI = 3  # inso, soot, minm
N_RHD = 3  # waso, ssam, sscm

# species AOD diagnostic slots (reference NSPC: dust, BC, OC, SU, SS)
SPECIES = ("dust", "black_carbon", "water_soluble", "sulfate", "sea_salt")
_COMP_SPECIES = {
    "inso": 0, "minm": 0, "soot": 1, "waso": 2, "ssam": 4, "sscm": 4,
}

# per-component optical character of the fabricated tables:
# (Angstrom exponent, ssa at 550 nm, asymmetry, hygroscopic-growth gamma)
_CHARACTER = {
    "inso": (0.25, 0.72, 0.80, 0.0),
    "soot": (1.20, 0.21, 0.50, 0.0),
    "minm": (0.30, 0.86, 0.78, 0.0),
    "waso": (1.50, 0.965, 0.63, 0.55),
    "ssam": (0.50, 1.00, 0.74, 0.65),
    "sscm": (0.05, 1.00, 0.82, 0.60),
}


def make_aerosol_tables(sw_lam_um: np.ndarray,
                        lw_lam_um: np.ndarray) -> Dict[str, np.ndarray]:
    """Fabricate reference-layout aerosol optical-property tables:
    extrhi/scarhi/ssarhi/asyrhi [N_RHI, nbands],
    extrhd/scarhd/ssarhd/asyrhd [NRH, N_RHD, nbands] and extstra [nbands];
    bands are SW then LW, ext normalized to 1 at 550 nm per dry
    component."""
    lam = np.concatenate([sw_lam_um, lw_lam_um])
    nb = lam.size

    def spectral(alpha):
        return (lam / 0.55) ** (-alpha)

    def ssa_of(lam_um, ssa550):
        # scattering efficiency collapses in the thermal IR
        roll = 1.0 / (1.0 + (lam_um / 3.0) ** 2)
        return np.clip(ssa550 * roll, 0.02, 1.0)

    extrhi = np.zeros((N_RHI, nb))
    scarhi = np.zeros((N_RHI, nb))
    ssarhi = np.zeros((N_RHI, nb))
    asyrhi = np.zeros((N_RHI, nb))
    for i, name in enumerate(COMPONENTS[:N_RHI]):
        alpha, ssa550, asy, _ = _CHARACTER[name]
        ext = spectral(alpha)
        ssa = ssa_of(lam, ssa550)
        extrhi[i] = ext
        ssarhi[i] = ssa
        scarhi[i] = ssa * ext
        asyrhi[i] = asy * np.clip(1.0 - 0.08 * np.log1p(lam / 0.55), 0.3, 1.0)

    extrhd = np.zeros((NRH, N_RHD, nb))
    scarhd = np.zeros((NRH, N_RHD, nb))
    ssarhd = np.zeros((NRH, N_RHD, nb))
    asyrhd = np.zeros((NRH, N_RHD, nb))
    for j, name in enumerate(COMPONENTS[N_RHI:]):
        alpha, ssa550, asy, gamma = _CHARACTER[name]
        for h, rh in enumerate(RHLEV):
            # hygroscopic growth (Kasten/Hanel form)
            grow = (1.0 - min(rh, 0.99)) ** (-gamma)
            alpha_eff = alpha / (1.0 + 0.5 * (grow - 1.0) / 6.0)
            ext = grow * spectral(alpha_eff)
            wet = 1.0 - 1.0 / grow  # 0 dry .. ->1 very wet
            ssa = ssa_of(lam, ssa550 * (1.0 - wet) + 1.0 * wet)
            extrhd[h, j] = ext
            ssarhd[h, j] = ssa
            scarhd[h, j] = ssa * ext
            asyrhd[h, j] = np.clip(
                (asy + 0.1 * wet)
                * np.clip(1.0 - 0.08 * np.log1p(lam / 0.55), 0.3, 1.0),
                0.0, 0.95,
            )

    # stratospheric background sulfate, per-km optical depth
    extstra = 4.0e-4 * spectral(1.0)
    return {
        "_sw_lam_um": np.asarray(sw_lam_um),
        "extrhi": extrhi, "scarhi": scarhi,
        "ssarhi": ssarhi, "asyrhi": asyrhi,
        "extrhd": extrhd, "scarhd": scarhd,
        "ssarhd": ssarhd, "asyrhd": asyrhd,
        "extstra": extstra,
    }


@dataclasses.dataclass(frozen=True)
class AerosolClimatology:
    """Analytic horizontal/vertical composition (the GOCART-map role)."""

    mixing_layer_km: float = 2.0  # domain-1 depth above the surface
    transport_top_km: float = 4.0  # domain-2 (mineral transport) top
    tropopause_hpa: float = 110.0  # domain 3 -> 4 switch
    upper_strat_hpa: float = 5.0  # domain 4 -> 5 switch
    denn_mixing: float = 0.14  # number-density scaling, mixing layer
    denn_transport: float = 0.08  # mineral transport layer


def component_mixing(land_frac, lat, month: float = 6.5) -> torch.Tensor:
    """Mixing-layer component fractions m_c [..., 6] (cmixg role), with
    the seasonal cycle of dust (local summer) and sea salt (winter)."""
    lat_deg = torch.rad2deg(lat)
    dust_belt = torch.exp(-(((lat_deg.abs() - 22.0) / 12.0) ** 2))
    season = math.cos(2.0 * math.pi * (month - 7.0) / 12.0)
    hemi = torch.tanh(lat_deg / 15.0)  # +1 NH, -1 SH
    summer = 1.0 + 0.5 * season * hemi
    winter = 1.0 - 0.35 * season * hemi
    pollution = 0.5 + 0.5 * torch.exp(-(((lat_deg - 30.0) / 25.0) ** 2))
    ocean = 1.0 - land_frac
    m = {
        "inso": land_frac * (0.06 + 0.10 * dust_belt * summer),
        "soot": 0.02 * pollution,
        "minm": land_frac * 0.55 * dust_belt * summer,
        "waso": 0.35 * pollution + 0.15 * land_frac,
        "ssam": ocean * 0.45 * winter,
        "sscm": ocean * 0.12 * winter,
    }
    return torch.stack([m[c] for c in COMPONENTS], dim=-1)


def _rh_weights(rh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RH class below each value and the linear weight of the class
    above it: (idx [...] long, frac [...]), in the input precision."""
    levs = torch.as_tensor(RHLEV, dtype=rh.dtype, device=rh.device)
    rhc = rh.clamp(0.0, float(RHLEV[-1]))
    idx = torch.searchsorted(levs, rhc.contiguous(), right=True) - 1
    idx = idx.clamp(0, NRH - 2)
    lo = levs[idx]
    hi = levs[idx + 1]
    return idx, (rhc - lo) / (hi - lo)


def setaer(plyr_hpa, delz_km, rh, land_frac, lat,
           tables: Dict[str, np.ndarray], nbands_sw: int,
           clim: AerosolClimatology = AerosolClimatology(),
           month: float = 6.5, storage=None):
    """Aerosol optical properties for every layer and band.

    Args ([C, L] surface-first like the RRTMG drivers, land_frac/lat
    [C]): layer pressure (hPa), geometric thickness (km), relative
    humidity (0-1).  Returns (aer_sw [C, L, nbands_sw, 3], aer_lw
    [C, L, nb_lw, 3], aerodp [C, len(SPECIES)+1]): the (tau, ssa, asy)
    triples and the per-species column AOD diagnostic.

    ``storage`` bfloat16 (the RRTMG bf16 storage mode): the tables, the
    mixing ratios, the RH weights and every [C, L, nb] plane are held
    and combined in bfloat16, as the reference does, so (tau, ssa, asy)
    come back in bfloat16; the column AOD sums are taken in float32."""
    dtype, dev = plyr_hpa.dtype, plyr_hpa.device
    st = storage or dtype
    acc = torch.float32 if st == torch.bfloat16 else st

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=dev).to(st)

    def k(x):
        """A constant of the formulas: in the stored dtype when there is
        one (the reference rounds its Python constants to it)."""
        return x if st == dtype else torch.tensor(x, dtype=st, device=dev)

    z_agl = zscan.cumsum(delz_km, axis=-1) - 0.5 * delz_km  # [C, L] km
    in_mix = z_agl <= clim.mixing_layer_km
    in_transport = (~in_mix) & (z_agl <= clim.transport_top_km)
    in_strat = plyr_hpa < clim.tropopause_hpa
    in_upper = plyr_hpa < clim.upper_strat_hpa
    in_freetrop = (~in_mix) & (~in_transport) & (~in_strat)
    in_strat = in_strat & (~in_upper)

    m_mix = component_mixing(land_frac, lat, month).to(st)  # [C, 6]
    idx, frac = _rh_weights(rh)
    # the lerp weights as the reference's weight matrix holds them
    w1 = frac.to(st)[..., None, None]
    w0 = 1.0 - w1

    extrhi, scarhi = t(tables["extrhi"]), t(tables["scarhi"])
    ssarhi, asyrhi = t(tables["ssarhi"]), t(tables["asyrhi"])

    def rh_interp(name):  # [NRH, 3, nb] -> [C, L, 3, nb]
        tab = t(tables[name])
        if st == dtype:
            f = frac[..., None, None]
            return tab[idx] * (1.0 - f) + tab[idx + 1] * f
        # the stored lerp: one rounding of the float32 sum
        return (tab[idx].to(acc) * w0.to(acc)
                + tab[idx + 1].to(acc) * w1.to(acc)).to(st)

    ext_d = rh_interp("extrhd")
    sca_d = rh_interp("scarhd")
    ssa_d = rh_interp("ssarhd")
    asy_d = rh_interp("asyrhd")

    def aggregate(m):  # m: [C, L, 6] -> per-band mixture
        mi, md = m[..., :N_RHI], m[..., N_RHI:]
        ext = mi @ extrhi + (md[..., None] * ext_d).sum(-2)
        sca = mi @ scarhi + (md[..., None] * sca_d).sum(-2)
        ssa_num = mi @ (ssarhi * extrhi) + (md[..., None] * ssa_d * ext_d
                                            ).sum(-2)
        asy_num = mi @ (asyrhi * scarhi) + (md[..., None] * asy_d * sca_d
                                            ).sum(-2)
        return ext, sca, ssa_num, asy_num

    # domain 1: mixing layer with the full composition
    m1 = m_mix[:, None, :].expand(rh.shape + (len(COMPONENTS),))
    ext1, sca1, ssa1n, asy1n = aggregate(m1)

    # domain 3: the reference's fixed WMO free-troposphere mix
    c3 = tuple(map(k, (0.17e-3, 0.4, 0.59983)))  # inso, soot, waso
    ext3 = c3[0] * extrhi[0] + c3[1] * extrhi[1] + c3[2] * ext_d[..., 0, :]
    sca3 = c3[0] * scarhi[0] + c3[1] * scarhi[1] + c3[2] * sca_d[..., 0, :]
    ssa3n = (c3[0] * ssarhi[0] * extrhi[0] + c3[1] * ssarhi[1] * extrhi[1]
             + c3[2] * (ssa_d * ext_d)[..., 0, :])
    asy3n = (c3[0] * asyrhi[0] * scarhi[0] + c3[1] * asyrhi[1] * scarhi[1]
             + c3[2] * (asy_d * sca_d)[..., 0, :])
    denn_ft = k(0.0078)  # calibrated: free-troposphere AOD ~ 0.01-0.02

    # domain 2: mineral transport (pure minm component)
    ext2 = extrhi[2][None, None]
    sca2 = scarhi[2][None, None]
    ssa2n = (ssarhi[2] * extrhi[2])[None, None]
    asy2n = (asyrhi[2] * scarhi[2])[None, None]
    m_minm = m_mix[:, None, 2:3]

    dz = delz_km[..., None].to(st)
    denn_mix, denn_tr = k(clim.denn_mixing), k(clim.denn_transport)
    tau1 = torch.where(in_mix[..., None], ext1 * denn_mix * dz, 0.0)
    tau2 = torch.where(in_transport[..., None],
                       ext2 * m_minm * denn_tr * dz, 0.0)
    tau3 = torch.where(in_freetrop[..., None], ext3 * denn_ft * dz, 0.0)
    extstra = t(tables["extstra"])
    tau4 = torch.where(in_strat[..., None], extstra[None, None] * dz, 0.0)
    tau = tau1 + tau2 + tau3 + tau4

    def ratio(n, d):
        return (n / d.clamp(min=1e-30)).clamp(0.0, 1.0)

    nb = tau.shape[-1]
    is_sw = (torch.arange(nb, device=dev) < nbands_sw).to(st)[None, None]
    ssa_dom4 = k(0.99) * is_sw + k(0.5) * (1.0 - is_sw)
    asy_dom4 = k(0.696) * is_sw + k(0.3) * (1.0 - is_sw)

    def sel(field1, field2, field3, field4):
        out = torch.where(in_mix[..., None], field1, field4)
        out = torch.where(in_transport[..., None], field2, out)
        return torch.where(in_freetrop[..., None], field3, out)

    ssa = sel(ratio(ssa1n, ext1), ratio(ssa2n, ext2), ratio(ssa3n, ext3),
              ssa_dom4)
    asy = sel(ratio(asy1n, sca1), ratio(asy2n, sca2), ratio(asy3n, sca3),
              asy_dom4)
    aer = torch.stack([tau, ssa.expand_as(tau), asy.expand_as(tau)], dim=-1)
    aer_sw = aer[:, :, :nbands_sw]
    aer_lw = aer[:, :, nbands_sw:]

    # per-species column AOD at the SW band nearest 550 nm
    b550 = (int(np.argmin(np.abs(np.asarray(tables["_sw_lam_um"]) - 0.55)))
            if "_sw_lam_um" in tables else 0)
    exts550 = torch.cat(
        [extrhi[:, b550].expand(rh.shape + (N_RHI,)), ext_d[..., b550]],
        dim=-1,
    )
    m3c = t([0.17e-3, 0.4, 0.0, 0.59983, 0.0, 0.0])
    coeff = (m1 * denn_mix * in_mix[..., None]
             + m3c * denn_ft * in_freetrop[..., None])
    col = (coeff * exts550 * dz).sum(dim=1, dtype=acc)  # [C, 6]
    spc = []
    for s in range(len(SPECIES)):
        tot = torch.zeros_like(col[..., 0])
        for ci, cname in enumerate(COMPONENTS):
            if _COMP_SPECIES[cname] == s:
                tot = tot + col[..., ci]
        spc.append(tot)
    # mineral transport counts as dust; stratosphere as sulfate
    spc[0] = spc[0] + tau2[..., b550].sum(dim=1, dtype=acc)
    spc[3] = spc[3] + tau4[..., b550].sum(dim=1, dtype=acc)
    total = tau[..., b550].sum(dim=1, dtype=acc)
    aerodp = torch.stack(spc + [total], dim=-1)
    return aer_sw, aer_lw, aerodp
