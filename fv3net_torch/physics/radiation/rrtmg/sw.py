"""RRTMG-SW on tensors (port of ``fv3net_tpu/physics/radiation/rrtmg/sw.py``
on its k-table kernel route).

Algorithm: RRTMG-SW v5.1 as the reference package states it —
correlated-k gas optics over 112 g-points in 14 bands (16-29), Rayleigh
scattering, cloud and aerosol optical properties, McICA overlap, and the
delta-scaled PIFM two-stream with the vertical quadrature (vrtqdr).

Same structure as :mod:`.lw`: batched [C, L] (k=0 at the surface), the
troposphere split as a mask, every k-table fetch a weighted row selection
through :mod:`fv3net_torch.ops.ktable` (K3 for the species-interpolated
major-gas taus, K4 for the rest).  The two-stream properties of every
layer are evaluated at once and the two vrtqdr recurrences run as Python
loops over L, with direct exponentials (``fast_exp=True``) or the
reference's quantized exponential table (``fast_exp=False``).

``swrad(compress_daylight=True)`` solves only the daylit columns, packed
by a top-K of cosz, and expands the result back (:func:`daylight_k`).
``storage=torch.bfloat16`` is the reference's bf16 storage mode (see
:mod:`.lw`): bfloat16 selections, taug/taur and the upward pass's
partial reflectances stored in bfloat16, the rest in float32.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fv3net_torch.physics.radiation.rrtmg import lw as rlw
from fv3net_torch.physics.radiation.rrtmg import params as P

_OD_LO = 0.06
_EPS1 = 1.0e-8
_ZCRIT = 0.9999995
_NTBMX = 10000

_SPEC_LO = (0, 1, 2, 3, 5, 6, 8, 12)  # nspa=9 lower bands
_SINGLE_LO = (4, 7, 9, 11, 13)
_SPEC_HI = (1, 5, 12)  # nspb=5 upper bands
_SINGLE_HI = (0, 2, 3, 4, 6, 8, 11, 13)
_SELFFOR = (0, 1, 2, 3, 4, 5, 6, 7, 8, 13)  # bands with continuum tables


def prep_sw_tables(swdict: Dict, dtype=torch.float32, device=None,
                   nbase_hi: Optional[int] = None) -> Dict:
    """A reference-layout ``swdict`` (already rows-leading) as device
    tensors, plus the merged tables the selections read (``mtab_lo1``/
    ``mtab_hi1``, ``selfref_all``/``forref_all``, the K3 tables
    ``flat_lo``/``flat_hi``).  Scalars become Python floats and the
    per-band spectral weights floats rounded to ``dtype``.

    ``nbase_hi``: reachable upper-atmosphere row bound (lw.nbase_hi_for)
    of the upper base-row ids."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    rounded = np.float32 if dtype == torch.float32 else np.float64
    out: Dict = {"nbase_hi": int(nbase_hi) if nbase_hi else rlw.NBASE_HI}
    for key, val in swdict.items():
        if isinstance(val, dict):
            out[key] = {k: t(v) for k, v in val.items()}
        elif key in ("layreffr", "ix1", "ix2", "ibx"):
            out[key] = np.asarray(val, np.int64)  # static index data
        elif key in ("strrat", "specwt"):
            out[key] = [float(x) for x in np.asarray(val).astype(rounded)]
        elif np.ndim(val) == 0:
            out[key] = float(val)
        else:
            out[key] = t(val)
    raw = [{k: np.asarray(v, np.float64)
            for k, v in swdict[f"radsw_kgb{16 + b}"].items()}
           for b in range(P.NBANDS_SW)]
    nbh = out["nbase_hi"]
    out["mtab_lo1"] = t(np.concatenate(
        [rlw._reshape_base(raw[i]["absa"], 1, rlw.NBASE_LO)[:, 0]
         for i in _SINGLE_LO], axis=-1))
    out["mtab_hi1"] = t(np.concatenate(
        [rlw._reshape_base(raw[i]["absb"], 1, nbh)[:, 0]
         for i in _SINGLE_HI], axis=-1))
    out["flat_lo"] = {i: t(rlw._flat_tab(raw[i]["absa"], 9, rlw.NBASE_LO))
                      for i in _SPEC_LO}
    # the upper K3 tables keep all NBASE_HI rows; their ids stop at nbh-1
    out["flat_hi"] = {i: t(rlw._flat_tab(raw[i]["absb"], 5, rlw.NBASE_HI))
                      for i in _SPEC_HI}
    out["selfref_all"] = t(np.concatenate(
        [raw[i]["selfref"] for i in _SELFFOR], axis=-1))
    out["forref_all"] = t(np.concatenate(
        [raw[i]["forref"] for i in _SELFFOR], axis=-1))
    return out


# ------------------------------------------------------------------ setcoef
def setcoef_sw(pavel, tavel, h2ovmr, T):
    """SW interpolation coefficients (reference radsw_main.py:2692-2845;
    fp/ft are not clipped here, unlike the LW setcoef)."""
    preflog, tref = T["preflog"], T["tref"]
    dtype = tavel.dtype
    forfac = pavel * rlw._STPFAC / (tavel * (1.0 + h2ovmr))
    plog = torch.log(pavel)
    jp = torch.trunc(36.0 - 5.0 * (plog + 0.04)).clamp(1.0, 58.0).long() - 1
    fp = 5.0 * (preflog[jp] - plog)
    tem1 = (tavel - tref[jp]) / 15.0
    tem2 = (tavel - tref[jp + 1]) / 15.0
    jt = torch.trunc(3.0 + tem1).clamp(1.0, 4.0).long() - 1
    jt1 = torch.trunc(3.0 + tem2).clamp(1.0, 4.0).long() - 1
    ft = tem1 - (jt - 2).to(dtype)
    ft1 = tem2 - (jt1 - 2).to(dtype)
    fp1 = 1.0 - fp
    tropo = plog > 4.56
    temf = (332.0 - tavel) / 36.0
    indfor_lo = torch.trunc(temf).clamp(1.0, 2.0).long()
    forfrac_lo = temf - indfor_lo.to(dtype)
    tems = (tavel - 188.0) / 7.2
    indself_lo = (torch.trunc(tems) - 7.0).clamp(1.0, 9.0).long()
    selffrac_lo = tems - (indself_lo + 7).to(dtype)
    temf_hi = (tavel - 188.0) / 36.0
    return {
        "jp": jp + 1, "jt": jt + 1, "jt1": jt1 + 1,  # 1-based
        "fac00": fp1 * (1.0 - ft), "fac01": fp * (1.0 - ft1),
        "fac10": fp1 * ft, "fac11": fp * ft1,
        "selffac": torch.where(tropo, h2ovmr * forfac, 0.0),
        "selffrac": torch.where(tropo, selffrac_lo, 0.0),
        "indself": torch.where(tropo, indself_lo, 0),
        "forfac": forfac,
        "forfrac": torch.where(tropo, forfrac_lo, temf_hi - 1.0),
        "indfor": torch.where(tropo, indfor_lo, 3),
        "tropo": tropo,
    }


# ------------------------------------------------------------------ taumol
def _spec_factors(colA, colB, strrat):
    """2-species combination + lower (mult 8) / upper (mult 4) species
    stencil positions (reference radsw_bands.py taugb* semantics)."""
    speccomb = colA + strrat * colB
    ratio = (colA / speccomb).clamp(max=P.ONEMINUS)
    sm_lo = 8.0 * ratio
    sm_hi = 4.0 * ratio
    return (speccomb,
            (1 + sm_lo.long(), torch.remainder(sm_lo, 1.0)),
            (1 + sm_hi.long(), torch.remainder(sm_hi, 1.0)))


def _sfluxzen(c, colamt, T, impl=None):
    """Spectral solar source per g-point [C, ngptsw] (reference
    radsw_main.py:1398-1444)."""
    C, L = c["jp"].shape
    jp = c["jp"]  # 1-based
    laytrop = c["tropo"].sum(dim=1)  # [C]
    karange = torch.arange(L - 1, device=jp.device)
    pieces = []
    for b in range(P.NBANDS_SW):
        jb = 15 + b
        ng = P.NG_SW[b]
        ibd = int(T["ibx"][b]) - 1
        if jb in (15, 19, 22, 24, 25, 28, 26):
            flux = T["sfluxref01"][:ng, 0, ibd]
            if jb == 26:
                flux = T["scalekur"] * flux
            pieces.append(flux.expand(C, ng))
            continue
        layreffr = int(T["layreffr"][b])
        cond = (jp[:, :-1] < layreffr) & (jp[:, 1:] >= layreffr)
        if jb in (16, 27):  # search the upper atmosphere
            valid = cond & (karange[None] >= (laytrop[:, None] - 1))
            fallback = torch.full_like(laytrop, L - 1)
        else:  # search below laytrop: k in [0, laytrop-2]
            valid = cond & (karange[None] <= (laytrop[:, None] - 2))
            fallback = laytrop - 1
        first = torch.where(valid, karange[None], L).min(dim=1).values
        ks = torch.where(first < L, first + 1, fallback) % L
        colm1 = colamt[..., int(T["ix1"][b]) - 1].gather(1, ks[:, None])[:, 0]
        colm2 = colamt[..., int(T["ix2"][b]) - 1].gather(1, ks[:, None])[:, 0]
        speccomb = colm1 + T["strrat"][b] * colm2
        specmult = T["specwt"][b] * (colm1 / speccomb).clamp(max=P.ONEMINUS)
        js = specmult.long()  # 0-based row
        fs = torch.remainder(specmult, 1.0)
        tab = T["sfluxref02"] if jb in (16, 27) else T["sfluxref03"]
        tabT = tab[:ng, :, ibd].T  # [rows, ng]
        pieces.append(rlw._weighted_rows(
            tabT, [(js, 1.0 - fs), (js + 1, fs)], impl
        ))
    return torch.cat(pieces, dim=1)


def taumol_sw(c, colamt, colmol, T, impl=None, storage=None):
    """Gas + Rayleigh optical depths for all 112 g-points.  Returns
    (sfluxzen [C, G], taug [C, L, G], taur [C, L, G]), taug and taur in
    ``storage`` (None: the compute dtype).

    The SW species stencil is shared by the two pressure paths, so each
    species-interpolated band is one K3 call over the four base pairs:
    11 K3 calls (8 lower, 3 upper).  With ``storage`` bfloat16 every
    selection but the solar source's reads the bfloat16 tables."""
    B = [T[f"radsw_kgb{16 + b}"] for b in range(P.NBANDS_SW)]
    Ts = rlw.stored_tables(T, storage)
    strrat = T["strrat"]
    tropo = c["tropo"][..., None]
    h2o, co2, o3 = colamt[..., 0], colamt[..., 1], colamt[..., 2]
    ch4, o2 = colamt[..., 4], colamt[..., 5]
    taus, raylt = [], []
    jp, jt, jt1 = c["jp"], c["jt"], c["jt1"]
    lead = colmol.shape

    def combine(lower, upper):
        return torch.where(tropo, lower, upper)

    def ray_const(val, ng):
        return (colmol * val)[..., None].expand(lead + (ng,))

    def ray_vec(vec):
        return colmol[..., None] * vec

    base0 = (jp - 1) * 5 + (jt - 1)
    base1 = jp * 5 + (jt1 - 1)
    NBH = int(T["nbase_hi"])
    baseU0 = (jp - 13) * 5 + (jt - 1)
    baseU1 = (jp - 12) * 5 + (jt1 - 1)
    PBL = (rlw._base_pairs(base0, c["fac00"], c["fac10"], rlw.NBASE_LO)
           + rlw._base_pairs(base1, c["fac01"], c["fac11"], rlw.NBASE_LO))
    PBH = (rlw._base_pairs(baseU0, c["fac00"], c["fac10"], NBH)
           + rlw._base_pairs(baseU1, c["fac01"], c["fac11"], NBH))
    A1_lo = rlw._merged_single(Ts["mtab_lo1"], PBL, impl)
    A1_hi = rlw._merged_single(Ts["mtab_hi1"], PBH, impl)
    sl1 = rlw.g_offsets(_SINGLE_LO, P.NG_SW)
    sh1 = rlw.g_offsets(_SINGLE_HI, P.NG_SW)

    # water-vapour self/foreign continuum of all bands carrying the
    # tables, with the h2o column amount folded into the row weights
    # (radsw_bands.py:121-135)
    sfsl = rlw.g_offsets(_SELFFOR, P.NG_SW)
    h2o_col = c["colh2o"]
    inds = c["indself"] - 1
    indf = c["indfor"] - 1
    sfac, sfrac = c["selffac"], c["selffrac"]
    ffac, ffrac = c["forfac"], c["forfrac"]
    tauself_all = rlw._weighted_rows(
        Ts["selfref_all"],
        [(inds, h2o_col * (sfac * (1.0 - sfrac))),
         (inds + 1, h2o_col * (sfac * sfrac))], impl,
    )
    taufor_all = rlw._weighted_rows(
        Ts["forref_all"],
        [(indf, h2o_col * (ffac * (1.0 - ffrac))),
         (indf + 1, h2o_col * (ffac * ffrac))], impl,
    )

    def self_for(i):
        return tauself_all[..., sfsl[i]], taufor_all[..., sfsl[i]]

    def tau_spec_lo(i, sc, js, fs):
        return rlw._tau_spec(
            Ts["flat_lo"][i], 9, [(PBL, rlw._stencil2_terms(fs, js, 9), sc)],
            impl,
        )

    def tau_spec_hi(i, sc, js, fs):
        return rlw._tau_spec(
            Ts["flat_hi"][i], 5, [(PBH, rlw._stencil2_terms(fs, js, 5), sc)],
            impl,
        )

    def tau_single_lo(i, col):
        return col[..., None] * A1_lo[..., sl1[i]]

    def tau_single_hi(i, col):
        return col[..., None] * A1_hi[..., sh1[i]]

    # band 16: h2o+ch4 lower / ch4 upper
    sc, (js, fs), _ = _spec_factors(h2o, ch4, strrat[0])
    s, f = self_for(0)
    taus.append(combine(tau_spec_lo(0, sc, js, fs) + s + f,
                        tau_single_hi(0, ch4)))
    raylt.append(ray_const(B[0]["rayl"], P.NG_SW[0]))

    # band 17: h2o+co2 both (the foreign term is the same above)
    sc, (js, fs), (jsU, fsU) = _spec_factors(h2o, co2, strrat[1])
    s, f = self_for(1)
    taus.append(combine(tau_spec_lo(1, sc, js, fs) + s + f,
                        tau_spec_hi(1, sc, jsU, fsU) + f))
    raylt.append(ray_const(B[1]["rayl"], P.NG_SW[1]))

    # band 18: h2o+ch4 lower / ch4 upper
    sc, (js, fs), _ = _spec_factors(h2o, ch4, strrat[2])
    s, f = self_for(2)
    taus.append(combine(tau_spec_lo(2, sc, js, fs) + s + f,
                        tau_single_hi(2, ch4)))
    raylt.append(ray_const(B[2]["rayl"], P.NG_SW[2]))

    # band 19: h2o+co2 lower / co2 upper
    sc, (js, fs), _ = _spec_factors(h2o, co2, strrat[3])
    s, f = self_for(3)
    taus.append(combine(tau_spec_lo(3, sc, js, fs) + s + f,
                        tau_single_hi(3, co2)))
    raylt.append(ray_const(B[3]["rayl"], P.NG_SW[3]))

    # band 20: h2o both + ch4 cross section
    bt = B[4]
    s, f = self_for(4)
    ch4x = ch4[..., None] * bt["absch4"]
    taus.append(combine(tau_single_lo(4, h2o) + s + f + ch4x,
                        tau_single_hi(4, h2o) + f + ch4x))
    raylt.append(ray_const(bt["rayl"], P.NG_SW[4]))

    # band 21: h2o+co2 both
    sc, (js, fs), (jsU, fsU) = _spec_factors(h2o, co2, strrat[5])
    s, f = self_for(5)
    taus.append(combine(tau_spec_lo(5, sc, js, fs) + s + f,
                        tau_spec_hi(5, sc, jsU, fsU) + f))
    raylt.append(ray_const(B[5]["rayl"], P.NG_SW[5]))

    # band 22: h2o+o2 lower / o2 upper
    o2adj = 1.6
    o2tem = 4.35e-4 / (350.0 * 2.0)
    o2cont = (o2tem * o2)[..., None]
    sc, (js, fs), _ = _spec_factors(h2o, o2, strrat[6])
    s, f = self_for(6)
    taus.append(combine(tau_spec_lo(6, sc, js, fs) + s + f + o2cont,
                        o2adj * tau_single_hi(6, o2) + o2cont))
    raylt.append(ray_const(B[6]["rayl"], P.NG_SW[6]))

    # band 23: h2o lower / nothing upper
    bt = B[7]
    s, f = self_for(7)
    lower = bt["givfac"] * tau_single_lo(7, h2o) + s + f
    taus.append(combine(lower, torch.zeros_like(lower)))
    raylt.append(ray_vec(bt["rayl"]))

    # band 24: h2o+o2 lower / o2 upper (+o3 cross sections, species
    # rayleigh)
    bt = B[8]
    sc, (js, fs), _ = _spec_factors(h2o, o2, strrat[8])
    s, f = self_for(8)
    taus.append(combine(
        tau_spec_lo(8, sc, js, fs) + o3[..., None] * bt["abso3a"] + s + f,
        tau_single_hi(8, o2) + o3[..., None] * bt["abso3b"],
    ))
    # rayleigh: the lower atmosphere interpolates over the species
    ra = Ts["radsw_kgb24"]["rayla"].T  # [9, ng]
    js0 = (js - 1).clamp(0, ra.shape[0] - 2)
    ray_lo = colmol[..., None] * rlw._lerp_taken(ra, js0, fs, impl)
    raylt.append(combine(ray_lo, ray_vec(bt["raylb"])))

    # band 25: h2o lower / nothing; o3 both
    bt = B[9]
    taus.append(combine(
        tau_single_lo(9, h2o) + o3[..., None] * bt["abso3a"],
        o3[..., None] * bt["abso3b"],
    ))
    raylt.append(ray_vec(bt["rayl"]))

    # band 26: rayleigh only
    taus.append(torch.zeros(lead + (P.NG_SW[10],), dtype=colmol.dtype,
                            device=colmol.device))
    raylt.append(ray_vec(B[10]["rayl"]))

    # band 27: o3 both
    taus.append(combine(tau_single_lo(11, o3), tau_single_hi(11, o3)))
    raylt.append(ray_vec(B[11]["rayl"]))

    # band 28: o3+o2 both
    sc, (js, fs), (jsU, fsU) = _spec_factors(o3, o2, strrat[12])
    taus.append(combine(tau_spec_lo(12, sc, js, fs),
                        tau_spec_hi(12, sc, jsU, fsU)))
    raylt.append(ray_const(B[12]["rayl"], P.NG_SW[12]))

    # band 29: h2o lower (+co2 x-sec) / co2 upper (+h2o x-sec)
    bt = B[13]
    s, f = self_for(13)
    taus.append(combine(
        tau_single_lo(13, h2o) + s + f + co2[..., None] * bt["absco2"],
        tau_single_hi(13, co2) + h2o[..., None] * bt["absh2o"],
    ))
    raylt.append(ray_const(bt["rayl"], P.NG_SW[13]))

    st = storage or colmol.dtype
    taug = torch.cat([t.to(st) for t in taus], dim=-1)
    taur = torch.cat([r.to(st) for r in raylt], dim=-1)
    return _sfluxzen(c, colamt, T, impl), taug, taur


# ------------------------------------------------------------------ clouds
def cldprop_sw(cfrac, cliqp, reliq, cicep, reice, cdat1, cdat2, cdat3,
               cdat4, rand, T, iovrsw: int = 1, iswcliq: int = 1,
               iswcice: int = 3, impl=None, storage=None):
    """Band cloud optical properties + McICA masks (reference
    radsw_main.py:842-1180).  Returns (cldfmc [C, L, ngpt] int8, taucw,
    ssacw, asycw [C, L, nbdsw]).  With ``storage`` bfloat16 the optics
    lerps read the bfloat16 tables."""
    dtype = cfrac.dtype
    Ts = rlw.stored_tables(T, storage)
    cloudy = cfrac > P.FTINY
    dgesnw = 1.0315 * cdat4
    tauran = cdat1 * T["a0r"]
    tausnw = torch.where(
        (cdat3 > 0.0) & (cdat4 > 10.0),
        cdat3 * 1.09087 * (T["a0s"] + T["a1s"] / dgesnw.clamp(min=1e-12)),
        0.0,
    )
    ssaran = tauran[..., None] * (1.0 - T["b0r"])
    ssasnw = tausnw[..., None] * (
        1.0 - (T["b0s"] + T["b1s"] * dgesnw[..., None])
    )
    asyran = ssaran * T["c0r"]
    asysnw = ssasnw * T["c0s"]

    def optics(tab3, index, fint, path):
        """(tau, ssa*tau, asy*ssa*tau) of one condensate from the
        ext|ssa|asy table, lerped with one selection."""
        nb = tab3.shape[-1] // 3
        v = rlw._lerp_rows(tab3, index, fint, impl)
        ext = v[..., :nb].clamp(min=0.0)
        ssa = v[..., nb:2 * nb].clamp(0.0, 1.0)
        asy = v[..., 2 * nb:].clamp(0.0, 1.0)
        tau = path[..., None] * ext
        ssat = tau * ssa
        asyt = ssat * asy
        has = (path > 0.0)[..., None]
        return tuple(torch.where(has, x, 0.0) for x in (tau, ssat, asyt))

    factor = reliq - 1.5
    index = torch.trunc(factor).clamp(1.0, 57.0).long() - 1
    fint = factor - (index + 1).to(dtype)
    liq = "2" if iswcliq == 2 else "1"
    tab = torch.cat([Ts[f"extliq{liq}"], Ts[f"ssaliq{liq}"],
                     Ts[f"asyliq{liq}"]], dim=-1)
    tauliq, ssaliq, asyliq = optics(tab, index, fint, cliqp)

    # ice (Fu 1998, iswcice=3)
    dgeice = (1.0315 * reice).clamp(5.0, 140.0)
    factor = (dgeice - 2.0) / 3.0
    index = torch.trunc(factor).clamp(1.0, 45.0).long() - 1
    fint = factor - (index + 1).to(dtype)
    tab = torch.cat([Ts["extice3"], Ts["ssaice3"], Ts["asyice3"]], dim=-1)
    tauice, ssaice, asyice = optics(tab, index, fint, cicep)

    mask = cloudy[..., None]
    taucw = torch.where(mask, tauliq + tauice + (tauran + tausnw)[..., None],
                        0.0)
    ssacw = torch.where(mask, ssaliq + ssaice + ssaran + ssasnw, 0.0)
    asycw = torch.where(mask, asyliq + asyice + asyran + asysnw, 0.0)
    cldf = torch.where(cfrac < P.FTINY, 0.0, cfrac)
    return rlw.mcica_walk(rand, cldf, P.NGPT_SW, iovrsw), taucw, ssacw, asycw


# ------------------------------------------------------------------ spcvrtm
def exp_table(dtype, device=None) -> torch.Tensor:
    """The reference's quantized exp(-tau) table [_NTBMX + 1] (its
    ``_exp_tbl``)."""
    i = np.arange(_NTBMX + 1, dtype=np.float64)
    tfn = np.where(i < _NTBMX, i / np.maximum(_NTBMX - i, 1), 0.0)
    tbl = np.exp(-P.BPADE * tfn)
    tbl[_NTBMX] = 1.0e-20
    return torch.as_tensor(tbl, dtype=dtype, device=device)


def _lut(x, exp_tbl=None):
    """exp(-x) with the reference's small-depth series, the rest direct
    (``exp_tbl`` None) or from the quantized table."""
    x = x.clamp(max=500.0)
    if exp_tbl is None:
        big = torch.exp(-x)
    else:
        itind = torch.trunc(x / (P.BPADE + x) * _NTBMX + 0.5).clamp(
            0, _NTBMX).long()
        big = exp_tbl[itind]
    return torch.where(x <= _OD_LO, 1.0 - x + 0.5 * x * x, big)


def _nonzero(x):
    """x with values below the smallest normal number replaced by 1e-30,
    before a reciprocal.  float32 only: exp(-x) goes subnormal past
    x ~ 87 and 0 past ~104, and 1/x would overflow to inf in the
    unused-but-computed branch.  The reference's XLA flushes subnormals
    to zero and then takes 1e-30; PyTorch keeps them, so they are cut
    here.  float64 values stay above ~7e-218 and are untouched."""
    return torch.where(x < torch.finfo(x.dtype).tiny, 1e-30, x)


def _twostream(ztau0, zssa0, zasy0, cosz, sntz, iswmode=2, exp_tbl=None):
    """Delta-scaled two-stream layer reflectance/transmittance (reference
    radsw_main.py:279-424), elementwise over broadcastable inputs; the
    exponentials direct, or from ``exp_tbl`` (:func:`exp_table`).
    Returns (zrefb, zrefd, ztrab, ztrad, zexp3 scaled-beam-T, zexp4
    unscaled-beam-T)."""
    ztau0 = ztau0.clamp(min=P.FTINY)
    zssaw = (zssa0 / ztau0).clamp(max=P.ONEMINUS)
    zasyw = zasy0 / zssa0.clamp(min=P.FTINY)

    za1 = zasyw * zasyw
    za2 = zssaw * za1
    ztau1 = (1.0 - za2) * ztau0
    zssa1 = (zssaw - za2) / (1.0 - za2)
    zasy1 = zasyw / (1.0 + zasyw)
    zasy3 = 0.75 * zasy1

    if iswmode == 1:
        zgam1 = 1.75 - zssa1 * (1.0 + zasy3)
        zgam2 = -0.25 + zssa1 * (1.0 - zasy3)
        zgam3 = 0.5 - zasy3 * cosz
    elif iswmode == 2:  # pifm
        zgam1 = 2.0 - zssa1 * (1.25 + zasy3)
        zgam2 = 0.75 * zssa1 * (1.0 - zasy1)
        zgam3 = 0.5 - zasy3 * cosz
    else:  # discrete ordinates
        zsr3 = np.sqrt(3.0)
        zgam1 = zsr3 * (2.0 - zssa1 * (1.0 + zasy1)) * 0.5
        zgam2 = zsr3 * zssa1 * (1.0 - zasy1) * 0.5
        zgam3 = (1.0 - zsr3 * zasy1 * cosz) * 0.5
    zgam4 = 1.0 - zgam3

    # conservative-scattering branch
    za1c = zgam1 * cosz - zgam3
    za2c = zgam1 * ztau1
    zb2 = _lut(ztau1 * sntz, exp_tbl)
    zrefb_c = ((za2c - za1c * (1.0 - zb2)) / (1.0 + za2c)).clamp(0.0, 1.0)
    ztrab_c = (1.0 - zrefb_c).clamp(0.0, 1.0)
    zrefd_c = (za2c / (1.0 + za2c)).clamp(0.0, 1.0)
    ztrad_c = (1.0 - zrefd_c).clamp(0.0, 1.0)

    # non-conservative branch
    za1n = zgam1 * zgam4 + zgam2 * zgam3
    za2n = zgam1 * zgam3 + zgam2 * zgam4
    zrk = torch.sqrt(((zgam1 - zgam2) * (zgam1 + zgam2)).clamp(min=1e-30))
    zrk2 = 2.0 * zrk
    zrp = zrk * cosz
    zrp1 = 1.0 + zrp
    zrm1 = 1.0 - zrp
    zrpp1 = 1.0 - zrp * zrp
    zrpp = torch.copysign(zrpp1.abs().clamp(min=P.FLIMIT), zrpp1)
    zrkg1 = zrk + zgam1
    zrkg3 = zrk * zgam3
    zrkg4 = zrk * zgam4
    zr1 = zrm1 * (za2n + zrkg3)
    zr2 = zrp1 * (za2n - zrkg3)
    zr3 = zrk2 * (zgam3 - za2n * cosz)
    zr4 = zrpp * zrkg1
    zr5 = zrpp * (zrk - zgam1)
    zt1 = zrp1 * (za1n + zrkg4)
    zt2 = zrm1 * (za1n - zrkg4)
    zt3 = zrk2 * (zgam4 + za1n * cosz)

    zexm1 = _nonzero(_lut(zrk * ztau1, exp_tbl))
    zexp1 = 1.0 / zexm1
    zexm2 = _nonzero(_lut(ztau1 * sntz, exp_tbl))
    zexp2 = 1.0 / zexm2
    ze1r45 = zr4 * zexp1 + zr5 * zexm1
    degenerate = (ze1r45 >= -_EPS1) & (ze1r45 <= _EPS1)
    ze1r45_safe = torch.where(degenerate, 1.0, ze1r45)
    zden1 = zssa1 / ze1r45_safe
    zrefb_n = torch.where(
        degenerate, _EPS1,
        ((zr1 * zexp1 - zr2 * zexm1 - zr3 * zexm2) * zden1).clamp(0.0, 1.0),
    )
    ztrab_n = torch.where(
        degenerate, zexm2,
        (zexm2 * (1.0 - (zt1 * zexp1 - zt2 * zexm1 - zt3 * zexp2) * zden1)
         ).clamp(0.0, 1.0),
    )
    zdend = zr4 / (ze1r45_safe * zrkg1)
    zrefd_n = (zgam2 * (zexp1 - zexm1) * zdend).clamp(0.0, 1.0)
    ztrad_n = (zrk2 * zdend).clamp(0.0, 1.0)

    conserv = zssaw >= _ZCRIT
    zrefb = torch.where(conserv, zrefb_c, zrefb_n)
    zrefd = torch.where(conserv, zrefd_c, zrefd_n)
    ztrab = torch.where(conserv, ztrab_c, ztrab_n)
    ztrad = torch.where(conserv, ztrad_c, ztrad_n)
    zexp3 = _lut(ztau1 * sntz, exp_tbl)  # scaled direct-beam transmittance
    zexp4 = _lut(ztau0 * sntz, exp_tbl)  # unscaled
    return zrefb, zrefd, ztrab, ztrad, zexp3, zexp4


def _recip(d):
    # float32 only: totally reflective stacks can round 1 - r*r' to 0
    return 1.0 / torch.where(d == 0.0, 1e-30, d)


def spcvrtm_sw(ssolar, cosz, albbm, albdf, sfluxzen, cldfmc, taug, taur,
               tauae, ssaae, asyae, taucw, ssacw, asycw, iswmode=2,
               fast_exp: bool = True, storage=None):
    """McICA two-stream solver over all g-points (reference
    radsw_main.py:86-753), batched [C, L, G].

    ssolar/cosz [C]; albbm/albdf [C, 2]; sfluxzen [C, G]; aerosol and
    cloud properties [C, L, nbdsw].  Returns a dict of fluxes.  The
    upward pass accumulates the partial reflectances level by level, the
    downward pass the transmittances and the per-level flux sums, both
    as loops over L; the unified top step with carry (1, 0, 1) matches
    the reference's explicit TOA initialization.  ``fast_exp=False``
    takes the exponentials from the quantized table.  taug/taur may be
    stored in bfloat16 (the solve runs in float32 then); with ``storage``
    bfloat16 the partial reflectances the downward pass reads are
    rounded to it, as the reference stores them (the recurrence itself
    carries float32)."""
    taug, taur, tauae, ssaae, asyae = map(rlw._upcast, (taug, taur, tauae,
                                                     ssaae, asyae))
    dtype = taug.dtype
    C, L, G = taug.shape
    dev = taug.device
    ngb = torch.as_tensor(P.NGB_SW, device=dev)
    idxsfc = np.asarray(P.IDXSFC_SW)
    sntz = (1.0 / cosz)[:, None, None]
    coszb = cosz[:, None, None]

    def bexp(x):  # [..., nbdsw] -> [..., G]
        return x.index_select(-1, ngb)

    # surface albedo per g (idxsfc: 1 nir, 2 uv/vis, 0 half-half)
    bm, df = [], []
    for b in range(P.NBANDS_SW):
        i = idxsfc[b] - 1
        if i >= 0:
            bm.append(albbm[:, i])
            df.append(albdf[:, i])
        else:
            bm.append(0.5 * (albbm[:, 0] + albbm[:, 1]))
            df.append(0.5 * (albdf[:, 0] + albdf[:, 1]))
    alb_bm_g = bexp(torch.stack(bm, 1))
    alb_df_g = bexp(torch.stack(df, 1))

    zsolar = ssolar[:, None] * sfluxzen  # [C, G]

    # clear-sky and total-sky two-stream properties of every layer
    cldf = cldfmc.to(dtype)
    taua_g, ssaa_g, asya_g = bexp(tauae), bexp(ssaae), bexp(asyae)
    ztau0 = (taur + taug + taua_g).clamp(min=P.FTINY)
    zssa0 = taur + taua_g * ssaa_g
    zasy0 = asya_g * ssaa_g * taua_g
    exp_tbl = None if fast_exp else exp_table(dtype, dev)
    clr = _twostream(ztau0, zssa0, zasy0, coszb, sntz, iswmode, exp_tbl)
    tot = _twostream(ztau0 + bexp(taucw), zssa0 + bexp(ssacw),
                     zasy0 + bexp(asycw), coszb, sntz, iswmode, exp_tbl)
    cloudy = cldf > P.FTINY
    tot = tuple(torch.where(cloudy, t, c_) for t, c_ in zip(tot, clr))
    del cldf, cloudy

    # ---- upward pass: partial reflectances at levels 1..L -----------
    def up_step(rupb, rupd, q, k):
        refb, refd, trab, trad, exp3 = (x[:, k] for x in q[:5])
        zden1 = _recip(1.0 - rupd * refd)
        nb = refb + (trad * ((trab - exp3) * rupd + exp3 * rupb)) * zden1
        nd = refd + trad * trad * rupd * zden1
        return nb, nd

    rup_c = [(alb_bm_g, alb_df_g)]  # level j: (rupb, rupd), clear
    rup_t = [(alb_bm_g, alb_df_g)]  # total sky
    for k in range(L):
        rup_c.append(up_step(*rup_c[-1], clr, k))
        rup_t.append(up_step(*rup_t[-1], tot, k))

    def stored(pair):  # the levels 0..L-1 the downward pass reads
        return pair if storage is None else tuple(
            x.to(storage).to(dtype) for x in pair)

    # ---- downward pass, j = L-1 .. 0 ---------------------------------
    def down_step(tdn, rdnd, tdbt, tdbt0, q, j):
        refb, refd, trab, trad, exp3, exp4 = (x[:, j] for x in q)
        zden1 = _recip(1.0 - refd * rdnd)
        tdn_new = tdbt * trab + (
            trad * ((tdn - tdbt) + tdbt * refb * rdnd)
        ) * zden1
        rdnd_new = refd + trad * trad * rdnd * zden1
        return tdn_new, rdnd_new, tdbt * exp3, tdbt0 * exp4

    def combine(tdn, rdnd, tdbt, rupb_j, rupd_j):
        zden1 = _recip(1.0 - rdnd * rupd_j)
        zfu = (tdbt * rupb_j + (tdn - tdbt) * rupd_j) * zden1
        zfd = tdbt + (tdn - tdbt + tdbt * rupb_j * rdnd) * zden1
        return zfu, zfd

    ones = torch.ones((C, G), dtype=dtype, device=dev)
    zeros = torch.zeros((C, G), dtype=dtype, device=dev)
    car_c = (ones, zeros, ones, ones)
    car_t = (ones, zeros, ones, ones)
    fu0 = [None] * L
    fd0 = [None] * L
    fuc = [None] * L
    fdc = [None] * L
    for j in range(L - 1, -1, -1):
        car_c = down_step(*car_c, clr, j)
        car_t = down_step(*car_t, tot, j)
        zfu_c, zfd_c = combine(*car_c[:3], *stored(rup_c[j]))
        zfu_t, zfd_t = combine(*car_t[:3], *stored(rup_t[j]))
        fu0[j] = (zfu_c * zsolar).sum(-1)
        fd0[j] = (zfd_c * zsolar).sum(-1)
        fuc[j] = (zfu_t * zsolar).sum(-1)
        fdc[j] = (zfd_t * zsolar).sum(-1)

    # TOA (level L): zfu = zrupb_L, zfd = 1 exactly (reference boundary)
    fd_top = zsolar.sum(-1)
    flxu0 = torch.stack(fu0 + [(rup_c[L][0] * zsolar).sum(-1)], dim=1)
    flxd0 = torch.stack(fd0 + [fd_top], dim=1)
    flxuc = torch.stack(fuc + [(rup_t[L][0] * zsolar).sum(-1)], dim=1)
    flxdc = torch.stack(fdc + [fd_top], dim=1)

    # per-g surface down-fluxes for the spectral decompositions
    tdn_c0, rdnd_c0, tdbt_c0, ztdbt0_c = car_c
    tdn_t0, rdnd_t0, tdbt_t0, ztdbt0_t = car_t
    zfd0_sfc = combine(tdn_c0, rdnd_c0, tdbt_c0, alb_bm_g, alb_df_g)[1]
    zfdc_sfc = combine(tdn_t0, rdnd_t0, tdbt_t0, alb_bm_g, alb_df_g)[1]

    sfc_group = idxsfc[np.asarray(P.NGB_SW)]  # per g: 1, 2, or 0

    def gvec(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    w_nir = gvec(np.where(sfc_group == 1, 1.0,
                          np.where(sfc_group == 0, 0.5, 0.0)))
    w_vis = gvec(np.where(sfc_group == 2, 1.0,
                          np.where(sfc_group == 0, 0.5, 0.0)))

    def split(x):
        return torch.stack([(x * w_nir).sum(-1), (x * w_vis).sum(-1)], dim=-1)

    uvb_mask = gvec((np.asarray(P.NGB_SW) == (P.NUVB_SW - P.NBLOW))
                    .astype(np.float64))
    return {
        "flxuc": flxuc, "flxdc": flxdc, "flxu0": flxu0, "flxd0": flxd0,
        "ftoauc": flxuc[:, -1], "ftoau0": flxu0[:, -1],
        "ftoadc": flxd0[:, -1],
        "fsfcuc": flxuc[:, 0], "fsfcu0": flxu0[:, 0],
        "fsfcdc": flxdc[:, 0], "fsfcd0": flxd0[:, 0],
        "sfbmc": split(zsolar * ztdbt0_t),
        "sfdfc": split(zsolar * (zfdc_sfc - ztdbt0_t)),
        "sfbm0": split(zsolar * ztdbt0_c),
        "sfdf0": split(zsolar * (zfd0_sfc - ztdbt0_c)),
        "suvbfc": (zfdc_sfc * zsolar * uvb_mask).sum(-1),
        "suvbf0": (zfd0_sfc * zsolar * uvb_mask).sum(-1),
    }


# ------------------------------------------------------------------ swrad
def daylight_k(ncol: int) -> int:
    """The reference's daylit-column budget (its ``_daylight_k``): 9/16
    of the columns, rounded up to a multiple of 8 (half the sphere is
    lit, plus a margin at the terminator)."""
    k = -(-ncol * 9 // 16)
    return min(ncol, -(-k // 8) * 8)


def swrad(plyr, plvl, tlyr, tlvl, qlyr, olyr, gasvmr, clouds, aerosols,
          sfcalb, delpin, cosz, solcon, rand2d, T, iovrsw: int = 1,
          iswrgas: int = 1, iswcliq: int = 1, iswmode: int = 2,
          fast_exp: bool = True, compress_daylight=False,
          impl=None, storage=None) -> Dict[str, torch.Tensor]:
    """Batched SW driver (reference radsw_main.py:1981-2690 semantics).

    Layer arrays [C, L], k=0 at the surface; sfcalb [C, 4] = (nir-beam,
    nir-diff, uvvis-beam, uvvis-diff); gasvmr [C, L, 10]; clouds
    [C, L, 9]; aerosols [C, L, nbdsw, 3]; cosz [C] (columns with
    cosz <= 1e-4 get zero fluxes); rand2d [C, ngptsw*nlay].

    ``compress_daylight``: solve only the K columns of largest cosz (an
    argsort and a row gather) and expand the result back, the others
    taking the zero fluxes of the night mask (K = :func:`daylight_k`, or
    more when more columns are lit: the reference's fixed K would zero
    the lit columns past it).  Every column's arithmetic is its own, so
    the solved columns agree with the full-width call.  None is the
    reference's auto: on for a CUDA tensor (one device), off on the CPU.
    ``fast_exp=False`` takes the quantized exponential table;
    ``storage`` as :func:`.lw.lwrad`."""
    if compress_daylight is None:
        compress_daylight = cosz.is_cuda
    ncol = cosz.shape[0]
    if compress_daylight:
        nday = int((cosz > 0.0001).sum())
        kday = min(ncol, max(daylight_k(ncol), -(-nday // 8) * 8))
        if kday < ncol:
            order = torch.argsort(-cosz, stable=True)
            keep = order[:kday]

            def take(a):
                return a.index_select(0, keep)

            small = swrad(
                *map(take, (plyr, plvl, tlyr, tlvl, qlyr, olyr, gasvmr,
                            clouds, aerosols, sfcalb, delpin, cosz)),
                solcon, take(rand2d), T, iovrsw=iovrsw, iswrgas=iswrgas,
                iswcliq=iswcliq, iswmode=iswmode, fast_exp=fast_exp,
                compress_daylight=False, impl=impl, storage=storage,
            )

            def expand(v):
                out = v.new_zeros((ncol,) + tuple(v.shape[1:]))
                return out.index_copy_(0, keep, v)

            return {k: expand(v) for k, v in small.items()}
    storage = rlw.resolve_storage(storage, plyr.dtype, plyr.device)
    day = cosz > 0.0001
    cosz_safe = torch.where(day, cosz, 1.0)
    ssolar = torch.where(day, (solcon / P.S0_SW) * cosz_safe, 0.0)

    tem1 = 100.0 * P.CON_G
    tem2 = 1.0e-20 * 1.0e3 * P.CON_AVGD
    h2ovmr = (qlyr * P.AMDW / (1.0 - qlyr)).clamp(min=0.0)
    o3vmr = (olyr * P.AMDO3).clamp(min=0.0)
    tem0 = (1.0 - h2ovmr) * P.CON_AMD + h2ovmr * P.CON_AMW
    coldry = tem2 * delpin / (tem1 * tem0 * (1.0 + h2ovmr))
    temcol = 1.0e-12 * coldry
    cols = [(coldry * h2ovmr).clamp(min=0.0),
            torch.maximum(temcol, coldry * gasvmr[..., 0]),
            (coldry * o3vmr).clamp(min=0.0)]
    if iswrgas > 0:
        cols += [torch.maximum(temcol, coldry * gasvmr[..., i])
                 for i in (1, 2, 3)]
    else:
        cols += [temcol, temcol, temcol]
    colamt = torch.stack(cols + [torch.zeros_like(coldry)], dim=-1)
    colmol = coldry + colamt[..., 0]

    c = setcoef_sw(plyr, tlyr, h2ovmr, T)
    c["colh2o"] = colamt[..., 0]
    sfluxzen, taug, taur = taumol_sw(c, colamt, colmol, T, impl, storage)
    cldfmc, taucw, ssacw, asycw = cldprop_sw(
        *[clouds[..., i] for i in range(9)], rand2d, T, iovrsw=iovrsw,
        iswcliq=iswcliq, impl=impl, storage=storage,
    )
    out = spcvrtm_sw(
        ssolar, cosz_safe, sfcalb[:, 0::2], sfcalb[:, 1::2], sfluxzen,
        cldfmc, taug, taur, aerosols[..., 0], aerosols[..., 1],
        aerosols[..., 2], taucw, ssacw, asycw, iswmode=iswmode,
        fast_exp=fast_exp, storage=storage,
    )
    rfdelp = P.HEATFAC / delpin
    fnetc = out["flxdc"] - out["flxuc"]
    hswc = (fnetc[:, 1:] - fnetc[:, :-1]) * rfdelp
    fnet0 = out["flxd0"] - out["flxu0"]
    hsw0 = (fnet0[:, 1:] - fnet0[:, :-1]) * rfdelp

    def mask(v):
        return torch.where(day.reshape(day.shape + (1,) * (v.ndim - 1)), v,
                           0.0)

    result = {k: mask(v) for k, v in out.items()}
    result["hswc"] = mask(hswc)
    result["hsw0"] = mask(hsw0)
    result["cldtau"] = taucw[..., 9]  # band 10 ~ 0.55 um
    return result
