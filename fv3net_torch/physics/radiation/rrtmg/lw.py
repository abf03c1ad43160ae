"""RRTMG-LW on tensors (port of ``fv3net_tpu/physics/radiation/rrtmg/lw.py``
on its k-table kernel route).

Algorithm: RRTMG-LW v4.82 as the reference package states it —
correlated-k gas optics over 140 g-points in 16 bands, water-vapour
self/foreign continua, minor gases and halocarbon cross-sections,
Hu & Stamnes / Fu cloud optics, McICA maximum-random cloud overlap and
the two-level recurrence transfer with linear-in-tau Planck sources.

Batched over [C, L] (k=0 at the surface); the troposphere split is a
mask.  Every k-table fetch is a weighted row selection through
:mod:`fv3net_torch.ops.ktable`: the species-interpolated major-gas taus
of each band through ``spec_band_dot`` (K3), every other fetch through
``weighted_select_dot`` (K4).  ``impl`` picks their version (None: the
CUDA kernels on CUDA tensors, the plain versions on CPU tensors).

``lwrad(taumol="mega")`` takes the whole of the gas optics through one
kernel instead (K2, :mod:`.taumol_cuda`; under bfloat16 storage its
bfloat16 instance, which rounds where the reference's megakernel rounds),
whose plain version is :func:`taumol_lw_plain`.

The transfer evaluates each layer's transmittances and sources for all
layers at once and runs the two recurrences as Python loops over L, with
direct exponentials (``fast_exp=True``) or the reference's quantized
lookup tables (``fast_exp=False``, :func:`make_rt_tables`).

``storage=torch.bfloat16`` is the reference's bf16 storage mode of a
float32 call: the k-table selections read bfloat16 tables with bfloat16
weights and round their outputs to bfloat16 (K4 and K3 in bfloat16), and
the gas optics' [C, L, G] outputs (tautot, fracs) are stored in bfloat16;
index math, interpolation weights, the transfer and the flux sums stay in
float32.  :func:`resolve_storage` names the storage dtypes; a float64 call
is never degraded.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fv3net_torch.ops import ktable
from fv3net_torch.physics.radiation.rrtmg import params as P
from fv3net_torch.physics.radiation.rrtmg import taumol_cuda

_STPFAC = 296.0 / 1013.0

# taumol band groupings (0-based bands)
_SPEC_LO = (2, 3, 4, 6, 8, 11, 12, 14, 15)  # nspa=9 lower bands
_SINGLE_LO = (0, 1, 5, 7, 9, 10, 13)
_SPEC_HI = (2, 3, 4)  # nspb=5 upper bands
_SINGLE_HI = (0, 1, 6, 7, 8, 9, 10, 13)
# 1-D minor-gas (band, table) pairs sharing indminor/minorfrac
_MINOR1_KEYS = [
    (0, "ka_mn2"), (5, "ka_mco2"), (6, "kb_mco2"),
    (7, "ka_mco2"), (7, "ka_mo3"), (7, "ka_mn2o"),
    (7, "kb_mco2"), (7, "kb_mn2o"), (8, "kb_mn2o"),
    (10, "ka_mo2"), (10, "kb_mo2"), (12, "kb_mo3"),
]

NBASE_LO = 70  # 13 ref pressures x 5 temps, + the jp+1 path's rows 65-68
               # and their +1 temperature offset (row 69)
NBASE_HI = 236  # 47 x 5 for absb + the jp-12 path's +1 offset


def nbase_hi_for(min_pressure_mb) -> int:
    """Upper-atmosphere base-row count reachable when layer pressures are
    bounded below by ``min_pressure_mb`` (the model-top interface
    pressure): jp falls with pressure, so a 3 hPa top caps jp at 30 and
    96 rows suffice.  ``None`` (or a non-positive top) keeps all 236;
    rows past the bound are never selected, so results are identical."""
    if min_pressure_mb is None or min_pressure_mb <= 0:
        return NBASE_HI
    jp_max = int(np.clip(
        np.floor(36.0 - 5.0 * (np.log(min_pressure_mb) + 0.04)), 13, 58
    ))
    return int(min(NBASE_HI, (jp_max - 12) * 5 + 6))


def _reshape_base(tab: np.ndarray, nspa: int, nbase: int) -> np.ndarray:
    """Flat [rows, ng] k-table -> [nbase, nspa, ng] (zero-padded past the
    stencil slack; padded rows are only addressed by opposite-atmosphere
    points that the troposphere mask discards)."""
    need = nbase * nspa
    if tab.shape[0] < need:
        tab = np.pad(tab, ((0, need - tab.shape[0]), (0, 0)))
    return tab[:need].reshape(nbase, nspa, tab.shape[-1])


def _flat_tab(tab: np.ndarray, nspa: int, nbase: int) -> np.ndarray:
    """[nbase, nspa*ng]: the K3 table layout of one band."""
    t = _reshape_base(tab, nspa, nbase)
    return t.reshape(nbase, nspa * t.shape[-1])


# ------------------------------------------------------------------ storage
# the reference's names of its storage dtypes (lw.py _STORAGE_NAMES);
# "auto" resolves per device in resolve_storage
STORAGE_NAMES = {
    "auto": "auto", "": "auto",
    "float32": None, "f32": None, "none": None,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}


def resolve_storage(name, dtype, device) -> Optional[torch.dtype]:
    """The storage dtype of a call's big planes from ``name`` (a key of
    :data:`STORAGE_NAMES`, None for float32, or a torch dtype): None to
    store them in the compute ``dtype``, or ``torch.bfloat16``.  "auto"
    is bfloat16 on a CUDA device and float32 on the CPU, as the
    reference's auto is on an accelerator and on the CPU.  Only a float32
    computation is stored in bfloat16: float64 is never degraded."""
    st = name
    if isinstance(name, str):
        key = name.lower()
        if key not in STORAGE_NAMES:
            raise ValueError("storage_dtype must be auto, float32 or "
                             f"bfloat16, got {name!r}")
        st = STORAGE_NAMES[key]
    if st == "auto":
        st = (torch.bfloat16 if torch.device(device).type == "cuda"
              else None)
    if st in (None, torch.float32):
        return None
    if st != torch.bfloat16:
        raise ValueError(f"storage_dtype must be auto, float32 or bfloat16, "
                         f"got {name!r}")
    return st if dtype == torch.float32 else None


def _cast_tree(x, dtype):
    if isinstance(x, dict):
        return {k: _cast_tree(v, dtype) for k, v in x.items()}
    if isinstance(x, list):
        return [_cast_tree(v, dtype) for v in x]
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(dtype)
    return x


def stored_tables(T: Dict, storage: Optional[torch.dtype]) -> Dict:
    """The table dict the k-table selections of a call read: ``T`` itself,
    or (``storage`` bfloat16) a copy of its float tensors in bfloat16,
    made on the first call and kept in ``T`` (as ``taumol_cuda.pack_tables``
    keeps its packing), the derived entries (keys from "_") left out."""
    if storage is None:
        return T
    key = f"_stored_{storage}"
    if key not in T:
        T[key] = _cast_tree({k: v for k, v in T.items()
                             if not k.startswith("_")}, storage)
    return T[key]


def _upcast(x: torch.Tensor) -> torch.Tensor:
    """A bfloat16-stored tensor in float32 (others as they are)."""
    return x.float() if x.dtype == torch.bfloat16 else x


# ------------------------------------------------------------------ tables
def prep_lw_tables(lwdict: Dict, dtype=torch.float64, device=None,
                   nbase_hi: Optional[int] = None) -> Dict:
    """A reference-layout ``lwdict`` as device tensors: every [ng, rows...]
    band table rows-leading, plus the pre-merged group tables the
    selections read (``mtab_lo1``/``mtab_hi1`` single-species tables,
    ``selfref_all``/``forref_all`` continua, ``minor1_all`` 1-D minors,
    ``flat_lo``/``flat_hi`` K3 band tables and the delwave-weighted
    ``planck`` table).

    ``nbase_hi``: reachable upper-atmosphere row bound (``nbase_hi_for``)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    out: Dict = {k: t(lwdict[k]) for k in (
        "totplnk", "preflog", "tref", "chi_mls", "absliq1", "absice0",
        "absice1", "absice2", "absice3",
    )}
    out["chi_rows"] = out["chi_mls"].T.contiguous()  # [59 levels, 7 gases]
    out["planck"] = t(P.DELWAVE_LW) * out["totplnk"]
    raw = []
    bands = []
    for b in range(P.NBANDS_LW):
        src = {k: np.asarray(v, np.float64)
               for k, v in lwdict[f"radlw_kgb{b + 1:02d}"].items()}
        # [ng, ...] -> [..., ng] rows-leading
        src = {k: (a if a.ndim == 1 else np.moveaxis(a, 0, -1))
               for k, a in src.items()}
        raw.append(src)
        bands.append({k: t(a) for k, a in src.items()})
    # stratospheric co2 cooling-rate adjustment g-point weights of bands
    # 4 and 7 (reference radlw_main taugb4/taugb7 literals)
    adj4 = np.ones(P.NG_LW[3])
    adj4[7:14] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.88, 0.943]
    adj7 = np.ones(P.NG_LW[6])
    adj7[5:11] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.855]
    bands[3]["co2adj"] = t(adj4)
    bands[6]["co2adj"] = t(adj7)
    out["bands"] = bands

    nb_hi = int(nbase_hi) if nbase_hi else NBASE_HI
    out["nbase_hi"] = nb_hi
    out["mtab_lo1"] = t(np.concatenate(
        [_reshape_base(raw[i]["absa"], 1, NBASE_LO)[:, 0] for i in _SINGLE_LO],
        axis=-1,
    ))
    out["mtab_hi1"] = t(np.concatenate(
        [_reshape_base(raw[i]["absb"], 1, nb_hi)[:, 0] for i in _SINGLE_HI],
        axis=-1,
    ))
    out["flat_lo"] = {i: t(_flat_tab(raw[i]["absa"], 9, NBASE_LO))
                      for i in _SPEC_LO}
    out["flat_hi"] = {i: t(_flat_tab(raw[i]["absb"], 5, nb_hi))
                      for i in _SPEC_HI}
    out["selfref_all"] = t(np.concatenate(
        [raw[i]["selfref"] for i in range(P.NBANDS_LW)], axis=-1))
    out["forref_all"] = t(np.concatenate(
        [raw[i]["forref"] for i in range(P.NBANDS_LW)], axis=-1))
    out["minor1_all"] = t(np.concatenate(
        [raw[i][k] for i, k in _MINOR1_KEYS], axis=-1))
    return out


# ------------------------------------------------------------------ helpers
def _as_table(w, tab):
    """A weight in the table's dtype (bfloat16 for a stored table)."""
    return w if w is None or w.dtype == tab.dtype else w.to(tab.dtype)


def _weighted_rows(tab, terms, impl=None):
    """``sum_k w_k * tab[clip(id_k)]``: one K4 selection (both versions
    clamp the ids).  On a bfloat16 table the weights are rounded to
    bfloat16 and the bfloat16 result is returned in float32."""
    return _upcast(ktable.weighted_select_dot(
        [(ids, _as_table(w, tab)) for ids, w in terms], tab, impl))


def _take(tab, ids, impl=None):
    """Bounds-clamped row fetch (out-of-range rows only occur under the
    opposite-atmosphere mask and are discarded)."""
    return _weighted_rows(tab, [(ids, None)], impl)


def _chirow(chi_rows, ids, impl=None):
    """Reference amounts of all 7 gases at the pressure row ``ids``
    [..., 7] (``chi_rows`` is chi_mls transposed to [59, 7])."""
    return _take(chi_rows, ids, impl)


def _lerp_rows(tab, index, fint, impl=None):
    """(1-f)*tab[i] + f*tab[i+1] as one selection."""
    return _weighted_rows(tab, [(index, 1.0 - fint), (index + 1, fint)],
                          impl)


def _self_for_all(c, selfref_all, forref_all, impl=None):
    """Water-vapour self/foreign continuum of all bands at once (the
    interpolation indices are band independent)."""
    inds = c["indself"] - 1
    indf = c["indfor"] - 1
    sfac, sfrac = c["selffac"], c["selffrac"]
    ffac, ffrac = c["forfac"], c["forfrac"]
    tauself = _weighted_rows(
        selfref_all,
        [(inds, sfac * (1.0 - sfrac)), (inds + 1, sfac * sfrac)], impl,
    )
    taufor = _weighted_rows(
        forref_all,
        [(indf, ffac * (1.0 - ffrac)), (indf + 1, ffac * ffrac)], impl,
    )
    return tauself, taufor


def _lerp_taken(tab, index, fint, impl=None):
    """``t0 + f * (t1 - t0)`` of the rows i and i+1, each fetched alone:
    on a bfloat16 table the reference's form of these lerps (two stored
    rows and their difference in bfloat16, the lerp in float32; two K4
    calls), else :func:`_lerp_rows` (one)."""
    if tab.dtype != torch.bfloat16:
        return _lerp_rows(tab, index, fint, impl)
    t0 = ktable.weighted_select_dot([(index, None)], tab, impl)
    t1 = ktable.weighted_select_dot([(index + 1, None)], tab, impl)
    return t0.float() + fint[..., None] * (t1 - t0).float()


def _minor1(tab, c, impl=None):
    """1-D minor-gas temperature interpolation -> [C, L, ng]."""
    return _lerp_taken(tab, c["indminor"] - 1, c["minorfrac"], impl)


def _minor2(tab, jm, fm, c, impl=None, mega=False):
    """Bilinear (species x temperature) minor interpolation of a
    [nj, ni, ng] table as one selection over its [nj*ni] rows.  ``mega``
    takes the four rows in ascending order, as the reference's
    megakernel sums its one-hot contraction (a bfloat16 table rounds the
    sum, so its order shows)."""
    nj, ni = tab.shape[0], tab.shape[1]
    jmc = jm.clamp(0, nj - 2)
    imc = (c["indminor"] - 1).clamp(0, ni - 2)
    base = jmc * ni + imc
    fm1 = 1.0 - fm
    mf = c["minorfrac"]
    mf1 = 1.0 - mf
    terms = [(base, fm1 * mf1), (base + ni, fm * mf1),
             (base + 1, fm1 * mf), (base + ni + 1, fm * mf)]
    if mega:
        terms = [terms[0], terms[2], terms[1], terms[3]]
    return _weighted_rows(tab.reshape(nj * ni, tab.shape[-1]), terms, impl)


def _frac2(fracT, jpl, fpl, impl=None):
    """Planck fractions interpolated over the species parameter."""
    return _lerp_taken(fracT, jpl, fpl, impl)


def _base_pairs(base, fac_a, fac_b, nbase):
    """(row, weight) pairs of one pressure path: base and base+1."""
    return [(base.clamp(0, nbase - 1), fac_a),
            ((base + 1).clamp(0, nbase - 1), fac_b)]


def _merged_single(tab, pairs, impl=None):
    """Single-key-species tables of a group of bands, [.., sum_ng]."""
    return _weighted_rows(tab, pairs, impl)


def _stencil3_terms(specparm, fs, js):
    """3-point species stencil as (position, weight) pairs, replicating
    the reference's vectorized expression including its where(...==0)
    quirks (radlw_bands.py:439-491); the species offsets are (0, 1, 2),
    or (1, 0, -1) for specparm > 0.875."""
    lo = specparm < 0.125
    hi = specparm > 0.875
    zero = torch.zeros_like(fs)
    p = torch.where(lo, fs - 1.0, zero) + torch.where(hi, -fs, zero)
    p = torch.where(p == 0, zero, p)
    p4 = torch.where(lo, p ** 4, zero) + torch.where(hi, p ** 4, zero)
    p4 = torch.where(p4 == 0, zero, p4)
    fk0 = torch.where(lo, p4, zero) + torch.where(hi, p ** 4, zero)
    fk0 = torch.where(fk0 == 0, 1.0 - fs, fk0)
    fk1 = (torch.where(lo, 1.0 - p - 2.0 * p4, zero)
           + torch.where(hi, 1.0 - p - 2.0 * p4, zero))
    fk1 = torch.where(fk1 == 0, fs, fk1)
    fk2 = torch.where(lo, p + p4, zero) + torch.where(hi, p + p4, zero)
    fk2 = torch.where(fk2 == 0, zero, fk2)
    d0 = hi.long()
    d1 = 1 - d0
    d2 = torch.where(hi, -1, 2)
    j = js - 1
    return [((j + d0).clamp(0, 8), fk0), ((j + d1).clamp(0, 8), fk1),
            ((j + d2).clamp(0, 8), fk2)]


def _stencil2_terms(fs, js, nspb):
    """2-point species stencil as (position, weight) pairs."""
    j = js - 1
    return [(j.clamp(0, nspb - 1), 1.0 - fs),
            ((j + 1).clamp(0, nspb - 1), fs)]


def _tau_spec_mega(tab_flat, nspa, groups):
    """:func:`_tau_spec` on a bfloat16 table as the reference's megakernel
    computes it (its ``_contract_flat``): per path, each species row of
    the base-row selection rounded once to bfloat16, the stencil weights
    in bfloat16 (summed in bfloat16 where two positions meet), and
    ``sum_s S[s] * A[s]`` in float32 in ascending ``s`` with the products
    exact (the k-table route rounds each product to bfloat16), times the
    path's scale in float32."""
    ng = tab_flat.shape[1] // nspa
    bf16 = torch.bfloat16
    out = None
    for pbase, stencil, scale in groups:
        rows = ktable.weighted_select_dot_plain(
            [(r, w.to(bf16)) for r, w in pbase], tab_flat)
        S = torch.zeros(scale.shape + (nspa,), dtype=bf16,
                        device=scale.device)
        for pos, w in stencil:
            onehot = torch.nn.functional.one_hot(pos, nspa).to(bf16)
            S = S + onehot * w.to(bf16)[..., None]
        acc = None
        for s in range(nspa):
            row = rows[..., s * ng:(s + 1) * ng].float()
            term = S[..., s:s + 1].float() * row
            acc = term if acc is None else acc + term
        t = scale[..., None] * acc
        out = t if out is None else out + t
    return out


def _tau_spec(tab_flat, nspa, groups, impl=None, mega=False):
    """sum_p scale_p * (species stencil of the base-row selection) of one
    band: one K3 call.  groups: (base pairs, stencil pairs, scale).

    On a bfloat16 table (the bf16 storage mode) each path is its own K3
    call with its weights in bfloat16 and its scale applied after, in
    float32, as the reference scales its bfloat16-stored stencil sums;
    ``mega`` takes the megakernel's form instead (:func:`_tau_spec_mega`,
    gathers only)."""
    if tab_flat.dtype == torch.bfloat16 and mega:
        return _tau_spec_mega(tab_flat, nspa, groups)
    if tab_flat.dtype == torch.bfloat16:
        out = None
        for pbase, stencil, scale in groups:
            t = scale[..., None] * ktable.spec_band_dot(
                [[(r, _as_table(w, tab_flat)) for r, w in pbase]],
                [[(pos, _as_table(w, tab_flat)) for pos, w in stencil]],
                tab_flat, nspa, impl)
            out = t if out is None else out + t
        return out
    w_paths = [pbase for pbase, _, _ in groups]
    s_paths = [[(pos, scale * w) for pos, w in stencil]
               for _, stencil, scale in groups]
    return ktable.spec_band_dot(w_paths, s_paths, tab_flat, nspa, impl)


def _spec(colA, colB, rate, mult=8.0):
    speccomb = colA + rate * colB
    specparm = colA / speccomb
    specmult = mult * specparm.clamp(max=P.ONEMINUS)
    js = 1 + specmult.long()
    fs = torch.remainder(specmult, 1.0)
    return speccomb, specparm, js, fs


def _jpl(colA, colB, refrat, mult=8.0):
    speccomb = colA + refrat * colB
    specparm = colA / speccomb
    specmult = mult * specparm.clamp(max=P.ONEMINUS)
    return specmult.long(), torch.remainder(specmult, 1.0)  # 0-based


def g_offsets(idx_list, ng):
    """g-point slice per band within a concatenated per-band table."""
    out, off = {}, 0
    for i in idx_list:
        out[i] = slice(off, off + ng[i])
        off += ng[i]
    return out


# ------------------------------------------------------------------ setcoef
def _planck_interp(planck, t, impl=None):
    """delwave-weighted Planck table at temperature t [...] -> [..., nb]:
    the 1-K lerp as one two-row selection."""
    ind = torch.trunc(t - 159.0).clamp(1.0, 180.0).long()
    tfr = t - torch.trunc(t)
    if planck.dtype == torch.bfloat16:
        # the reference's stored weights: 1 - f taken in bfloat16
        tfr = tfr.to(planck.dtype)
    return _weighted_rows(planck, [(ind - 1, 1.0 - tfr), (ind, tfr)], impl)


def setcoef_lw(pavel, tavel, tz, stemp, h2ovmr, colamt, coldry, colbrd, T,
               impl=None, storage=None):
    """Interpolation indices and factors (reference radlw_main.py:
    2268-2530).  Inputs [C, L] (tz [C, L+1], stemp [C]); returns a dict of
    [C, L] coefficients plus the Planck sources pklay/pklev
    [C, nbands, L+1] and the troposphere mask."""
    preflog, tref = T["preflog"], T["tref"]
    chi = T["chi_mls"]
    L = tavel.shape[1]
    t_all = torch.cat([stemp[:, None], tavel, tz], dim=1)
    pk = _planck_interp(stored_tables(T, storage)["planck"], t_all,
                        impl)  # [C, 2L+2, nbands]
    pklay = pk[:, : L + 1].transpose(1, 2)
    pklev = pk[:, L + 1:].transpose(1, 2)

    plog = torch.log(pavel)
    jp = torch.trunc(36.0 - 5.0 * (plog + 0.04)).clamp(1.0, 58.0).long() - 1
    fp = (5.0 * (preflog[jp] - plog)).clamp(0.0, 1.0)
    tem1 = (tavel - tref[jp]) / 15.0
    tem2 = (tavel - tref[jp + 1]) / 15.0
    jt = torch.trunc(3.0 + tem1).clamp(1.0, 4.0).long() - 1
    jt1 = torch.trunc(3.0 + tem2).clamp(1.0, 4.0).long() - 1
    ft = (tem1 - (jt - 2).to(tavel.dtype)).clamp(-0.5, 1.5)
    ft1 = (tem2 - (jt1 - 2).to(tavel.dtype)).clamp(-0.5, 1.5)

    tem1f = 1.0 - fp
    fac10 = tem1f * ft
    fac00 = tem1f * (1.0 - ft)
    fac11 = fp * ft1
    fac01 = fp * (1.0 - ft1)

    forfac = pavel * _STPFAC / (tavel * (1.0 + h2ovmr))
    selffac = h2ovmr * forfac

    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (colbrd / (coldry + colamt[..., 0]))
    temm = (tavel - 180.8) / 7.2
    indminor = torch.trunc(temm).clamp(1.0, 18.0).long()
    minorfrac = temm - indminor.to(tavel.dtype)

    tropo = plog > 4.56

    temf_lo = (332.0 - tavel) / 36.0
    indfor_lo = torch.trunc(temf_lo).clamp(1.0, 2.0).long()
    forfrac_lo = temf_lo - indfor_lo.to(tavel.dtype)
    tems = (tavel - 188.0) / 7.2
    indself_lo = (torch.trunc(tems) - 7.0).clamp(1.0, 9.0).long()
    selffrac_lo = tems - (indself_lo + 7).to(tavel.dtype)
    temf_hi = (tavel - 188.0) / 36.0
    indfor = torch.where(tropo, indfor_lo, 3)
    forfrac = torch.where(tropo, forfrac_lo, temf_hi - 1.0)
    indself = torch.where(tropo, indself_lo, 0)
    selffrac = torch.where(tropo, selffrac_lo, 0.0)

    # binary-species reference ratios [C, L, nrates, 2]
    def ratio(ia, ib, jpx):
        return chi[ia][jpx] / chi[ib][jpx]

    zeros = torch.zeros_like(fp)
    rf = [[zeros, zeros] for _ in range(P.NRATES)]
    rf[0] = [ratio(0, 1, jp), ratio(0, 1, jp + 1)]
    rf_lo = {1: (0, 2), 2: (0, 3), 3: (0, 5), 4: (3, 1)}
    for m, (ia, ib) in rf_lo.items():
        rf[m] = [torch.where(tropo, ratio(ia, ib, jp), 0.0),
                 torch.where(tropo, ratio(ia, ib, jp + 1), 0.0)]
    rf[5] = [torch.where(tropo, 0.0, ratio(2, 1, jp)),
             torch.where(tropo, 0.0, ratio(2, 1, jp + 1))]
    rfrate = torch.stack([torch.stack(pair, dim=-1) for pair in rf], dim=-2)

    return {
        "pklay": pklay, "pklev": pklev,
        "jp": jp + 1, "jt": jt + 1, "jt1": jt1 + 1,  # 1-based (taumol)
        "fac00": fac00, "fac01": fac01, "fac10": fac10, "fac11": fac11,
        "selffac": colamt[..., 0] * selffac, "selffrac": selffrac,
        "indself": indself,
        "forfac": colamt[..., 0] * forfac, "forfrac": forfrac,
        "indfor": indfor,
        "minorfrac": minorfrac, "scaleminor": scaleminor,
        "scaleminorn2": scaleminorn2, "indminor": indminor,
        "rfrate": rfrate, "tropo": tropo,
    }


# ------------------------------------------------------------------ taumol
def taumol_lw(c, colamt, coldry, colbrd, wx, tauaer, T, impl=None,
              storage=None, mega=False):
    """Gas optical depth + Planck fractions for all 140 g-points.

    c: setcoef_lw output (plus "pavel"); colamt [C,L,7], wx [C,L,4],
    tauaer [C,L,nbands].  Returns (fracs, tautot), each [C, L, ngptlw],
    in ``storage`` (None: the compute dtype).  12 K3 calls (9 lower, 3
    upper species-interpolated bands); with ``storage`` bfloat16 every
    selection reads the bfloat16 tables (:func:`stored_tables`).

    ``mega`` (with ``storage`` bfloat16 only) rounds where the
    reference's megakernel rounds, which differs from its k-table route
    in the species taus and the order of the bilinear minors' sums
    (:func:`_tau_spec_mega`, :func:`_minor2`); it is K2's bfloat16 form."""
    mega = mega and storage == torch.bfloat16
    chi = T["chi_mls"]
    B = T["bands"]
    Ts = stored_tables(T, storage)
    BS = Ts["bands"]
    tropo = c["tropo"][..., None]
    jp = c["jp"]  # 1-based
    taus = []
    fracs_all = []

    def combine(lower, upper):
        return torch.where(tropo, lower, upper)

    def bcast1(v):  # [ng] -> [C, L, ng]
        return v.expand(c["fac00"].shape + (v.shape[0],))

    base0 = (jp - 1) * 5 + (c["jt"] - 1)
    base1 = jp * 5 + (c["jt1"] - 1)
    NBH = int(T["nbase_hi"])
    baseU0 = (jp - 13) * 5 + (c["jt"] - 1)
    baseU1 = (jp - 12) * 5 + (c["jt1"] - 1)
    PBL0 = _base_pairs(base0, c["fac00"], c["fac10"], NBASE_LO)
    PBL1 = _base_pairs(base1, c["fac01"], c["fac11"], NBASE_LO)
    PBH0 = _base_pairs(baseU0, c["fac00"], c["fac10"], NBH)
    PBH1 = _base_pairs(baseU1, c["fac01"], c["fac11"], NBH)
    A1_lo = _merged_single(Ts["mtab_lo1"], PBL0 + PBL1, impl)
    A1_hi = _merged_single(Ts["mtab_hi1"], PBH0 + PBH1, impl)
    sl1 = g_offsets(_SINGLE_LO, P.NG_LW)
    sh1 = g_offsets(_SINGLE_HI, P.NG_LW)

    tauself_all, taufor_all = _self_for_all(
        c, Ts["selfref_all"], Ts["forref_all"], impl
    )

    def self_for(b):
        sl = slice(P.NS_LW[b], P.NS_LW[b] + P.NG_LW[b])
        return tauself_all[..., sl], taufor_all[..., sl]

    minor1_all = _minor1(Ts["minor1_all"], c, impl)
    m1_sl = {}
    off = 0
    for i, k in _MINOR1_KEYS:
        m1_sl[(i, k)] = slice(off, off + P.NG_LW[i])
        off += P.NG_LW[i]

    def minor1(i, key):
        return minor1_all[..., m1_sl[(i, key)]]

    def tau_single_lo(i, col):
        return col[..., None] * A1_lo[..., sl1[i]]

    def tau_single_hi(i, col):
        return col[..., None] * A1_hi[..., sh1[i]]

    def tau_spec_lo(i, sc, sp, fs, js, sc1, sp1, fs1, js1):
        return _tau_spec(
            Ts["flat_lo"][i], 9,
            [(PBL0, _stencil3_terms(sp, fs, js), sc),
             (PBL1, _stencil3_terms(sp1, fs1, js1), sc1)], impl, mega,
        )

    def tau_spec_hi(i, scU, fsU, jsU, scU1, fsU1, jsU1):
        return _tau_spec(
            Ts["flat_hi"][i], 5,
            [(PBH0, _stencil2_terms(fsU, jsU, 5), scU),
             (PBH1, _stencil2_terms(fsU1, jsU1, 5), scU1)], impl, mega,
        )

    # reference amounts at the jp and jp+1 rows (the reference indexes
    # chi_mls with the 1-based jp as a 0-based row)
    chi_jp = _chirow(Ts["chi_rows"], jp, impl)
    chi_jp1 = _chirow(Ts["chi_rows"], jp + 1, impl)
    rfrate = c["rfrate"]
    pavel = c["pavel"]
    h2o, co2, o3 = colamt[..., 0], colamt[..., 1], colamt[..., 2]
    n2o, ch4 = colamt[..., 3], colamt[..., 4]

    # ---- band 1: h2o, minor n2 (both atmospheres) --------------------
    bt = B[0]
    tauself, taufor = self_for(0)
    scalen2 = (colbrd * c["scaleminorn2"])[..., None]
    taun2_lo = scalen2 * minor1(0, "ka_mn2")
    corradj_lo = torch.where(
        pavel < 250.0, 1.0 - 0.15 * (250.0 - pavel) / 154.4, 1.0
    )[..., None]
    lower = corradj_lo * (tau_single_lo(0, h2o) + tauself + taufor
                          + taun2_lo)
    corradj_hi = (1.0 - 0.15 * (pavel / 95.6))[..., None]
    upper = corradj_hi * (tau_single_hi(0, h2o) + taufor + taun2_lo)
    taus.append(combine(lower, upper))
    fracs_all.append(combine(bcast1(bt["fracrefa"]), bcast1(bt["fracrefb"])))

    # ---- band 2: h2o --------------------------------------------------
    bt = B[1]
    tauself, taufor = self_for(1)
    corradj = (1.0 - 0.05 * (pavel - 100.0) / 900.0)[..., None]
    lower = corradj * (tau_single_lo(1, h2o) + tauself + taufor)
    upper = tau_single_hi(1, h2o) + taufor
    taus.append(combine(lower, upper))
    fracs_all.append(combine(bcast1(bt["fracrefa"]), bcast1(bt["fracrefb"])))

    # ---- band 3: h2o+co2, minor n2o (both) ---------------------------
    bt = B[2]
    bs = BS[2]
    refrat_pl_a = chi[0, 8] / chi[1, 8]
    refrat_pl_b = chi[0, 12] / chi[1, 12]
    refrat_m_a = chi[0, 2] / chi[1, 2]
    refrat_m_b = chi[0, 12] / chi[1, 12]
    sc, sp, js, fs = _spec(h2o, co2, rfrate[..., 0, 0])
    sc1, sp1, js1, fs1 = _spec(h2o, co2, rfrate[..., 0, 1])
    jmn2o, fmn2o = _jpl(h2o, co2, refrat_m_a)
    jpl_, fpl = _jpl(h2o, co2, refrat_pl_a)
    ref_n2o = coldry * chi_jp[..., 3]
    ratn2o = n2o / ref_n2o
    adjcoln2o = torch.where(
        ratn2o > 1.5, (0.5 + (ratn2o - 0.5) ** 0.65) * ref_n2o, n2o
    )
    tauself, taufor = self_for(2)
    absn2o = _minor2(bs["ka_mn2o"], jmn2o, fmn2o, c, impl, mega)
    lower = (tau_spec_lo(2, sc, sp, fs, js, sc1, sp1, fs1, js1)
             + tauself + taufor + adjcoln2o[..., None] * absn2o)
    fr_lo = _frac2(bs["fracrefa"], jpl_, fpl, impl)
    scU, _, jsU, fsU = _spec(h2o, co2, rfrate[..., 0, 0], 4.0)
    scU1, _, jsU1, fsU1 = _spec(h2o, co2, rfrate[..., 0, 1], 4.0)
    jmn2oU, fmn2oU = _jpl(h2o, co2, refrat_m_b, mult=4.0)
    jplU, fplU = _jpl(h2o, co2, refrat_pl_b, mult=4.0)
    absn2oU = _minor2(bs["kb_mn2o"], jmn2oU, fmn2oU, c, impl, mega)
    upper = (tau_spec_hi(2, scU, fsU, jsU, scU1, fsU1, jsU1)
             + taufor + adjcoln2o[..., None] * absn2oU)
    fr_hi = _frac2(bs["fracrefb"], jplU, fplU, impl)
    taus.append(combine(lower, upper))
    fracs_all.append(combine(fr_lo, fr_hi))

    # ---- band 4: h2o+co2 lower / o3+co2 upper ------------------------
    bt = B[3]
    bs = BS[3]
    refrat_pl_a = chi[0, 10] / chi[1, 10]
    refrat_pl_b = chi[2, 12] / chi[1, 12]
    sc, sp, js, fs = _spec(h2o, co2, rfrate[..., 0, 0])
    sc1, sp1, js1, fs1 = _spec(h2o, co2, rfrate[..., 0, 1])
    jpl_, fpl = _jpl(h2o, co2, refrat_pl_a)
    tauself, taufor = self_for(3)
    lower = (tau_spec_lo(3, sc, sp, fs, js, sc1, sp1, fs1, js1)
             + tauself + taufor)
    fr_lo = _frac2(bs["fracrefa"], jpl_, fpl, impl)
    scU, _, jsU, fsU = _spec(o3, co2, rfrate[..., 5, 0], 4.0)
    scU1, _, jsU1, fsU1 = _spec(o3, co2, rfrate[..., 5, 1], 4.0)
    jplU, fplU = _jpl(o3, co2, refrat_pl_b, mult=4.0)
    upper = tau_spec_hi(3, scU, fsU, jsU, scU1, fsU1, jsU1)
    upper = upper * bt["co2adj"]  # stratospheric co2 adjustment
    fr_hi = _frac2(bs["fracrefb"], jplU, fplU, impl)
    taus.append(combine(lower, upper))
    fracs_all.append(combine(fr_lo, fr_hi))

    # ---- band 5: h2o+co2 lower (minor o3, ccl4) / o3+co2 upper -------
    bt = B[4]
    bs = BS[4]
    refrat_pl_a = chi[0, 4] / chi[1, 4]
    refrat_pl_b = chi[2, 42] / chi[1, 42]
    refrat_m_a = chi[0, 6] / chi[1, 6]
    sc, sp, js, fs = _spec(h2o, co2, rfrate[..., 0, 0])
    sc1, sp1, js1, fs1 = _spec(h2o, co2, rfrate[..., 0, 1])
    jmo3, fmo3 = _jpl(h2o, co2, refrat_m_a)
    jpl_, fpl = _jpl(h2o, co2, refrat_pl_a)
    tauself, taufor = self_for(4)
    abso3 = _minor2(bs["ka_mo3"], jmo3, fmo3, c, impl, mega)
    ccl4 = wx[..., 0:1] * bt["ccl4"]
    lower = (tau_spec_lo(4, sc, sp, fs, js, sc1, sp1, fs1, js1)
             + tauself + taufor + abso3 * o3[..., None] + ccl4)
    fr_lo = _frac2(bs["fracrefa"], jpl_, fpl, impl)
    scU, _, jsU, fsU = _spec(o3, co2, rfrate[..., 5, 0], 4.0)
    scU1, _, jsU1, fsU1 = _spec(o3, co2, rfrate[..., 5, 1], 4.0)
    jplU, fplU = _jpl(o3, co2, refrat_pl_b, mult=4.0)
    upper = tau_spec_hi(4, scU, fsU, jsU, scU1, fsU1, jsU1) + ccl4
    fr_hi = _frac2(bs["fracrefb"], jplU, fplU, impl)
    taus.append(combine(lower, upper))
    fracs_all.append(combine(fr_lo, fr_hi))

    # ---- band 6: h2o lower (minor co2, cfc11/12); cfc-only upper -----
    bt = B[5]
    tauself, taufor = self_for(5)
    ref_co2 = coldry * chi_jp1[..., 1]
    ratco2 = co2 / ref_co2
    adjcolco2 = torch.where(
        ratco2 > 3.0, (2.0 + (ratco2 - 2.0) ** 0.77) * ref_co2, co2
    )
    cfcs = wx[..., 1:2] * bt["cfc11adj"] + wx[..., 2:3] * bt["cfc12"]
    lower = (tau_single_lo(5, h2o) + tauself + taufor
             + adjcolco2[..., None] * minor1(5, "ka_mco2") + cfcs)
    taus.append(combine(lower, cfcs))
    fracs_all.append(bcast1(bt["fracrefa"]))

    # ---- band 7: h2o+o3 lower (minor co2) / o3 upper (minor co2) -----
    bt = B[6]
    bs = BS[6]
    refrat_pl_a = chi[0, 2] / chi[2, 2]
    refrat_m_a = chi[0, 2] / chi[2, 2]
    sc, sp, js, fs = _spec(h2o, o3, rfrate[..., 1, 0])
    sc1, sp1, js1, fs1 = _spec(h2o, o3, rfrate[..., 1, 1])
    jmco2, fmco2 = _jpl(h2o, o3, refrat_m_a)
    jpl_, fpl = _jpl(h2o, o3, refrat_pl_a)
    ref_co2 = coldry * chi_jp[..., 1]
    ratco2_lo = co2 / ref_co2
    adjco2_lo = torch.where(
        ratco2_lo > 3.0, (3.0 + (ratco2_lo - 3.0) ** 0.79) * ref_co2, co2
    )
    tauself, taufor = self_for(6)
    absco2_lo = _minor2(bs["ka_mco2"], jmco2, fmco2, c, impl, mega)
    lower = (tau_spec_lo(6, sc, sp, fs, js, sc1, sp1, fs1, js1)
             + tauself + taufor + adjco2_lo[..., None] * absco2_lo)
    fr_lo = _frac2(bs["fracrefa"], jpl_, fpl, impl)
    adjco2_hi = torch.where(
        ratco2_lo > 3.0, (2.0 + (ratco2_lo - 2.0) ** 0.79) * ref_co2, co2
    )
    upper = (tau_single_hi(6, o3)
             + adjco2_hi[..., None] * minor1(6, "kb_mco2"))
    upper = upper * bt["co2adj"]
    taus.append(combine(lower, upper))
    fracs_all.append(combine(fr_lo, bcast1(bt["fracrefb"])))

    # ---- band 8: h2o lower (minors co2,o3,n2o,cfc) / o3 upper --------
    bt = B[7]
    tauself, taufor = self_for(7)
    ratco2 = co2 / ref_co2
    adjcolco2 = torch.where(
        ratco2 > 3.0, (2.0 + (ratco2 - 2.0) ** 0.65) * ref_co2, co2
    )
    cfc = wx[..., 2:3] * bt["cfc12"] + wx[..., 3:4] * bt["cfc22adj"]
    lower = (tau_single_lo(7, h2o) + tauself + taufor
             + adjcolco2[..., None] * minor1(7, "ka_mco2")
             + o3[..., None] * minor1(7, "ka_mo3")
             + n2o[..., None] * minor1(7, "ka_mn2o") + cfc)
    upper = (tau_single_hi(7, o3)
             + adjcolco2[..., None] * minor1(7, "kb_mco2")
             + n2o[..., None] * minor1(7, "kb_mn2o") + cfc)
    taus.append(combine(lower, upper))
    fracs_all.append(combine(bcast1(bt["fracrefa"]), bcast1(bt["fracrefb"])))

    # ---- band 9: h2o+ch4 lower (minor n2o) / ch4 upper (minor n2o) ---
    bt = B[8]
    bs = BS[8]
    refrat_pl_a = chi[0, 8] / chi[5, 8]
    refrat_m_a = chi[0, 2] / chi[5, 2]
    sc, sp, js, fs = _spec(h2o, ch4, rfrate[..., 3, 0])
    sc1, sp1, js1, fs1 = _spec(h2o, ch4, rfrate[..., 3, 1])
    jmn2o, fmn2o = _jpl(h2o, ch4, refrat_m_a)
    jpl_, fpl = _jpl(h2o, ch4, refrat_pl_a)
    tauself, taufor = self_for(8)
    absn2o = _minor2(bs["ka_mn2o"], jmn2o, fmn2o, c, impl, mega)
    lower = (tau_spec_lo(8, sc, sp, fs, js, sc1, sp1, fs1, js1)
             + tauself + taufor + adjcoln2o[..., None] * absn2o)
    fr_lo = _frac2(bs["fracrefa"], jpl_, fpl, impl)
    upper = (tau_single_hi(8, ch4)
             + adjcoln2o[..., None] * minor1(8, "kb_mn2o"))
    taus.append(combine(lower, upper))
    fracs_all.append(combine(fr_lo, bcast1(bt["fracrefb"])))

    # ---- band 10: h2o both ------------------------------------------
    bt = B[9]
    tauself, taufor = self_for(9)
    lower = tau_single_lo(9, h2o) + tauself + taufor
    upper = tau_single_hi(9, h2o) + taufor
    taus.append(combine(lower, upper))
    fracs_all.append(combine(bcast1(bt["fracrefa"]), bcast1(bt["fracrefb"])))

    # ---- band 11: h2o both (minor o2) --------------------------------
    bt = B[10]
    tauself, taufor = self_for(10)
    scaleo2 = (colamt[..., 5] * c["scaleminor"])[..., None]
    lower = (tau_single_lo(10, h2o) + tauself + taufor
             + scaleo2 * minor1(10, "ka_mo2"))
    upper = (tau_single_hi(10, h2o) + taufor
             + scaleo2 * minor1(10, "kb_mo2"))
    taus.append(combine(lower, upper))
    fracs_all.append(combine(bcast1(bt["fracrefa"]), bcast1(bt["fracrefb"])))

    # ---- band 12: h2o+co2 lower / nothing upper ----------------------
    bt = B[11]
    bs = BS[11]
    refrat_pl_a = chi[0, 9] / chi[1, 9]
    sc, sp, js, fs = _spec(h2o, co2, rfrate[..., 0, 0])
    sc1, sp1, js1, fs1 = _spec(h2o, co2, rfrate[..., 0, 1])
    # planck: clamp specparm to oneminus BEFORE mult (reference quirk,
    # radlw_bands.py:2584-2588)
    spk = h2o / (h2o + refrat_pl_a * co2)
    spk = torch.where(spk >= P.ONEMINUS, P.ONEMINUS, spk)
    smk = 8.0 * spk
    jpl_ = smk.long()
    fpl = torch.remainder(smk, 1.0)
    tauself, taufor = self_for(11)
    lower = (tau_spec_lo(11, sc, sp, fs, js, sc1, sp1, fs1, js1)
             + tauself + taufor)
    fr_lo = _frac2(bs["fracrefa"], jpl_, fpl, impl)
    taus.append(combine(lower, torch.zeros_like(lower)))
    fracs_all.append(combine(fr_lo, torch.zeros_like(fr_lo)))

    # ---- band 13: h2o+n2o lower (minors co2,co) / o3-minor upper -----
    bt = B[12]
    bs = BS[12]
    refrat_pl_a = chi[0, 4] / chi[3, 4]
    refrat_m_a = chi[0, 0] / chi[3, 0]
    refrat_m_a3 = chi[0, 2] / chi[3, 2]
    sc, sp, js, fs = _spec(h2o, n2o, rfrate[..., 2, 0])
    sc1, sp1, js1, fs1 = _spec(h2o, n2o, rfrate[..., 2, 1])
    jmco2, fmco2 = _jpl(h2o, n2o, refrat_m_a)
    jmco, fmco = _jpl(h2o, n2o, refrat_m_a3)
    jpl_, fpl = _jpl(h2o, n2o, refrat_pl_a)
    ratco2 = co2 / (coldry * 3.55e-4)
    adjcolco2 = torch.where(
        ratco2 > 3.0, (2.0 + (ratco2 - 2.0) ** 0.68) * (coldry * 3.55e-4),
        co2,
    )
    tauself, taufor = self_for(12)
    absco2 = _minor2(bs["ka_mco2"], jmco2, fmco2, c, impl, mega)
    absco = _minor2(bs["ka_mco"], jmco, fmco, c, impl, mega)
    lower = (tau_spec_lo(12, sc, sp, fs, js, sc1, sp1, fs1, js1)
             + tauself + taufor + adjcolco2[..., None] * absco2
             + colamt[..., 6:7] * absco)
    fr_lo = _frac2(bs["fracrefa"], jpl_, fpl, impl)
    upper = o3[..., None] * minor1(12, "kb_mo3")
    taus.append(combine(lower, upper))
    fracs_all.append(combine(fr_lo, bcast1(bt["fracrefb"])))

    # ---- band 14: co2 both -------------------------------------------
    bt = B[13]
    tauself, taufor = self_for(13)
    lower = tau_single_lo(13, co2) + tauself + taufor
    upper = tau_single_hi(13, co2)
    taus.append(combine(lower, upper))
    fracs_all.append(combine(bcast1(bt["fracrefa"]), bcast1(bt["fracrefb"])))

    # ---- band 15: n2o+co2 lower (minor n2) / nothing upper -----------
    bt = B[14]
    bs = BS[14]
    refrat_pl_a = chi[3, 0] / chi[1, 0]
    refrat_m_a = chi[3, 0] / chi[1, 0]
    sc, sp, js, fs = _spec(n2o, co2, rfrate[..., 4, 0])
    sc1, sp1, js1, fs1 = _spec(n2o, co2, rfrate[..., 4, 1])
    jmn2, fmn2 = _jpl(n2o, co2, refrat_m_a)
    jpl_, fpl = _jpl(n2o, co2, refrat_pl_a)
    scalen2 = (colbrd * c["scaleminor"])[..., None]
    tauself, taufor = self_for(14)
    taun2 = scalen2 * _minor2(bs["ka_mn2"], jmn2, fmn2, c, impl, mega)
    lower = (tau_spec_lo(14, sc, sp, fs, js, sc1, sp1, fs1, js1)
             + tauself + taufor + taun2)
    fr_lo = _frac2(bs["fracrefa"], jpl_, fpl, impl)
    taus.append(combine(lower, torch.zeros_like(lower)))
    fracs_all.append(combine(fr_lo, torch.zeros_like(fr_lo)))

    # ---- band 16: h2o+ch4 lower / ch4 upper --------------------------
    bt = B[15]
    bs = BS[15]
    refrat_pl_a = chi[0, 5] / chi[5, 5]
    sc, sp, js, fs = _spec(h2o, ch4, rfrate[..., 3, 0])
    sc1, sp1, js1, fs1 = _spec(h2o, ch4, rfrate[..., 3, 1])
    jpl_, fpl = _jpl(h2o, ch4, refrat_pl_a)
    tauself, taufor = self_for(15)
    lower = (tau_spec_lo(15, sc, sp, fs, js, sc1, sp1, fs1, js1)
             + tauself + taufor)
    fr_lo = _frac2(bs["fracrefa"], jpl_, fpl, impl)
    # nspb=0 quirk: the flat upper rows collapse to 0 (fac00/fac01) and 1
    # (fac10/fac11) for every layer
    upper = ch4[..., None] * (
        (c["fac00"] + c["fac01"])[..., None] * bt["absb"][0]
        + (c["fac10"] + c["fac11"])[..., None] * bt["absb"][1]
    )
    taus.append(combine(lower, upper))
    fracs_all.append(combine(fr_lo, bcast1(bt["fracrefb"])))

    # the two [C, L, ngptlw] outputs in the storage dtype, each band's
    # aerosol tau added in the compute dtype first (as the reference)
    st = storage or tauaer.dtype
    tautot = torch.cat(
        [(t + tauaer[..., i:i + 1]).to(st) for i, t in enumerate(taus)],
        dim=-1,
    )
    fracs = torch.cat([f.to(st) for f in fracs_all], dim=-1)
    return fracs, tautot


def taumol_lw_plain(c, colamt, coldry, colbrd, wx, tauaer, T,
                    storage=None):
    """The plain PyTorch version of K2: :func:`taumol_lw` with every
    selection as a plain gather; under bfloat16 ``storage`` in the
    megakernel's form (its ``mega``)."""
    return taumol_lw(c, colamt, coldry, colbrd, wx, tauaer, T, impl="torch",
                     storage=storage, mega=True)


def taumol_lw_mega(c, colamt, coldry, colbrd, wx, tauaer, T, impl=None,
                   storage=None):
    """:func:`taumol_lw` as one kernel launch: K2 on CUDA tensors (it
    launches or raises; its float32, float64 or, with ``storage``
    bfloat16, bfloat16 instance), :func:`taumol_lw_plain` on CPU
    tensors; ``impl`` "cuda" or "torch" forces one."""
    if impl not in (None, "cuda", "torch"):
        raise ValueError(f"taumol impl must be None, 'cuda' or 'torch'; got "
                         f"{impl!r}")
    if impl == "cuda" or (impl is None and coldry.is_cuda):
        return taumol_cuda.taumol_lw_cuda(c, colamt, coldry, colbrd, wx,
                                          tauaer, T, storage)
    return taumol_lw_plain(c, colamt, coldry, colbrd, wx, tauaer, T, storage)


# ------------------------------------------------------------------ clouds
def mcica_walk(rand, cldf, ngpt: int, iovr: int = 1):
    """McICA subcolumn masks [C, L, ngpt] (int8 {0, 1}) from uniforms
    ``rand`` [C, ngpt*L] ordered g-major and cloud fractions [C, L]:
    the maximum-random overlap walk up from the surface (iovr=1) as a
    loop over layers, or random overlap (other iovr)."""
    C, L = cldf.shape
    cdfunc = rand.reshape(C, ngpt, L).to(cldf.dtype)
    if iovr == 1:
        walked = [cdfunc[:, :, 0]]
        for k in range(1, L):
            prev = walked[-1]
            tem1 = (1.0 - cldf[:, k - 1])[:, None]
            walked.append(torch.where(prev > tem1, prev,
                                      cdfunc[:, :, k] * tem1))
        cdfunc = torch.stack(walked, dim=2)
    cloudy = cdfunc >= (1.0 - cldf)[:, None, :]
    return cloudy.to(torch.int8).transpose(1, 2)


def cldprop_lw(cfrac, clwp, relw, ciwp, reiw, cda1, cda2, cda3, cda4, rand,
               T, iovrlw: int = 1, ilwcliq: int = 1, ilwcice: int = 3,
               impl=None, storage=None):
    """Cloud optical depth per band + McICA per-g binary cloud masks.

    cfrac..cda4: [C, L] (k=0 at the surface); rand: [C, ngptlw*L]
    uniforms ordered g-major like the reference's rand2d.  Returns
    (cldfmc [C, L, ngpt] int8, taucld [C, L, nbands]).  With ``storage``
    bfloat16 the optics lerps read the bfloat16 tables."""
    dtype = cfrac.dtype
    Ts = stored_tables(T, storage)
    cloudy_lay = cfrac > P.CLDMIN
    tauran = P.ABSRAIN * cda1
    tausnw = torch.where(
        (cda3 > 0.0) & (cda4 > 10.0),
        P.ABSSNOW0 * 1.05756 * cda3 / cda4.clamp(min=1e-12), 0.0,
    )
    zeros_b = torch.zeros(cfrac.shape + (P.NBANDS_LW,), dtype=dtype,
                          device=cfrac.device)
    if ilwcliq == 1:
        factor = relw - 1.5
        index = torch.trunc(factor).clamp(1.0, 57.0).long() - 1
        fint = factor - (index + 1).to(dtype)
        tauliq = (clwp[..., None]
                  * _lerp_rows(Ts["absliq1"], index, fint, impl)).clamp(min=0.0)
        tauliq = torch.where((clwp > 0.0)[..., None], tauliq, 0.0)
    else:
        tauliq = zeros_b
    if ilwcice == 3:
        dgeice = (1.0315 * reiw).clamp(min=5.0)
        factor = (dgeice - 2.0) / 3.0
        index = torch.trunc(factor).clamp(1.0, 45.0).long() - 1
        fint = factor - (index + 1).to(dtype)
        tauice = (ciwp[..., None]
                  * _lerp_rows(Ts["absice3"], index, fint, impl)).clamp(min=0.0)
        tauice = torch.where((ciwp > 0.0)[..., None], tauice, 0.0)
    else:
        tauice = zeros_b
    taucld = tauice + tauliq + (tauran + tausnw)[..., None]
    taucld = torch.where(cloudy_lay[..., None], taucld, 0.0)
    cldf = torch.where(cloudy_lay, cfrac, 0.0)
    return mcica_walk(rand, cldf, P.NGPT_LW, iovrlw), taucld


# ------------------------------------------------------------------ rtrnmc
def make_rt_tables(dtype, device=None):
    """The reference's transmittance / tau-transition lookup tables
    (tau_tbl, exp_tbl, tfn_tbl), each [NTBL + 2] (reference
    radlw_main.py:1373-1400, ``fv3net_tpu``'s ``_make_rt_tables``)."""
    ntbl = P.NTBL
    i = np.arange(1, ntbl)
    tfn = i / (ntbl - i)
    tau = P.BPADE * tfn
    explimit = int(np.floor(-np.log(np.finfo(float).tiny)))
    exp_t = np.where(tau >= explimit, 1e-20,
                     np.exp(-np.minimum(tau, explimit)))
    tfn_t = np.where(tau < 0.06, tau / 6.0,
                     1.0 - 2.0 * ((1.0 / tau) - (exp_t / (1.0 - exp_t))))
    tabs = (np.concatenate([[0.0], tau, [1.0e10]]),
            np.concatenate([[1.0], exp_t, [1e-20]]),
            np.concatenate([[0.0], tfn_t, [1.0]]))
    return tuple(torch.as_tensor(t, dtype=dtype, device=device)
                 for t in tabs)


def _rt_index(od):
    """The lookup-table row of optical depths ``od`` (>= 0)."""
    return torch.trunc(P.NTBL * (od / (P.BPADE + od)) + 0.5).clamp(
        0, P.NTBL).long()


def rtrnmc_lw(semiss, delp, cldfmc, taucld, tautot, pklay, pklev, fracs,
              secdif, fast_exp: bool = True):
    """McICA radiative transfer (reference radlw_main.py:3381-3717).

    semiss/secdif [C, nbands]; delp [C, L] (mb); cldfmc/tautot/fracs
    [C, L, ngpt] (tautot and fracs may be stored in bfloat16: the
    transfer runs in float32 then); taucld [C, L, nbands];
    pklay/pklev [C, nbands, L+1] (index 0 = surface).  Returns
    (totuflux, totdflux, htr, totuclfl, totdclfl, htrcl): fluxes
    [C, L+1], heating [C, L] in K/s.  ``fast_exp``: direct exponentials;
    False takes the transmittances and tau transitions from the
    reference's quantized tables (:func:`make_rt_tables`)."""
    tautot, fracs = _upcast(tautot), _upcast(fracs)
    dtype = tautot.dtype
    C, L, G = tautot.shape
    ngb = torch.as_tensor(P.NGB_LW, device=tautot.device)
    rec_6 = 0.166667

    def bexp(x):  # [..., nbands] -> [..., G]
        return x.index_select(-1, ngb)

    secdif_g = bexp(secdif)[:, None, :]  # [C, 1, G]
    semiss_g = bexp(semiss)

    # every layer's transmittances and sources at once, [C, L, G]
    cldf = cldfmc.to(dtype)
    od = (secdif_g * tautot).clamp(min=0.0)
    small = od <= 0.06
    if fast_exp:
        trng_big = torch.exp(-od.clamp(max=500.0))
        tfn_big = 1.0 - 2.0 * (1.0 / od.clamp(min=0.06)
                               - trng_big / (1.0 - trng_big).clamp(min=1e-30))
        odepth = od
    else:
        tau_tbl, exp_tbl, tfn_tbl = make_rt_tables(dtype, tautot.device)
        itgas = _rt_index(od)
        trng_big = exp_tbl[itgas]
        tfn_big = tfn_tbl[itgas]
        odepth = torch.where(small, od, tau_tbl[itgas])
    atrgas = torch.where(small, od - 0.5 * od * od, 1.0 - trng_big)
    trng = torch.where(small, 1.0 - atrgas, trng_big)
    gasfac = torch.where(small, rec_6 * od, tfn_big)

    blay = bexp(pklay[:, :, 1:].transpose(1, 2))
    dplnku = bexp(pklev[:, :, 1:].transpose(1, 2)) - blay
    dplnkd = bexp(pklev[:, :, :-1].transpose(1, 2)) - blay
    gassrcd = fracs * (blay + dplnkd * gasfac) * atrgas
    gassrcu = fracs * (blay + dplnku * gasfac) * atrgas

    cloudy = cldf >= P.EPS
    odcld = secdif_g * bexp(taucld)
    efclrfr = 1.0 - (1.0 - torch.exp(-odcld)) * cldf
    odtot = odepth + odcld
    small_t = odtot < 0.06
    if fast_exp:
        exp_t = torch.exp(-odtot.clamp(max=500.0))
        tfn_t = 1.0 - 2.0 * (1.0 / odtot.clamp(min=0.06)
                             - exp_t / (1.0 - exp_t).clamp(min=1e-30))
    else:
        ittot = _rt_index(odtot)
        exp_t = exp_tbl[ittot]
        tfn_t = tfn_tbl[ittot]
    totfac = torch.where(small_t, rec_6 * odtot, tfn_t)
    atrtot = torch.where(small_t, odtot - 0.5 * odtot * odtot, 1.0 - exp_t)
    totsrcd = fracs * (blay + dplnkd * totfac) * atrtot
    totsrcu = fracs * (blay + dplnku * totfac) * atrtot
    trans_tot = torch.where(cloudy, trng * efclrfr, trng)
    srcd_tot = torch.where(cloudy, gassrcd + cldf * (totsrcd - gassrcd),
                           gassrcd)
    srcu_tot = torch.where(cloudy, gassrcu + cldf * (totsrcu - gassrcu),
                           gassrcu)

    # ---- downward recurrence (TOA -> surface), k = L-1 .. 0 ----------
    radtotd = torch.zeros((C, G), dtype=dtype, device=tautot.device)
    radclrd = torch.zeros_like(radtotd)
    down_tot = [None] * L
    down_clr = [None] * L
    for k in range(L - 1, -1, -1):
        radtotd = radtotd * trans_tot[:, k] + srcd_tot[:, k]
        radclrd = radclrd * trng[:, k] + gassrcd[:, k]
        down_tot[k] = radtotd.sum(-1)
        down_clr[k] = radclrd.sum(-1)
    zero = torch.zeros((C,), dtype=dtype, device=tautot.device)
    totdrad = torch.stack(down_tot + [zero], dim=1)  # [C, L+1]
    clrdrad = torch.stack(down_clr + [zero], dim=1)

    # ---- surface reflection + upward recurrence ----------------------
    reflct = 1.0 - semiss_g
    rad0 = semiss_g * fracs[:, 0, :] * bexp(pklay[:, :, 0])
    radtotu = rad0 + reflct * radtotd
    radclru = rad0 + reflct * radclrd
    up_tot = [radtotu.sum(-1)]
    up_clr = [radclru.sum(-1)]
    for k in range(L):
        radtotu = radtotu * trans_tot[:, k] + srcu_tot[:, k]
        radclru = radclru * trng[:, k] + gassrcu[:, k]
        up_tot.append(radtotu.sum(-1))
        up_clr.append(radclru.sum(-1))

    flxfac = P.WTDIFF * P.FLUXFAC
    totuflux = torch.stack(up_tot, dim=1) * flxfac  # [C, L+1]
    totdflux = totdrad * flxfac
    totuclfl = torch.stack(up_clr, dim=1) * flxfac
    totdclfl = clrdrad * flxfac

    rfdelp = P.HEATFAC / delp
    fnet = totuflux - totdflux
    htr = (fnet[:, :-1] - fnet[:, 1:]) * rfdelp
    fnetc = totuclfl - totdclfl
    htrcl = (fnetc[:, :-1] - fnetc[:, 1:]) * rfdelp
    return totuflux, totdflux, htr, totuclfl, totdclfl, htrcl


# ------------------------------------------------------------------ lwrad
def lwrad(plyr, plvl, tlyr, tlvl, qlyr, olyr, gasvmr, clouds, aerosols,
          sfemis, sfgtmp, delpin, rand2d, T, iovrlw: int = 1,
          ilwrgas: int = 1, ilwcliq: int = 1, fast_exp: bool = True,
          impl=None, taumol: str = "ktable",
          storage=None) -> Dict[str, torch.Tensor]:
    """Batched LW driver (reference radlw_main.py:1459-2268 semantics).

    Inputs [C, L] layer / [C, L+1] level, k=0 at the surface; gasvmr
    [C, L, 10], clouds [C, L, 9], aerosols [C, L, nbands, 3], rand2d
    [C, ngptlw*nlay].  T: prep_lw_tables output.  Pressures in mb.

    ``taumol`` routes the gas optics: "ktable" through the k-table
    selections (12 K3 and 27 K4 calls), "mega" through the one-launch
    kernel K2 (:func:`taumol_lw_mega`).  ``fast_exp=False`` takes the
    transfer's lookup tables.  ``storage``: the storage dtype of the big
    planes (a name or dtype, see :func:`resolve_storage`; None is the
    compute dtype)."""
    if taumol not in ("ktable", "mega"):
        raise ValueError(f"taumol must be 'ktable' or 'mega'; got {taumol!r}")
    dtype = plyr.dtype
    storage = resolve_storage(storage, dtype, plyr.device)
    tem1 = 100.0 * P.CON_G
    tem2 = 1.0e-20 * 1.0e3 * P.CON_AVGD

    h2ovmr = (qlyr * P.AMDW / (1.0 - qlyr)).clamp(min=0.0)
    o3vmr = (olyr * P.AMDO3).clamp(min=0.0)
    tem0 = (1.0 - h2ovmr) * P.CON_AMD + h2ovmr * P.CON_AMW
    coldry = tem2 * delpin / (tem1 * tem0 * (1.0 + h2ovmr))
    temcol = 1.0e-12 * coldry

    def at_least(x, lo):
        return torch.maximum(lo, x) if torch.is_tensor(lo) else x.clamp(min=lo)

    cols = [at_least(coldry * h2ovmr, 0.0),
            at_least(coldry * gasvmr[..., 0], temcol),
            at_least(coldry * o3vmr, temcol)]
    if ilwrgas > 0:
        cols += [at_least(coldry * gasvmr[..., 1], temcol),
                 at_least(coldry * gasvmr[..., 2], temcol),
                 at_least(coldry * gasvmr[..., 3], 0.0),
                 at_least(coldry * gasvmr[..., 4], 0.0)]
        wx = torch.stack([at_least(coldry * gasvmr[..., i], 0.0)
                          for i in (8, 5, 6, 7)], dim=-1)
    else:
        cols += [torch.zeros_like(coldry)] * 4
        wx = torch.zeros(coldry.shape + (P.MAXXSEC,), dtype=dtype,
                         device=coldry.device)
    colamt = torch.stack(cols, dim=-1)  # [C, L, maxgas]

    tauaer = aerosols[..., 0] * (1.0 - aerosols[..., 1])

    # precipitable water -> diffusivity angle
    tem11 = (coldry + colamt[..., 0]).sum(dim=1)
    tem22 = colamt[..., 0].sum(dim=1)
    pwvcm = (10.0 * tem22 / (P.AMDW * tem11 * P.CON_G)) * plvl[:, 0]

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=plyr.device)

    secdif = (arr(P.A0_LW) + arr(P.A1_LW) * torch.exp(
        arr(P.A2_LW) * pwvcm[:, None])).clamp(1.5, 1.8)
    fixed = torch.as_tensor([b in (0, 3, 9) for b in range(P.NBANDS_LW)],
                            device=plyr.device)
    secdif = torch.where(fixed, 1.66, secdif)

    colbrd = coldry - colamt[..., 1:].sum(dim=-1)
    semiss = torch.where(
        ((sfemis > P.EPS) & (sfemis <= 1.0))[:, None], sfemis[:, None], 1.0
    ) * torch.ones((1, P.NBANDS_LW), dtype=dtype, device=plyr.device)

    c = setcoef_lw(plyr, tlyr, tlvl, sfgtmp, h2ovmr, colamt, coldry,
                   colbrd, T, impl, storage)
    c["pavel"] = plyr
    cldfmc, taucld = cldprop_lw(
        *[clouds[..., i] for i in range(9)], rand2d, T, iovrlw=iovrlw,
        ilwcliq=ilwcliq, impl=impl, storage=storage,
    )
    if taumol == "mega":
        fracs, tautot = taumol_lw_mega(c, colamt, coldry, colbrd, wx,
                                       tauaer, T, impl, storage)
    else:
        fracs, tautot = taumol_lw(c, colamt, coldry, colbrd, wx, tauaer, T,
                                  impl, storage)
    totuflux, totdflux, htr, totuclfl, totdclfl, htrcl = rtrnmc_lw(
        semiss, delpin, cldfmc, taucld, tautot, c["pklay"], c["pklev"],
        fracs, secdif, fast_exp=fast_exp,
    )
    return {
        "hlwc": htr,  # total-sky heating rate K/s [C, L]
        "hlw0": htrcl,  # clear-sky heating rate
        "upfxc_t": totuflux[:, -1],
        "upfx0_t": totuclfl[:, -1],
        "upfxc_s": totuflux[:, 0],
        "upfx0_s": totuclfl[:, 0],
        "dnfxc_s": totdflux[:, 0],
        "dnfx0_s": totdclfl[:, 0],
        "cldtau": taucld[..., 6],  # band-7 cloud tau diagnostic
        "totuflux": totuflux,
        "totdflux": totdflux,
        "totuclfl": totuclfl,
        "totdclfl": totdclfl,
    }
