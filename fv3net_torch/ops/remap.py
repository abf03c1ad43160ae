"""Mass-conserving PPM vertical remap on tensors (port of
``fv3net_tpu/ops/remap.py``).

The remap is written through the cumulative mass function
M(p) = integral of q dp from the model top, evaluated exactly from the
piecewise-parabolic reconstruction; then
``q2[k] = (M(pe2[k+1]) - M(pe2[k])) / (pe2[k+1] - pe2[k])``.

Pieces, in call order on the dycore path:

- :func:`banded_search`: per-step layer search shared by every field
  (depends only on the two edge sets);
- :func:`cs_profile`: cubic-spline edges + limiters (kord > 7) per field;
  its tridiagonal solve is a Python loop over z;
- :func:`remap_apply`: the profile plus the application.  The application
  (cumulative mass, banded evaluation at the target edges, masks) runs as
  the CUDA kernel ``csrc/remap_apply.cu`` on CUDA tensors
  (:mod:`fv3net_torch.ops.remap_cuda`) and as :func:`remap_apply_plain`
  on CPU tensors.

Conventions: vertical axis last; level 0 = model top; ``pe1``/``pe2`` are
layer-edge pressures, one longer than the field.  kord <= 7
(``ppm_profile``), ``iv=-2`` and the one-shot ``remap_ppm`` are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from fv3net_torch.ops import zscan


def _a6(q, al, ar):
    return 3.0 * (2.0 * q - (al + ar))


def ppm_profile(q, delp, iv: int, kord: int):
    """kord <= 7 PPM reconstruction: not ported yet."""
    raise NotImplementedError(
        "ppm_profile (kord <= 7) is not ported to fv3net_torch yet; "
        "the flagship uses kord=9 (cs_profile)"
    )


def remap_ppm(pe1, q1, pe2, iv: int = 1, kord: int = 1, window: int = None):
    """One-shot remap without a shared search: not ported yet."""
    raise NotImplementedError(
        "remap_ppm is not ported to fv3net_torch yet; use banded_search + "
        "remap_apply"
    )


def cs_profile(q, delp, iv: int, kord: int):
    """Cubic-spline edge reconstruction (S.-J. Lin 2008); (al, ar, a6).

    ``q``: (..., km) or (F, ..., km); ``delp`` broadcasts against it.
    """
    if iv == -2:
        raise NotImplementedError(
            "cs_profile iv=-2 (w with a pinned surface value) is not "
            "ported to fv3net_torch yet"
        )
    km = q.shape[-1]

    # tridiagonal forward sweep (reference mappm.f90:180-205)
    grat0 = delp[..., 1] / delp[..., 0]
    bet0 = grat0 * (grat0 + 0.5)
    qe0 = ((grat0 + grat0) * (grat0 + 1.0) * q[..., 0] + q[..., 1]) / bet0
    gam0 = (1.0 + grat0 * (grat0 + 1.5)) / bet0
    d4 = delp[..., :-1] / delp[..., 1:]
    qe = [qe0]
    gam = [gam0]
    for k in range(km - 1):
        d4k = d4[..., k]
        bet = 2.0 + d4k + d4k - gam[-1]
        qe.append((3.0 * (q[..., k] + d4k * q[..., k + 1]) - qe[-1]) / bet)
        gam.append(d4k / bet)

    d4_last = d4[..., -1]
    a_bot = 1.0 + d4_last * (d4_last + 1.5)
    qe_bot = (
        2.0 * d4_last * (d4_last + 1.0) * q[..., km - 1]
        + q[..., km - 2]
        - a_bot * qe[km - 1]
    ) / (d4_last * (d4_last + 0.5) - a_bot * gam[km - 1])

    # back substitution
    edges = [None] * (km + 1)
    edges[km] = qe_bot
    for k in range(km - 1, -1, -1):
        edges[k] = qe[k] - gam[k] * edges[k + 1]
    shape = torch.broadcast_shapes(*(x.shape for x in edges))
    e = torch.stack([x.expand(shape) for x in edges], dim=-1)  # (..., km+1)

    if abs(kord) > 16:
        al = e[..., :-1]
        ar = e[..., 1:]
        return al, ar, _a6(q, al, ar)

    # large-scale constraints (reference mappm.f90:224-262)
    e[..., 1] = torch.clamp(
        e[..., 1],
        torch.minimum(q[..., 0], q[..., 1]),
        torch.maximum(q[..., 0], q[..., 1]),
    )
    gam2 = q[..., 1:] - q[..., :-1]  # gam2[k] = q[k+1] - q[k]

    ek = e[..., 2: km - 1]
    gkm1 = gam2[..., 0: km - 3]
    gkp1 = gam2[..., 2: km - 1]
    qk = q[..., 2: km - 1]
    qkm1 = q[..., 1: km - 2]
    not_extremum = gkm1 * gkp1 > 0.0
    lo = torch.minimum(qkm1, qk)
    hi = torch.maximum(qkm1, qk)
    clipped = torch.clamp(ek, lo, hi)
    local_max = gkm1 > 0.0
    e_max = torch.maximum(ek, lo)
    e_min = torch.minimum(ek, hi)
    if iv == 0:
        e_min = torch.clamp(e_min, min=0.0)
    e[..., 2: km - 1] = torch.where(
        not_extremum, clipped, torch.where(local_max, e_max, e_min)
    )
    e[..., km - 1] = torch.clamp(
        e[..., km - 1],
        torch.minimum(q[..., km - 2], q[..., km - 1]),
        torch.maximum(q[..., km - 2], q[..., km - 1]),
    )

    al = e[..., :-1].clone()
    ar = e[..., 1:].clone()

    # extremum detection: first/last layers from edge overshoot, interior
    # layers from a sign change of the layer differences
    gam_full = torch.cat([torch.zeros_like(q[..., :1]), gam2], dim=-1)
    extm_edge = (al - q) * (ar - q) > 0.0
    interior = gam2[..., :-1] * gam2[..., 1:] < 0.0
    extm = torch.cat(
        [extm_edge[..., :1], interior, extm_edge[..., -1:]], dim=-1
    )
    a6 = 3.0 * (2.0 * q - (al + ar))

    # boundary treatment by iv (reference mappm.f90:297-325)
    if iv == 0:
        al[..., 0] = torch.clamp(al[..., 0], min=0.0)
    elif iv == -1:
        al[..., 0] = torch.where(al[..., 0] * q[..., 0] <= 0.0, 0.0,
                                 al[..., 0])
    elif iv == 2:
        al[..., 0] = q[..., 0]
        ar[..., 0] = q[..., 0]
        a6[..., 0] = 0.0

    def set_layer(k, values):
        al[..., k], ar[..., k], a6[..., k] = values

    if iv != 2:
        a60 = _a6(q[..., 0], al[..., 0], ar[..., 0])
        set_layer(0, _cs_limiters_single(
            extm[..., 0], q[..., 0], al[..., 0], ar[..., 0], a60, 1
        ))

    a61 = _a6(q[..., 1], al[..., 1], ar[..., 1])
    set_layer(1, _cs_limiters_single(
        extm[..., 1], q[..., 1], al[..., 1], ar[..., 1], a61, 2
    ))

    # interior k in [2, km-3] by kord; gam_full[j] = q[j] - q[j-1]
    if km >= 6:
        sl_i = slice(2, km - 2)
        qk = q[..., sl_i]
        alk = al[..., sl_i]
        ark = ar[..., sl_i]
        pmp_1 = qk - 2.0 * gam_full[..., 3: km - 1]
        lac_1 = pmp_1 + 1.5 * gam_full[..., 4:km]
        pmp_2 = qk + 2.0 * gam_full[..., 2: km - 2]
        lac_2 = pmp_2 - 1.5 * gam_full[..., 1: km - 3]
        al_h = torch.clamp(
            alk,
            torch.minimum(torch.minimum(qk, pmp_1), lac_1),
            torch.maximum(torch.maximum(qk, pmp_1), lac_1),
        )
        ar_h = torch.clamp(
            ark,
            torch.minimum(torch.minimum(qk, pmp_2), lac_2),
            torch.maximum(torch.maximum(qk, pmp_2), lac_2),
        )
        if abs(kord) == 9:
            wave = extm[..., sl_i] & (
                extm[..., 1: km - 3] | extm[..., 3: km - 1]
            )
            a6_try = 6.0 * qk - 3.0 * (alk + ark)
            nonmono = torch.abs(a6_try) > torch.abs(alk - ark)
            al_k = torch.where(wave, qk, torch.where(nonmono, al_h, alk))
            ar_k = torch.where(wave, qk, torch.where(nonmono, ar_h, ark))
            a6_k = torch.where(wave, 0.0, 6.0 * qk - 3.0 * (al_k + ar_k))
        else:
            al_k, ar_k = al_h, ar_h
            a6_k = _a6(qk, al_k, ar_k)
        if iv == 0:
            al_k, ar_k, a6_k = _cs_limiters_single(
                extm[..., sl_i], qk, al_k, ar_k, a6_k, 0
            )
        al[..., sl_i] = al_k
        ar[..., sl_i] = ar_k
        a6[..., sl_i] = a6_k

    # bottom two layers (reference mappm.f90:511-531)
    if iv == 0:
        ar[..., km - 1] = torch.clamp(ar[..., km - 1], min=0.0)
    elif iv == -1:
        ar[..., km - 1] = torch.where(
            ar[..., km - 1] * q[..., km - 1] <= 0.0, 0.0, ar[..., km - 1]
        )
    for kk, lmt in ((km - 2, 2), (km - 1, 1)):
        a6k = _a6(q[..., kk], al[..., kk], ar[..., kk])
        set_layer(kk, _cs_limiters_single(
            extm[..., kk], q[..., kk], al[..., kk], ar[..., kk], a6k, lmt
        ))
    return al, ar, a6


def _cs_limiters_single(extm, q, al, ar, a6, iv: int):
    """cs_limiters (reference mappm.f90:535) on one layer, batched."""
    if iv == 0:
        nonpos = q <= 0.0
        cond = torch.abs(ar - al) < -a6
        fmin = (
            q + 0.25 * (ar - al) ** 2 / torch.where(a6 == 0, 1.0, a6)
            + a6 / 12.0
        )
        neg = cond & (fmin < 0.0)
        case_flat = neg & (q < ar) & (q < al)
        case_r = neg & ~case_flat & (ar > al)
        case_l = neg & ~case_flat & ~(ar > al)
        a6_n = torch.where(
            case_flat | nonpos,
            0.0,
            torch.where(case_r, 3.0 * (al - q),
                        torch.where(case_l, 3.0 * (ar - q), a6)),
        )
        al_n = torch.where(nonpos | case_flat, q,
                           torch.where(case_l, ar - a6_n, al))
        ar_n = torch.where(nonpos | case_flat, q,
                           torch.where(case_r, al - a6_n, ar))
        return al_n, ar_n, a6_n
    if iv == 1:
        mono = (q - al) * (q - ar) >= 0.0
    else:
        mono = extm
    da1 = ar - al
    da2 = da1 * da1
    a6da = a6 * da1
    low = a6da < -da2
    high = a6da > da2
    a6_low = 3.0 * (al - q)
    a6_high = 3.0 * (ar - q)
    a6_n = torch.where(
        mono, 0.0, torch.where(low, a6_low, torch.where(high, a6_high, a6))
    )
    al_n = torch.where(mono, q, torch.where(high, ar - a6_high, al))
    ar_n = torch.where(mono, q, torch.where(low, al - a6_low, ar))
    return al_n, ar_n, a6_n


def _band_indices(kn1: int, km: int, window: int):
    """Source layer L of each offset o in [-window, window] at each target
    edge: clip(clip(k-1, 0, km-1) + o, 0, km-1)."""
    base = np.clip(np.arange(kn1) - 1, 0, km - 1)
    return [np.clip(base + o, 0, km - 1) for o in range(-window, window + 1)]


def banded_search(pe1, pe2, window: int = 2):
    """Banded layer-search coefficients shared by every field remapped
    between the same edge sets.

    The PPM mass integral is linear in the per-layer profile coefficients::

        M(p) = m_L + dp_L * (al*A(s) + ar*B(s) + a6*C(s)),
        A = s - s^2/2,  B = s^2/2,  C = s^2/2 - s^3/3

    so the search is a set of 4 weight planes per offset (use, wA, wB, wC),
    stored as one contiguous ``w`` tensor [..., 2*window+1, 4, km+1] that
    the CUDA kernel reads directly.  Returns a dict for
    :func:`remap_apply`.
    """
    km = pe1.shape[-1] - 1
    pe1 = pe1.contiguous()
    pe2 = pe2.contiguous()
    p = torch.maximum(pe2, pe1[..., :1]).contiguous()
    kn1 = p.shape[-1]
    raw = []
    chosen = None
    for L in _band_indices(kn1, km, window):
        Lt = torch.as_tensor(L, device=pe1.device)
        peL = pe1.index_select(-1, Lt)
        dpL = pe1.index_select(-1, Lt + 1) - peL
        inside = (peL <= p) & (p <= peL + dpL)
        use = inside if chosen is None else (inside & ~chosen)
        chosen = inside if chosen is None else (chosen | inside)
        raw.append((L, peL, dpL, use))
    planes = []
    for i, (L, peL, dpL, use) in enumerate(raw):
        if i == 0:
            # out-of-band fallback: evaluate at the first offset (the
            # grids are within `window` layers, so only clamps land here)
            use = use | ~chosen
        s = torch.clamp((p - peL) / dpL, 0.0, 1.0)
        s2 = 0.5 * s * s
        uf = use.to(p.dtype)
        planes.append(torch.stack(
            [uf, uf * dpL * (s - s2), uf * dpL * s2,
             uf * dpL * (s2 - s * s * s / 3.0)],
            dim=-2,
        ))
    w = torch.stack(planes, dim=-3)  # [..., n_off, 4, kn1]
    offsets = [
        {
            "L": L,
            "use": w[..., i, 0, :],
            "wA": w[..., i, 1, :],
            "wB": w[..., i, 2, :],
            "wC": w[..., i, 3, :],
        }
        for i, (L, _, _, _) in enumerate(raw)
    ]
    return {
        "offsets": offsets,
        "w": w,
        "window": window,
        "p": p,
        "pe1": pe1,
        "pe2": pe2,
        "below": p > pe1[..., -1:],
        "dp1": (pe1[..., 1:] - pe1[..., :-1]).contiguous(),
    }


def remap_apply_plain(search, q1, al, ar, a6):
    """The application half of :func:`remap_apply` in plain tensor ops:
    the CPU path, and the oracle of the CUDA kernel that replaces it on
    the card.  ``q1``/``al``/``ar``/``a6``: (..., km) or (F, ..., km)."""
    dp1 = search["dp1"]
    m_edges = torch.cat(
        [torch.zeros_like(q1[..., :1]), zscan.cumsum(q1 * dp1, axis=-1)],
        dim=-1,
    )
    m_lay = m_edges[..., :-1]

    m_at = None
    for off in search["offsets"]:
        Lj = torch.as_tensor(off["L"], device=q1.device)
        term = (
            off["use"] * m_lay.index_select(-1, Lj)
            + off["wA"] * al.index_select(-1, Lj)
            + off["wB"] * ar.index_select(-1, Lj)
            + off["wC"] * a6.index_select(-1, Lj)
        )
        m_at = term if m_at is None else m_at + term

    p = search["p"]
    pe1 = search["pe1"]
    pe2 = search["pe2"]
    m_ext = m_edges[..., -1:] + (p - pe1[..., -1:]) * q1[..., -1:]
    m_at = torch.where(search["below"], m_ext, m_at)

    dm = m_at[..., 1:] - m_at[..., :-1]
    dp2_eff = p[..., 1:] - p[..., :-1]
    q2 = dm / torch.where(dp2_eff == 0.0, 1.0, dp2_eff)
    q2 = torch.where(pe2[..., 1:] <= pe1[..., :1], q1[..., :1], q2)
    q2 = torch.where(dp2_eff == 0.0, q1[..., :1], q2)
    q2 = torch.where(pe2[..., :-1] >= pe1[..., -1:], q1[..., -1:], q2)
    return q2


def remap_apply(search, q1, iv: int = 1, kord: int = 9, impl: str = None):
    """Remap one field (or a leading-axis stack of same-``iv`` fields)
    with coefficients from :func:`banded_search`.

    ``impl``: None picks the CUDA kernel for a CUDA tensor and the plain
    version for a CPU tensor; ``"cuda"`` or ``"torch"`` forces one.  The
    kernel path never falls back: a failed build or launch raises.
    """
    if kord <= 7:
        al, ar, a6 = ppm_profile(q1, search["dp1"], iv, kord)
    else:
        al, ar, a6 = cs_profile(q1, search["dp1"], iv, kord)
    if impl is None:
        impl = "cuda" if q1.is_cuda else "torch"
    if impl == "cuda":
        from fv3net_torch.ops import remap_cuda

        return remap_cuda.remap_apply_cuda(
            search, q1.contiguous(), al.contiguous(), ar.contiguous(),
            a6.contiguous(),
        )
    if impl == "torch":
        return remap_apply_plain(search, q1, al, ar, a6)
    raise ValueError(f"remap_apply impl must be None, 'cuda' or 'torch'; "
                     f"got {impl!r}")
