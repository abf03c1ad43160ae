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
  its tridiagonal solve is a Python loop over z; ``iv=-2`` pins the
  bottom edge to a surface value ``qs`` (vertical velocity);
- :func:`ppm_profile`: the PPM edges + limiters of kord <= 7;
- :func:`remap_apply`: the profile plus the application.  The application
  (cumulative mass, banded evaluation at the target edges, masks) runs as
  the CUDA kernel ``csrc/remap_apply.cu`` on CUDA tensors
  (:mod:`fv3net_torch.ops.remap_cuda`) and as :func:`remap_apply_plain`
  on CPU tensors.

:func:`remap_ppm` is the one-shot remap (its own search, any target
grid) and :func:`interpolate_1d` the per-column linear interpolation,
both as gathers (the reference's one-hot contractions stood in for the
TPU's gathers).

Conventions: vertical axis last; level 0 = model top; ``pe1``/``pe2`` are
layer-edge pressures, one longer than the field.
"""
from __future__ import annotations

import numpy as np
import torch

from fv3net_torch.ops import zscan


def _a6(q, al, ar):
    return 3.0 * (2.0 * q - (al + ar))


def _sign(mag, s):
    """Fortran sign(): |mag| with the sign of s (s == 0 -> +)."""
    return torch.where(s >= 0, torch.abs(mag), -torch.abs(mag))


def _ppm_limiters(dm, q, al, ar, a6, lmt: int):
    """PPM limiters (reference mappm.f90:668); lmt 0 standard monotonic,
    1 full monotonic, 2 positive definite, 3 none."""
    if lmt == 3:
        return al, ar, a6
    if lmt == 0:
        flat = dm == 0.0
        da1 = ar - al
        da2 = da1 * da1
        a6da = a6 * da1
        low = a6da < -da2
        high = a6da > da2
        a6_low = 3.0 * (al - q)
        a6_high = 3.0 * (ar - q)
        al_n = torch.where(flat, q, torch.where(high, ar - a6_high, al))
        ar_n = torch.where(flat, q, torch.where(low, al - a6_low, ar))
        a6_n = torch.where(flat, 0.0, torch.where(
            low, a6_low, torch.where(high, a6_high, a6)))
        return al_n, ar_n, a6_n
    if lmt == 1:
        qmp = 2.0 * dm
        al_n = q - _sign(torch.minimum(qmp.abs(), (al - q).abs()), qmp)
        ar_n = q + _sign(torch.minimum(qmp.abs(), (ar - q).abs()), qmp)
        return al_n, ar_n, _a6(q, al_n, ar_n)
    if lmt == 2:
        cond = torch.abs(ar - al) < -a6
        fmin = (q + 0.25 * (ar - al) ** 2 / torch.where(a6 == 0, 1.0, a6)
                + a6 / 12.0)
        neg = cond & (fmin < 0.0)
        case_flat = neg & (q < ar) & (q < al)
        case_r = neg & ~case_flat & (ar > al)
        case_l = neg & ~case_flat & ~(ar > al)
        a6_n = torch.where(case_flat, 0.0, torch.where(
            case_r, 3.0 * (al - q),
            torch.where(case_l, 3.0 * (ar - q), a6)))
        al_n = torch.where(case_flat, q, torch.where(case_l, ar - a6_n, al))
        ar_n = torch.where(case_flat, q, torch.where(case_r, al - a6_n, ar))
        return al_n, ar_n, a6_n
    raise ValueError(f"unknown ppm limiter lmt={lmt}")


def _shift(arr, offset: int):
    """Shift along the last axis, zero-filled: offset=+1 -> arr[k-1]."""
    if offset == 0:
        return arr
    pad = torch.zeros_like(arr[..., :abs(offset)])
    if offset > 0:
        return torch.cat([pad, arr[..., :-offset]], dim=-1)
    return torch.cat([arr[..., -offset:], pad], dim=-1)


def ppm_profile(q, delp, iv: int, kord: int):
    """Piecewise-parabolic reconstruction of kord <= 7 (reference
    mappm.f90:614); returns (al, ar, a6) per layer.  q, delp: (..., km),
    level 0 at the model top."""
    km = q.shape[-1]
    if km < 5:
        raise ValueError("ppm_profile requires km >= 5")
    delp = delp.expand_as(q) if delp.shape != q.shape else delp

    delq = q[..., 1:] - q[..., :-1]  # delq[k] = q[k+1] - q[k]
    # d4[k] = delp[k-1] + delp[k] for k in [1, km-1]; d4[0] unused
    d4 = torch.cat([torch.zeros_like(delp[..., :1]),
                    delp[..., :-1] + delp[..., 1:]], dim=-1)

    # interior mismatched slope df2 and monotonized dc, k in [1, km-2]
    dpk = delp[..., 1:-1]
    c1 = (delp[..., :-2] + 0.5 * dpk) / d4[..., 2:]
    c2 = (delp[..., 2:] + 0.5 * dpk) / d4[..., 1:-1]
    df2_int = (dpk * (c1 * delq[..., 1:] + c2 * delq[..., :-1])
               / (d4[..., 1:-1] + delp[..., 2:]))
    qmax3 = torch.maximum(torch.maximum(q[..., :-2], q[..., 1:-1]),
                          q[..., 2:])
    qmin3 = torch.minimum(torch.minimum(q[..., :-2], q[..., 1:-1]),
                          q[..., 2:])
    dc_int = _sign(
        torch.minimum(df2_int.abs(), torch.minimum(qmax3 - q[..., 1:-1],
                                                   q[..., 1:-1] - qmin3)),
        df2_int,
    )
    zero = torch.zeros_like(q[..., :1])

    # 4th-order interior edge values al[k], k in [2, km-2]
    c1e = delq[..., 1:km - 2] * delp[..., 1:km - 2] / d4[..., 2:km - 1]
    a1 = d4[..., 1:km - 2] / (d4[..., 2:km - 1] + delp[..., 1:km - 2])
    a2 = d4[..., 3:km] / (d4[..., 2:km - 1] + delp[..., 2:km - 1])
    dc = torch.cat([zero, dc_int, zero], dim=-1)
    al_int = q[..., 1:km - 2] + c1e + 2.0 / (
        d4[..., 1:km - 2] + d4[..., 3:km]
    ) * (
        delp[..., 2:km - 1] * (c1e * (a1 - a2) + a2 * dc[..., 1:km - 2])
        - delp[..., 1:km - 2] * a1 * dc[..., 2:km - 1]
    )

    # top boundary: area-preserving cubic, 2nd derivative 0 at the top
    d1 = delp[..., 0]
    d2 = delp[..., 1]
    qm = (d2 * q[..., 0] + d1 * q[..., 1]) / (d1 + d2)
    dq = 2.0 * (q[..., 1] - q[..., 0]) / (d1 + d2)
    c1t = 4.0 * (al_int[..., 0] - qm - d2 * dq) / (
        d2 * (2.0 * d2 * d2 + d1 * (d2 + 3.0 * d1)))
    c3t = dq - 0.5 * c1t * (d2 * (5.0 * d1 + d2) - 3.0 * d1 * d1)
    al1 = qm - 0.25 * c1t * d1 * d2 * (d2 + 3.0 * d1)
    al0 = d1 * (2.0 * c1t * d1 * d1 - c3t) + al1
    al1 = torch.clamp(al1, torch.minimum(q[..., 0], q[..., 1]),
                      torch.maximum(q[..., 0], q[..., 1]))
    dc0 = 0.5 * (al1 - q[..., 0])
    if iv == 0:
        al0 = al0.clamp(min=0.0)
        al1 = al1.clamp(min=0.0)
    elif iv == -1:
        al0 = torch.where(al0 * q[..., 0] <= 0.0, 0.0, al0)

    # bottom boundary
    d1 = delp[..., km - 1]
    d2 = delp[..., km - 2]
    qm = (d2 * q[..., km - 1] + d1 * q[..., km - 2]) / (d1 + d2)
    dq = 2.0 * (q[..., km - 2] - q[..., km - 1]) / (d1 + d2)
    c1b = (al_int[..., -1] - qm - d2 * dq) / (
        d2 * (2.0 * d2 * d2 + d1 * (d2 + 3.0 * d1)))
    c3b = dq - 2.0 * c1b * (d2 * (5.0 * d1 + d2) - 3.0 * d1 * d1)
    al_km1 = qm - c1b * d1 * d2 * (d2 + 3.0 * d1)
    ar_km1 = d1 * (8.0 * c1b * d1 * d1 - c3b) + al_km1
    al_km1 = torch.clamp(al_km1, torch.minimum(q[..., km - 1],
                                               q[..., km - 2]),
                         torch.maximum(q[..., km - 1], q[..., km - 2]))
    dc_km1 = 0.5 * (q[..., km - 1] - al_km1)
    if iv == 0:
        al_km1 = al_km1.clamp(min=0.0)
        ar_km1 = ar_km1.clamp(min=0.0)
    elif iv < 0:
        ar_km1 = torch.where(q[..., km - 1] * ar_km1 <= 0.0, 0.0, ar_km1)

    al = torch.cat([al0[..., None], al1[..., None], al_int,
                    al_km1[..., None]], dim=-1)
    ar = torch.cat([al[..., 1:], ar_km1[..., None]], dim=-1)
    dc = torch.cat([dc0[..., None], dc_int, dc_km1[..., None]], dim=-1)
    if abs(iv) == 2:
        # flat top-layer left edge (reference mappm.f90:724-729: only al
        # survives the edge chaining)
        al = torch.cat([q[..., :1], al[..., 1:]], dim=-1)
    a6 = _a6(q, al, ar)

    # the top two and bottom two layers: standard monotonic limiter
    edge = torch.zeros(km, dtype=torch.bool, device=q.device)
    edge[:2] = True
    edge[-2:] = True
    al_m, ar_m, a6_m = _ppm_limiters(dc, q, al, ar, a6, lmt=0)

    if kord >= 7:
        # Huynh's second constraint (reference mappm.f90:784-826)
        h2_int = (
            2.0 * (dc[..., 2:] / delp[..., 2:] - dc[..., :-2] / delp[..., :-2])
            / (delp[..., 1:-1] + 0.5 * (delp[..., :-2] + delp[..., 2:]))
            * delp[..., 1:-1] ** 2
        )
        h2 = torch.cat([zero, h2_int, zero], dim=-1)
        fac = 1.5
        pmp = 2.0 * dc
        qmp_r = q + pmp
        lac_r = q + fac * _shift(h2, 1) + dc
        ar_h = torch.clamp(
            ar, torch.minimum(torch.minimum(q, qmp_r), lac_r),
            torch.maximum(torch.maximum(q, qmp_r), lac_r))
        qmp_l = q - pmp
        lac_l = q + fac * _shift(h2, -1) - dc
        al_h = torch.clamp(
            al, torch.minimum(torch.minimum(q, qmp_l), lac_l),
            torch.maximum(torch.maximum(q, qmp_l), lac_l))
        a6_h = _a6(q, al_h, ar_h)
        if iv == 0:
            al_h, ar_h, a6_h = _ppm_limiters(dc, q, al_h, ar_h, a6_h, lmt=2)
        al_i, ar_i, a6_i = al_h, ar_h, a6_h
    else:
        lmt = max(0, kord - 3)
        if iv == 0:
            lmt = min(2, lmt)
        if kord != 6:
            al_i, ar_i, a6_i = _ppm_limiters(dc, q, al, ar, a6, lmt=lmt)
        else:
            al_i, ar_i, a6_i = al, ar, a6

    return (torch.where(edge, al_m, al_i), torch.where(edge, ar_m, ar_i),
            torch.where(edge, a6_m, a6_i))


def remap_ppm(pe1, q1, pe2, iv: int = 1, kord: int = 1, window: int = None,
              qs=None, impl: str = None):
    """Mass-conserving remap of q1 on edges pe1 to edges pe2 in one call
    (the reference's ``remap_ppm``, Fortran ``mappm``).  pe1 (..., km+1),
    q1 (..., km), pe2 (..., kn+1) -> (..., kn); leading dims broadcast.

    With ``window`` (and kn == km) the search is :func:`banded_search`'s
    and the application :func:`remap_apply`'s (the CUDA kernel on the
    card, ``impl`` as there); otherwise each target edge's source layer
    is found by a count and the cumulative mass gathered from it."""
    km = q1.shape[-1]
    lead = torch.broadcast_shapes(pe1.shape[:-1], q1.shape[:-1])
    pe1 = pe1.expand(lead + pe1.shape[-1:])
    pe2 = pe2.expand(lead + pe2.shape[-1:])
    q1 = q1.expand(lead + q1.shape[-1:])
    if window is not None and pe2.shape[-1] == pe1.shape[-1]:
        return remap_apply(banded_search(pe1, pe2, window), q1, iv=iv,
                           kord=kord, impl=impl, qs=qs)
    dp1 = pe1[..., 1:] - pe1[..., :-1]
    if kord > 7:
        al, ar, a6 = cs_profile(q1, dp1, iv, kord, qs=qs)
    else:
        al, ar, a6 = ppm_profile(q1, dp1, iv, kord)
    m_edges = torch.cat([torch.zeros_like(q1[..., :1]),
                         zscan.cumsum(q1 * dp1, axis=-1)], dim=-1)

    p = torch.maximum(pe2, pe1[..., :1])
    idx = (pe1[..., None, :] <= p[..., :, None]).sum(-1) - 1
    L = idx.clamp(0, km - 1)

    def at(x):
        return torch.gather(x, -1, L)

    pe_L, dp_L = at(pe1[..., :-1]), at(dp1)
    alL, arL, a6L, mL = at(al), at(ar), at(a6), at(m_edges[..., :-1])
    s = ((p - pe_L) / dp_L).clamp(0.0, 1.0)
    integral = alL * s + (arL - alL + a6L) * 0.5 * s * s - a6L * s ** 3 / 3.0
    m = mL + dp_L * integral
    m_ext = m_edges[..., -1:] + (p - pe1[..., -1:]) * q1[..., -1:]
    m_at = torch.where(p > pe1[..., -1:], m_ext, m)
    dm = m_at[..., 1:] - m_at[..., :-1]
    dp2_eff = p[..., 1:] - p[..., :-1]
    q2 = dm / torch.where(dp2_eff == 0.0, 1.0, dp2_eff)
    q2 = torch.where(pe2[..., 1:] <= pe1[..., :1], q1[..., :1], q2)
    q2 = torch.where(dp2_eff == 0.0, q1[..., :1], q2)
    q2 = torch.where(pe2[..., :-1] >= pe1[..., -1:], q1[..., -1:], q2)
    return q2


def interpolate_1d(xp, x, y, fill_value=float("nan")):
    """Per-column linear interpolation (the reference's ``interpolate_1d``,
    Fortran ``interpolate_2d``): xp (..., n_out) targets, x (..., n_in)
    ascending sources, y (..., n_in) values; ``fill_value`` outside
    [x[0], x[-1]].  The bracketing pair is a count and a gather."""
    n_in = x.shape[-1]
    lead = torch.broadcast_shapes(xp.shape[:-1], x.shape[:-1], y.shape[:-1])
    xp = xp.expand(lead + xp.shape[-1:])
    x = x.expand(lead + x.shape[-1:])
    y = y.expand(lead + y.shape[-1:])
    idx = (x[..., None, :] <= xp[..., :, None]).sum(-1) - 1
    lo = idx.clamp(0, n_in - 2)
    hi = lo + 1
    x0, x1 = torch.gather(x, -1, lo), torch.gather(x, -1, hi)
    y0, y1 = torch.gather(y, -1, lo), torch.gather(y, -1, hi)
    w = (xp - x0) / (x1 - x0)
    out = y0 * (1.0 - w) + y1 * w
    inside = (xp >= x[..., :1]) & (xp <= x[..., -1:])
    return torch.where(inside, out, fill_value)


def _cs_edges_w(q, delp, qs):
    """The iv=-2 (vertical velocity) edges (reference mappm.f90:153-176):
    the bottom edge pinned to the surface value ``qs`` and the symmetric
    ``3 * (q[k-1] + q[k])`` right-hand side; (..., km+1)."""
    km = q.shape[-1]
    qs = (torch.zeros_like(q[..., 0]) if qs is None else
          torch.as_tensor(qs, dtype=q.dtype, device=q.device).expand(
              q[..., 0].shape))
    grat = delp[..., :-1] / delp[..., 1:]  # edge j = 1..km-1
    qsum = q[..., :-1] + q[..., 1:]
    qe = [1.5 * q[..., 0]]
    gam = [torch.full_like(qe[0], 0.5)]
    for j in range(km - 2):  # edges 1..km-2
        bet = 2.0 + grat[..., j] + grat[..., j] - gam[-1]
        qe.append((3.0 * qsum[..., j] - qe[-1]) / bet)
        gam.append(grat[..., j] / bet)
    # the bottom interior edge closes on the surface value
    grat_b = grat[..., km - 2]
    qe_bot = (3.0 * qsum[..., km - 2] - grat_b * qs - qe[-1]) / (
        2.0 + grat_b + grat_b - gam[-1])
    edges = [None] * (km - 1) + [qe_bot, qs]
    q_next = qe_bot
    for j in range(km - 2, -1, -1):  # back substitution
        q_next = qe[j] - gam[j] * q_next
        edges[j] = q_next
    shape = torch.broadcast_shapes(*(x.shape for x in edges))
    return torch.stack([x.expand(shape) for x in edges], dim=-1)


def cs_profile(q, delp, iv: int, kord: int, qs=None):
    """Cubic-spline edge reconstruction (S.-J. Lin 2008); (al, ar, a6).

    ``q``: (..., km) or (F, ..., km); ``delp`` broadcasts against it.
    ``iv == -2`` is the vertical-velocity variant: the bottom edge pinned
    to ``qs`` (broadcastable against ``q[..., 0]``; default 0, a rigid
    surface).
    """
    km = q.shape[-1]
    if iv == -2:
        e = _cs_edges_w(q, delp, qs)
    else:
        e = _cs_edges(q, delp)
    if abs(kord) > 16:
        al = e[..., :-1]
        ar = e[..., 1:]
        return al, ar, _a6(q, al, ar)
    return _cs_limit(q, e, iv, kord)


def _cs_edges(q, delp):
    """The tridiagonal edge solve of the other iv (reference
    mappm.f90:180-205); (..., km+1)."""
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
    return torch.stack([x.expand(shape) for x in edges], dim=-1)


def _cs_limit(q, e, iv: int, kord: int):
    """cs_profile's constraints and limiters on the edges ``e``."""
    km = q.shape[-1]

    # large-scale constraints (reference mappm.f90:224-262); e is a fresh
    # stack of the edge solve, set in place
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


def remap_apply(search, q1, iv: int = 1, kord: int = 9, impl: str = None,
                qs=None):
    """Remap one field (or a leading-axis stack of same-``iv`` fields)
    with coefficients from :func:`banded_search`: the profile of
    :func:`ppm_profile` (kord <= 7) or :func:`cs_profile` (``qs``: the
    surface value of iv=-2), then the application.

    ``impl``: None picks the CUDA kernel for a CUDA tensor and the plain
    version for a CPU tensor; ``"cuda"`` or ``"torch"`` forces one.  The
    kernel path never falls back: a failed build or launch raises.
    """
    if kord <= 7:
        al, ar, a6 = ppm_profile(q1, search["dp1"], iv, kord)
    else:
        al, ar, a6 = cs_profile(q1, search["dp1"], iv, kord, qs=qs)
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
