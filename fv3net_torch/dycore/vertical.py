"""Hybrid sigma-pressure vertical coordinate and the Lagrangian-to-
Eulerian column remap (port of ``fv3net_tpu/dycore/vertical.py``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fv3net_torch.core.constants import TOA_PRESSURE
from fv3net_torch.ops import remap as _remap


def hybrid_coordinate(
    nz: int, ptop: float = TOA_PRESSURE, ps0: float = 1.0e5,
    sigma_exp: float = 1.6, pure_pressure_frac: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """ak/bk interface coefficients, pe(k) = ak(k) + bk(k) * ps (numpy).

    Pure-pressure levels in the top ``pure_pressure_frac`` of interfaces,
    transitioning to terrain-following sigma at the surface.
    """
    k = np.arange(nz + 1) / nz
    pe_ref = ptop + (ps0 - ptop) * k ** sigma_exp
    kt = pure_pressure_frac
    bk = np.where(k <= kt, 0.0,
                  (np.maximum(k - kt, 0.0) / (1.0 - kt)) ** 1.5)
    bk[-1] = 1.0
    ak = pe_ref - bk * ps0
    ak[0] = ptop
    ak[-1] = 0.0
    for ps in (5.0e4, 1.1e5):
        pe = ak + bk * ps
        if not (np.diff(pe) > 0).all():
            raise ValueError("generated hybrid coordinate is not monotone")
    return ak, bk


def target_interfaces(ak, bk, ps):
    """pe2[..., k] = ak[k] + bk[k] * ps[...]."""
    return ak + bk * ps[..., None]


def remap_column_fields(
    pe1, pe2, pt, wind_xyz, tracers, kord: int = 9, window: int = None,
    search=None, impl: str = None,
):
    """Remap theta_v, Cartesian winds and tracers from Lagrangian
    interfaces ``pe1`` to target interfaces ``pe2`` (both (..., nz+1),
    z last).

    Wind components use iv=-1, theta iv=2, tracers iv=0 (fv_mapz
    conventions).  ``search``: a precomputed
    :func:`~fv3net_torch.ops.remap.banded_search` shared by every field;
    without one, ``window`` builds it.  ``pt=None`` skips the theta remap.
    ``impl`` selects the remap application (see
    :func:`~fv3net_torch.ops.remap.remap_apply`).
    """
    if search is None:
        if window is None or pe2.shape[-1] != pe1.shape[-1]:
            return _remap_one_shot(pe1, pe2, pt, wind_xyz, tracers, kord,
                                   window, impl)
        search = _remap.banded_search(pe1, pe2, window)
    pt2 = (
        None if pt is None
        else _remap.remap_apply(search, pt, iv=2, kord=kord, impl=impl)
    )
    wind2_stack = _remap.remap_apply(
        search, torch.stack(tuple(wind_xyz)), iv=-1, kord=kord, impl=impl
    )
    names = list(tracers)
    tr2_stack = _remap.remap_apply(
        search, torch.stack([tracers[n] for n in names]), iv=0, kord=kord,
        impl=impl,
    )
    wind2 = tuple(wind2_stack[c] for c in range(len(wind_xyz)))
    tracers2 = {n: tr2_stack[i] for i, n in enumerate(names)}
    return pt2, wind2, tracers2


def _remap_one_shot(pe1, pe2, pt, wind_xyz, tracers, kord, window, impl):
    """:func:`remap_column_fields` through the one-shot
    :func:`~fv3net_torch.ops.remap.remap_ppm` (a target grid of another
    size, or no window), as the reference remaps without a search."""
    pt2 = (None if pt is None else
           _remap.remap_ppm(pe1, pt, pe2, iv=2, kord=kord, window=window,
                            impl=impl))
    wind2_stack = _remap.remap_ppm(pe1[None], torch.stack(tuple(wind_xyz)),
                                   pe2[None], iv=-1, kord=kord,
                                   window=window, impl=impl)
    names = list(tracers)
    tr2_stack = _remap.remap_ppm(
        pe1[None], torch.stack([tracers[n] for n in names]), pe2[None],
        iv=0, kord=kord, window=window, impl=impl)
    wind2 = tuple(wind2_stack[c] for c in range(len(wind_xyz)))
    tracers2 = {n: tr2_stack[i] for i, n in enumerate(names)}
    return pt2, wind2, tracers2
