"""Dycore model state as a dataclass of tensors (port of
``fv3net_tpu/dycore/state.py``).

Layout: [tile=6, nz, ny, nx] for 3-D fields; the horizontal wind is a 3-D
Cartesian tangent vector [3, 6, nz, ny, nx].  The port runs the
hydrostatic core only, so ``w`` and ``delz`` stay None.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fv3net_torch.core.constants import (
    KAPPA,
    RDGAS,
    REFERENCE_SURFACE_PRESSURE,
    RVGAS,
    TOA_PRESSURE,
)
from fv3net_torch.dycore import vertical
from fv3net_torch.grid.geometry import Grid


@dataclasses.dataclass
class DycoreState:
    """Prognostic state of the hydrostatic core.

    Attributes:
        delp: layer pressure thickness [6, nz, ny, nx], Pa
        pt: virtual potential temperature theta_v [6, nz, ny, nx], K
        wind: Cartesian tangent wind [3, 6, nz, ny, nx], m/s
        tracers: name -> [6, nz, ny, nx] mixing ratios (kg/kg); always
            includes "sphum"
        phis: surface geopotential [6, ny, nx], m^2/s^2
        w, delz: nonhydrostatic prognostics; None (not ported yet)
    """

    delp: torch.Tensor
    pt: torch.Tensor
    wind: torch.Tensor
    tracers: Dict[str, torch.Tensor]
    phis: torch.Tensor
    w: Optional[torch.Tensor] = None
    delz: Optional[torch.Tensor] = None


def temperature_from_theta_v(pt, pmid, sphum):
    """T from theta_v and midlayer pressure."""
    tv = pt * (pmid / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    return tv / (1.0 + (RVGAS / RDGAS - 1.0) * sphum)


def theta_v_from_temperature(T, pmid, sphum):
    tv = T * (1.0 + (RVGAS / RDGAS - 1.0) * sphum)
    return tv * (REFERENCE_SURFACE_PRESSURE / pmid) ** KAPPA


def init_state(
    grid: Grid,
    nz: int,
    ptop: float = TOA_PRESSURE,
    t0: float = 280.0,
    dtype=torch.float32,
    perturbation: float = 0.0,
    device=None,
) -> Tuple[DycoreState, np.ndarray, np.ndarray]:
    """Isothermal resting atmosphere over flat topography, optionally with
    a localized theta perturbation (gravity-wave test); the profile is
    computed in float64 numpy and cast last.

    Returns (state, ak, bk).
    """
    ak, bk = vertical.hybrid_coordinate(nz, ptop=ptop)
    shape3 = (6, nz, grid.n, grid.n)
    ps = np.full((6, grid.n, grid.n), 1.0e5)
    pe = ak[:, None, None] + bk[:, None, None] * ps[:, None]
    delp = np.diff(pe, axis=1)
    pmid = delp / np.diff(np.log(pe), axis=1)
    theta = t0 * (REFERENCE_SURFACE_PRESSURE / pmid) ** KAPPA
    if perturbation:
        lon = grid.lon[:, None, :, :]
        lat = grid.lat[:, None, :, :]
        bump = perturbation * np.exp(
            -((lon - 1.0) ** 2 + (lat - 0.3) ** 2) / 0.05
        )
        kz = np.exp(-(((np.arange(nz) - nz * 0.6) / (0.15 * nz)) ** 2))
        theta = theta + bump * kz[None, :, None, None]
    # moist initial state: 50% relative humidity near the surface,
    # decaying aloft (Magnus saturation, consistent with ops.thermo)
    es = 610.94 * np.exp(17.625 * (t0 - 273.15) / (t0 - 273.15 + 243.04))
    qsat = 0.622 * es / (pmid - 0.378 * es)
    q0 = 0.5 * qsat * (pmid / 1.0e5) ** 2
    state = state_from_numpy(
        {
            "delp": delp,
            "pt": theta,
            "wind": np.zeros((3,) + shape3),
            "tracers": {
                "sphum": np.broadcast_to(q0, shape3),
                "cloud_water": np.zeros(shape3),
            },
            "phis": np.zeros((6, grid.n, grid.n)),
        },
        dtype=dtype,
        device=device,
    )
    return state, ak, bk


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def state_from_numpy(src, dtype=torch.float64, device=None) -> DycoreState:
    """Build a :class:`DycoreState` from numpy-convertible arrays.

    ``src``: a dict with keys delp, pt, wind, tracers (dict), phis, or any
    object with those attributes (for example the reference package's
    state, whose arrays ``np.asarray`` converts).
    """
    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    for name in ("w", "delz"):
        value = src.get(name) if isinstance(src, dict) else getattr(
            src, name, None
        )
        if value is not None:
            raise NotImplementedError(
                "nonhydrostatic state (w/delz) is not ported to "
                "fv3net_torch yet"
            )
    return DycoreState(
        delp=t(_get(src, "delp")),
        pt=t(_get(src, "pt")),
        wind=t(_get(src, "wind")),
        tracers={k: t(v) for k, v in _get(src, "tracers").items()},
        phis=t(_get(src, "phis")),
    )


def state_to_numpy(state: DycoreState) -> dict:
    """The inverse of :func:`state_from_numpy`: a dict of numpy arrays."""
    def n(x):
        return x.detach().cpu().numpy()

    return {
        "delp": n(state.delp),
        "pt": n(state.pt),
        "wind": n(state.wind),
        "tracers": {k: n(v) for k, v in state.tracers.items()},
        "phis": n(state.phis),
    }
