"""Standard dycore test cases on tensors (port of
``fv3net_tpu/dycore/testcases.py``).

Jablonowski & Williamson (2006, QJRMS 132: "A baroclinic instability
test case for atmospheric model dynamical cores"): the balanced zonally
symmetric jet (steady state) and its perturbed variant (baroclinic wave
growth); and a resting isothermal atmosphere over an isolated mountain
(pressure-gradient balance over terrain).  The published profiles are
evaluated in float64 numpy on the cubed-sphere layers (eta = pmid / p0)
and placed on ``device`` in ``dtype``; the JW06 virtual potential
temperature is formed from them in ``dtype``, as the reference forms it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fv3net_torch.core.constants import (
    GRAVITY,
    KAPPA,
    RDGAS,
    REFERENCE_SURFACE_PRESSURE,
)
from fv3net_torch.dycore import vertical
from fv3net_torch.dycore.state import DycoreState, theta_v_from_temperature
from fv3net_torch.grid.geometry import EARTH_RADIUS, Grid

U0 = 35.0          # jet amplitude [m/s]
ETA0 = 0.252       # jet core eta
T0 = 288.0         # surface mean temperature [K]
GAMMA = 0.005      # lapse rate [K/m]
DELTA_T = 4.8e5    # stratosphere temperature parameter [K]
ETA_T = 0.2        # tropopause eta
OMEGA = 7.292e-5   # rotation rate [1/s]
P00 = 1.0e5


def _t_mean(eta: np.ndarray) -> np.ndarray:
    t = T0 * eta ** (RDGAS * GAMMA / GRAVITY)
    return t + np.where(eta < ETA_T, DELTA_T * (ETA_T - eta) ** 5, 0.0)


def _u_wind(eta: np.ndarray, lat: np.ndarray) -> np.ndarray:
    etav = 0.5 * np.pi * (eta - ETA0)
    return U0 * np.cos(etav) ** 1.5 * np.sin(2.0 * lat) ** 2


def _temperature(eta: np.ndarray, lat: np.ndarray) -> np.ndarray:
    """JW06 eq. (6): T = T_mean + horizontal variation."""
    a = EARTH_RADIUS
    etav = 0.5 * np.pi * (eta - ETA0)
    cosv = np.cos(etav)
    sinv = np.sin(etav)
    s2 = np.sin(lat) ** 2
    c2 = np.cos(lat) ** 2
    term1 = (-2.0 * s2 ** 3 * (c2 + 1.0 / 3.0) + 10.0 / 63.0) * (
        2.0 * U0 * cosv ** 1.5
    )
    term2 = (
        (8.0 / 5.0) * np.cos(lat) ** 3 * (s2 + 2.0 / 3.0) - 0.25 * np.pi
    ) * a * OMEGA
    return _t_mean(eta) + 0.75 * (eta * np.pi * U0 / RDGAS) * sinv * np.sqrt(
        cosv
    ) * (term1 + term2)


def _surface_geopotential(lat: np.ndarray) -> np.ndarray:
    """JW06 eq. (7): Phi_s balancing the jet at eta = 1."""
    a = EARTH_RADIUS
    etavs = 0.5 * np.pi * (1.0 - ETA0)
    cosvs = np.cos(etavs) ** 1.5
    s2 = np.sin(lat) ** 2
    c2 = np.cos(lat) ** 2
    term1 = (-2.0 * s2 ** 3 * (c2 + 1.0 / 3.0) + 10.0 / 63.0) * (
        U0 * cosvs
    )
    term2 = (
        (8.0 / 5.0) * np.cos(lat) ** 3 * (s2 + 2.0 / 3.0) - 0.25 * np.pi
    ) * a * OMEGA
    return U0 * cosvs * (term1 + term2)


def baroclinic_wave_state(
    grid: Grid, nz: int = 20, perturb: bool = True, dtype=torch.float32,
    device="cuda",
) -> Tuple[DycoreState, np.ndarray, np.ndarray]:
    """JW06 initial state on the cubed sphere; returns (state, ak, bk).

    perturb=False gives the balanced steady jet (any evolution is
    numerical error); perturb=True adds the Gaussian u-bump at
    (20E, 40N) that seeds the baroclinic wave.
    """
    ak, bk = vertical.hybrid_coordinate(nz)
    lat, lon = grid.lat, grid.lon  # [6, n, n]
    ps = P00 * np.ones_like(lat)
    pe = ak[:, None, None, None] + bk[:, None, None, None] * ps[None]
    delp = pe[1:] - pe[:-1]  # [nz, 6, n, n]
    pmid = 0.5 * (pe[1:] + pe[:-1])
    eta = pmid / P00

    latb = np.broadcast_to(lat, eta.shape)
    u = _u_wind(eta, latb)
    T = _temperature(eta, latb)
    if perturb:
        lon_c, lat_c = np.deg2rad(20.0), np.deg2rad(40.0)
        r = EARTH_RADIUS * np.arccos(np.clip(
            np.sin(lat_c) * np.sin(lat)
            + np.cos(lat_c) * np.cos(lat) * np.cos(lon - lon_c), -1.0, 1.0,
        ))
        u = u + 1.0 * np.exp(-((r / (EARTH_RADIUS / 10.0)) ** 2))

    # zonal wind -> Cartesian components along the unit east vector
    east = np.stack([-np.sin(lon), np.cos(lon), np.zeros_like(lon)])
    wind = east[:, None] * u[None]  # [3, nz, 6, n, n]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    delp_t = t(np.moveaxis(delp, 0, 1))  # [6, nz, n, n]
    q = torch.zeros_like(delp_t) + 1e-6
    pt = theta_v_from_temperature(t(np.moveaxis(T, 0, 1)),
                                  t(np.moveaxis(pmid, 0, 1)), q)
    state = DycoreState(
        delp=delp_t,
        pt=pt,
        wind=t(np.moveaxis(wind, 1, 2)),  # [3, 6, nz, n, n]
        tracers={"sphum": q, "cloud_water": torch.zeros_like(q)},
        phis=t(_surface_geopotential(lat)),
    )
    return state, ak, bk


def mountain_rest_state(
    grid: Grid, nz: int, h_max: float = 2000.0, t0: float = 288.0,
    dtype=torch.float64, device="cuda",
) -> Tuple[DycoreState, np.ndarray, np.ndarray]:
    """Resting isothermal atmosphere over an isolated cosine-bell
    mountain at (90E, 30N): any circulation is discretization error of
    -grad(phi) - R Tv grad(ln p) over terrain-following layers.  Surface
    pressure follows ps = p00 exp(-phis / (R t0)), so the exact solution
    is rest.  Returns (state, ak, bk)."""
    lon, lat = grid.lon, grid.lat
    lon_c, lat_c = np.deg2rad(90.0), np.deg2rad(30.0)
    r = np.arccos(np.clip(
        np.sin(lat_c) * np.sin(lat)
        + np.cos(lat_c) * np.cos(lat) * np.cos(lon - lon_c), -1.0, 1.0,
    ))
    r0 = np.deg2rad(20.0)
    h = np.where(r < r0, 0.5 * h_max * (1.0 + np.cos(np.pi * r / r0)), 0.0)
    phis = GRAVITY * h
    ps = REFERENCE_SURFACE_PRESSURE * np.exp(-phis / (RDGAS * t0))

    ak, bk = vertical.hybrid_coordinate(nz)
    pe = ak[:, None, None, None] + bk[:, None, None, None] * ps[None]
    delp = np.diff(pe, axis=0)  # [nz, 6, n, n]
    pmid = delp / np.diff(np.log(pe), axis=0)
    theta = t0 * (REFERENCE_SURFACE_PRESSURE / pmid) ** KAPPA

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    delp_t = t(np.moveaxis(delp, 0, 1))
    shape3 = tuple(delp_t.shape)
    kw = dict(dtype=dtype, device=delp_t.device)
    state = DycoreState(
        delp=delp_t,
        pt=t(np.moveaxis(theta, 0, 1)),
        wind=torch.zeros((3,) + shape3, **kw),
        tracers={"sphum": torch.full(shape3, 1e-6, **kw),
                 "cloud_water": torch.zeros(shape3, **kw)},
        phis=t(phis),
    )
    return state, ak, bk
