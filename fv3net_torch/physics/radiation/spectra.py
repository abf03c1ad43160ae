"""Locally generated spectral data of the synthetic band model (a copy
of ``fv3net_tpu/physics/radiation/spectra.py``, numpy only; the two must
stay identical below this docstring but for the import of ``params``
and numpy's trapezoid rule, taken under its older name where numpy
lacks the new one; tests/test_torch_synthband.py holds them so).

A stand-in k-distribution with RRTMG's spectral structure (16 LW bands /
140 g-points, 14 SW bands / 112 g-points, per-band major/minor gases,
g-quadrature refined toward g=1): lognormal line strengths per band and
gas, pressure broadening k ~ (p/p0)^a and a weak exponential temperature
dependence in closed form, and exact Planck/solar band partitions fit to
polynomials in T.  Everything here runs once, in numpy, and is cached.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from fv3net_torch.physics.radiation import params as P

# Planck constants (SI)
_H = 6.62607015e-34
_C = 2.99792458e8
_KB = 1.380649e-23
T_SUN = 5778.0

# reference state for the k scaling
P_REF = 1.0e5  # Pa
T_REF = 250.0  # K

# per-gas pressure-broadening exponent & temperature coefficient [1/K]
# (h2o, co2, o3, ch4, n2o, o2)
_P_EXP_LW = np.array([0.8, 0.85, 0.3, 0.75, 0.75, 0.7])
_T_COEF_LW = np.array([0.004, 0.003, 0.001, 0.002, 0.002, 0.0])
_P_EXP_SW = np.array([0.75, 0.8, 0.0, 0.7, 0.7, 0.6])
_T_COEF_SW = np.array([0.003, 0.002, 0.0, 0.002, 0.002, 0.0])

# lognormal spread of ln(k) across each band's g-axis
_SIGMA_LW = 2.8
_SIGMA_SW = 2.2

# ------------------------------------------------------------------
# Band-mean absorption strengths [m^2 / kg of gas] at (P_REF, T_REF).
# Columns: h2o, co2, o3, ch4, n2o, o2. The first nonzero entry scanned
# left-to-right is the band's MAJOR gas (gets the full k(g)
# distribution); the others contribute their band mean, gray-in-band.
# LW band gas assignments follow RRTMG_LW (Mlawer et al. 1997 table 2).
_KBAR_LW = np.array([
    #  h2o    co2     o3    ch4    n2o     o2
    [10.0,   0.0,   0.0,   0.0,   0.0,   0.0],  # 1: 10-350  H2O rotation
    [2.0,    0.0,   0.0,   0.0,   0.0,   0.0],  # 2: 350-500 H2O rotation
    [0.5,    0.5,   0.0,   0.0,   0.0,   0.0],  # 3: 500-630 H2O,CO2
    [0.1,   50.0,   0.0,   0.0,   0.0,   0.0],  # 4: 630-700 CO2 15um core
    [0.05,   5.0,   5.0,   0.0,   0.0,   0.0],  # 5: 700-820 CO2 wing (+O3)
    [0.012,  0.05,  0.0,   0.0,   0.0,   0.0],  # 6: 820-980 window
    [0.008,  0.0, 250.0,   0.0,   0.0,   0.0],  # 7: 980-1080 O3 9.6um
    [0.015,  0.02, 30.0,   0.0,   0.0,   0.0],  # 8: 1080-1180 window
    [0.3,    0.0,   0.0,  30.0,  30.0,   0.0],  # 9: 1180-1390 CH4,N2O
    [10.0,   0.0,   0.0,   0.0,   0.0,   0.0],  # 10: 1390-1480 H2O 6.3um
    [5.0,    0.0,   0.0,   0.0,   0.0,   0.0],  # 11: 1480-1800 H2O 6.3um
    [0.3,    0.2,   0.0,   0.0,   0.0,   0.0],  # 12: 1800-2080
    [0.05,   0.5,   0.0,   0.0,  10.0,   0.0],  # 13: 2080-2250 N2O,CO2
    [0.0,  100.0,   0.0,   0.0,   0.0,   0.0],  # 14: 2250-2380 CO2 4.3um
    [0.0,   10.0,   0.0,   0.0,  20.0,   0.0],  # 15: 2380-2600 N2O,CO2
    [0.5,    0.0,   0.0,   5.0,   0.0,   0.0],  # 16: 2600-3250 H2O,CH4
])
# H2O self-continuum strength per band [m^2/kg per (e / 1000 Pa)] — only
# significant in the 8-12um window (e-type continuum).
_KSELF_LW = np.array(
    [0.0, 0.01, 0.02, 0.0, 0.01, 0.05, 0.03, 0.05,
     0.01, 0.0, 0.0, 0.01, 0.0, 0.0, 0.0, 0.01]
)

# SW band gas assignments follow RRTMG_SW (Iacono et al. 2008); bands are
# 16..29 in RRTMG numbering, index 0..13 here.
_KBAR_SW = np.array([
    #  h2o    co2     o3    ch4    n2o      o2
    [0.4,    0.0,   0.0,   3.0,   0.0,   0.0],   # 16: 2600-3250
    [1.5,    0.5,   0.0,   0.0,   0.0,   0.0],   # 17: 3250-4000
    [0.15,   0.0,   0.0,   1.0,   0.0,   0.0],   # 18: 4000-4650
    [0.3,    1.0,   0.0,   0.0,   0.0,   0.0],   # 19: 4650-5150
    [0.4,    0.0,   0.0,   0.5,   0.0,   0.0],   # 20: 5150-6150 1.87um
    [0.6,    0.5,   0.0,   0.0,   0.0,   0.0],   # 21: 6150-7700 1.38um
    [0.05,   0.0,   0.0,   0.0,   0.0, 1.0e-5],  # 22: 7700-8050 O2 1.27um
    [0.06,   0.0,   0.0,   0.0,   0.0,   0.0],   # 23: 8050-12850 0.94um
    [0.01,   0.0,   1.0,   0.0,   0.0, 2.0e-5],  # 24: 12850-16000 O2-A
    [1.0e-3, 0.0,   3.0,   0.0,   0.0,   0.0],   # 25: 16000-22650 Chappuis
    [0.0,    0.0,   0.0,   0.0,   0.0,   0.0],   # 26: 22650-29000 Rayleigh
    [0.0,    0.0, 600.0,   0.0,   0.0,   0.0],   # 27: 29000-38000 Huggins
    [0.0,    0.0, 5.0e3,   0.0,   0.0, 1.0e-4],  # 28: 38000-50000 Hartley
    [5.0,    1.0,   0.0,   0.0,   0.0,   0.0],   # 29: 820-2600 NIR H2O
])

_PLANCK_DEG = 8
_T_LO, _T_HI = 160.0, 360.0


def _planck_band_power(T: np.ndarray, wvn1: float, wvn2: float) -> np.ndarray:
    """pi * integral of B_nu(T) over [wvn1, wvn2] cm^-1  -> W/m^2."""
    nu = np.linspace(wvn1 * 100.0, wvn2 * 100.0, 2000)  # m^-1
    x = _H * _C * nu[None, :] / (_KB * np.asarray(T)[:, None])
    b = 2.0 * np.pi * _H * _C ** 2 * nu[None, :] ** 3 / np.expm1(x)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return trapezoid(b, nu, axis=1)


@functools.lru_cache(maxsize=None)
def planck_band_coefs() -> np.ndarray:
    """Polynomial coefficients c[deg+1, nbands]: E_band(T) = sum_d c[d] (T/T0)^d.

    Fit over 160-360 K against the exact band Planck integral; max relative
    error < 0.3% (asserted by tests/test_rrtmg.py)."""
    T = np.linspace(_T_LO, _T_HI, 201)
    X = np.vander(T / T_REF, _PLANCK_DEG + 1, increasing=True)  # [nT, deg+1]
    coefs = np.empty((_PLANCK_DEG + 1, P.NBANDS_LW))
    for b in range(P.NBANDS_LW):
        y = _planck_band_power(T, P.WVN1_LW[b], P.WVN2_LW[b])
        coefs[:, b] = np.linalg.lstsq(X, y, rcond=None)[0]
    return coefs


@functools.lru_cache(maxsize=None)
def solar_band_fraction() -> np.ndarray:
    """Fraction of the solar constant in each SW band (Planck at 5778 K,
    normalized over the 14 bands)."""
    frac = np.array(
        [_planck_band_power(np.array([T_SUN]), P.WVN1_SW[b], P.WVN2_SW[b])[0]
         for b in range(P.NBANDS_SW)]
    )
    return frac / frac.sum()


def rayleigh_band_coeff() -> np.ndarray:
    """Whole-atmosphere Rayleigh optical depth per band at p_sfc=1013.25 hPa
    (Hansen & Travis 1974 fit: tau = 0.00877 lambda_um^-4.05)."""
    lam_um = 1.0e4 / np.sqrt(P.WVN1_SW * P.WVN2_SW)  # geometric-mean lambda
    return 0.00877 * lam_um ** -4.05


class KDist(NamedTuple):
    """Correlated-k data expanded onto g-points (numpy, built once)."""

    kmaj: np.ndarray        # [ngpt] major-gas k at (P_REF, T_REF), m^2/kg
    major_gas: np.ndarray   # [ngpt] int index into params.GASES
    kminor: np.ndarray      # [nbands, ngas] gray-in-band minor k
    k_self: np.ndarray      # [nbands] h2o e-type continuum strength
    p_exp: np.ndarray       # [ngas]
    t_coef: np.ndarray      # [ngas]
    gwt: np.ndarray         # [ngpt] quadrature weights (sum to 1 per band)
    band_of_gpt: np.ndarray  # [ngpt] int


def _build_kdist(kbar: np.ndarray, ng: np.ndarray, sigma: float,
                 p_exp: np.ndarray, t_coef: np.ndarray,
                 k_self: np.ndarray) -> KDist:
    nbands = kbar.shape[0]
    kmaj, major, gwt, band_of = [], [], [], []
    kminor = kbar.copy()
    for b in range(nbands):
        nzb = np.nonzero(kbar[b])[0]
        gmaj = int(nzb[np.argmax(kbar[b, nzb])]) if nzb.size else -1
        mid, wts = P.gpoint_intervals(int(ng[b]))
        if gmaj >= 0:
            # lognormal inverse CDF with mean kbar (mean of lognormal is
            # exp(mu + sigma^2/2) -> mu = ln(kbar) - sigma^2/2)
            from scipy.special import erfinv

            z = np.sqrt(2.0) * erfinv(2.0 * mid - 1.0)
            mu = np.log(kbar[b, gmaj]) - 0.5 * sigma ** 2
            kg = np.exp(mu + sigma * z)
            kminor[b, gmaj] = 0.0
        else:
            kg = np.zeros(len(mid))
        kmaj.append(kg)
        major.append(np.full(len(mid), max(gmaj, 0), dtype=np.int32))
        gwt.append(wts)
        band_of.append(np.full(len(mid), b, dtype=np.int32))
    return KDist(
        kmaj=np.concatenate(kmaj),
        major_gas=np.concatenate(major),
        kminor=kminor,
        k_self=k_self,
        p_exp=p_exp,
        t_coef=t_coef,
        gwt=np.concatenate(gwt),
        band_of_gpt=np.concatenate(band_of),
    )


@functools.lru_cache(maxsize=None)
def lw_kdist() -> KDist:
    return _build_kdist(_KBAR_LW, P.NG_LW, _SIGMA_LW, _P_EXP_LW,
                        _T_COEF_LW, _KSELF_LW)


@functools.lru_cache(maxsize=None)
def sw_kdist() -> KDist:
    return _build_kdist(_KBAR_SW, P.NG_SW, _SIGMA_SW, _P_EXP_SW,
                        _T_COEF_SW, np.zeros(P.NBANDS_SW))
