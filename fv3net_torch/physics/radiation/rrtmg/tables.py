"""K-distribution table schemas + synthetic fabrication (a copy of the
numpy-only ``fv3net_tpu/physics/radiation/rrtmg/tables.py``; a test holds
every array of both dicts bitwise equal to the original's).

The real RRTMG lookup tables live on GCS in the reference deployment
(external/radiation/radiation/config.py:4-5 — unreachable here), but the
solvers take them as a plain dict of arrays (``lwdict``/``swdict``,
external/radiation/radiation/radlw/radlw_main.py:1492-1560, io.py:29-180).
This module documents every table's shape and fabricates synthetic,
smooth, positive tables at those shapes from a seed.  The SAME dict
drives the reference package's solvers, this port's, and the reference's
in-tree Python solvers.

If the real tables become available, load them with the reference's
netCDF layout and pass them in place of the synthetic dict — the solver
is agnostic.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from fv3net_torch.physics.radiation.rrtmg import params as P

# per-band minor-gas / cfc table inventory for the LW
# (name -> kind): kind "m1" = [ng, 19] minor, "m2" = [ng, 9, 19]
# species-dependent minor, "m2u" = [ng, 5, 19] upper species-dependent,
# "cfc" = [ng]
LW_BAND_MINORS = {
    0: {"ka_mn2": "m1"},
    2: {"ka_mn2o": "m2", "kb_mn2o": "m2u"},
    4: {"ka_mo3": "m2", "ccl4": "cfc"},
    5: {"ka_mco2": "m1", "cfc11adj": "cfc", "cfc12": "cfc"},
    6: {"ka_mco2": "m2", "kb_mco2": "m1"},
    7: {"ka_mo3": "m1", "ka_mco2": "m1", "kb_mco2": "m1", "cfc12": "cfc",
        "ka_mn2o": "m1", "kb_mn2o": "m1", "cfc22adj": "cfc"},
    8: {"ka_mn2o": "m2", "kb_mn2o": "m1"},
    10: {"ka_mo2": "m1", "kb_mo2": "m1"},
    12: {"ka_mco2": "m2", "ka_mco": "m2", "kb_mo3": "m1"},
    14: {"ka_mn2": "m2"},
}
# bands whose lower-atmosphere key is a 2-species combination
LW_TWO_SPECIES_LOWER = (2, 3, 4, 6, 8, 11, 12, 14, 15)
# bands whose upper-atmosphere key is a 2-species combination
LW_TWO_SPECIES_UPPER = (2, 3, 4)
# bands with no absb (nothing above the troposphere)
LW_NO_UPPER = (5, 11, 14)  # band 6 has cfc-only, 12/15 zero
LW_NO_UPPER_TABLE = (5, 11, 12, 14)  # no absb table present


# ---------------------------------------------------------------------------
# Stratospheric-balance calibration of the fabricated spectroscopy
# (r3 verdict #7; scripts/calibrate_ktables.py).  The raw random draw
# gave ~+28 K/day SW ozone heating in sunlit columns against the driver
# ozone climatology with only ~-0.1 K/day LW cooling-to-space above
# 100 hPa — the top-of-model runaway of the r3 coupled soak.  These
# factors scale the UPPER-ATMOSPHERE tables only (absb, abso3) so the
# clear-sky net heating above 100 hPa sits at ~-0.3 +- 0.45 K/day
# around a 235 K stratosphere (bounded optimization of the
# differentiable solvers on a 3-profile battery with the driver's own
# ozone; diurnal-quadrature SW at solcon 1368).  The thermal top
# sponge default is retired on the strength of this balance
# (physics/driver.py top_sponge_days=0).
LW_ABSB_CAL = {
    0: 4.0681, 1: 3.6331, 2: 11.2072, 3: 3.5592, 4: 3.7162, 6: 3.3771, 7: 3.3037, 8: 3.0579, 9: 3.7991, 10: 3.8556, 13: 6.1503, 15: 2.6593,
}
SW_ABSB_CAL = {
    0: 0.0782, 1: 0.0127, 2: 0.0787, 3: 0.0237, 4: 0.0693, 5: 0.0225, 6: 0.0061, 8: 0.007, 11: 0.0706, 12: 0.0074, 13: 0.0238,
}
SW_O3_CAL = 0.0819


def _rows_a(nspa: int) -> int:
    # lower-atmosphere k-table rows: 13 ref pressures x 5 ref temps x
    # nspa key-species columns, + stencil slack (the 3-point species
    # stencil reads up to +11 beyond the base index)
    return 13 * 5 * nspa + 3 * nspa + 16


def _rows_b(nspb: int) -> int:
    # upper-atmosphere: 47 ref pressures x 5 ref temps x nspb columns
    return 235 * max(nspb, 1) + 16


def _smooth(rng, shape, scale):
    """Smooth positive random table: low-frequency lognormal field."""
    raw = rng.standard_normal(shape)
    # smooth along every axis with a small box filter
    for ax in range(len(shape)):
        if shape[ax] >= 3:
            raw = (
                raw
                + np.roll(raw, 1, axis=ax)
                + np.roll(raw, -1, axis=ax)
            ) / 3.0
    return scale * np.exp(0.6 * raw)


def make_lw_tables(seed: int = 0) -> Dict:
    """Fabricate a complete ``lwdict`` with the reference solver's table
    layout (radlw_main.py:1492-1560): planck/reference data, cloud
    optics tables, and per-band k-distributions ``radlw_kgb01..16``."""
    rng = np.random.default_rng(seed)
    d: Dict = {}

    # integrated Planck function per band vs temperature (159..339 K);
    # smooth, monotone in T, normalized so the surface upward flux at
    # 288 K matches sigma*T^4 (sum_b delwave*totplnk * wtdiff*fluxfac)
    t_grid = 159.0 + np.arange(P.NPLNK)
    shape = (t_grid[:, None] / 288.0) ** 4.2 * (
        1.0 + 0.2 * rng.random(P.NBANDS_LW)
    )[None, :] / P.DELWAVE_LW[None, :]
    sigma = 5.670374e-8
    i288 = int(288.0 - 159.0)
    target = (sigma * 288.0 ** 4) / (0.5 * np.pi * 2.0e4)
    total_288 = float((P.DELWAVE_LW * shape[i288]).sum())
    d["totplnk"] = shape * (target / total_288)
    # ln reference pressures: exactly the grid the jp index math assumes
    d["preflog"] = 6.96 - 0.2 * np.arange(59)
    # reference temperatures at those pressures (smooth profile)
    d["tref"] = 288.0 - 1.5 * np.arange(59) + 20.0 * np.exp(
        -((np.arange(59) - 40.0) / 10.0) ** 2
    )
    # reference minor-gas mixing ratios [7 gases, 59 levels]
    chi = np.empty((7, 59))
    chi[0] = 8.0e-3 * np.exp(-np.arange(59) / 6.0) + 3.0e-6  # h2o
    chi[1] = 3.55e-4  # co2
    chi[2] = 3.0e-8 + 8.0e-6 * np.exp(-((np.arange(59) - 22.0) / 7.0) ** 2)
    chi[3] = 3.2e-7 * np.exp(-np.arange(59) / 50.0)  # n2o
    chi[4] = 1.7e-6  # ch4
    chi[5] = 0.209  # o2
    chi[6] = 1.5e-7  # co
    d["chi_mls"] = chi

    # cloud optics tables (Hu&Stamnes liquid, 3 ice parameterizations)
    d["absliq1"] = _smooth(rng, (58, P.NBANDS_LW), 0.08)
    d["absice0"] = np.array([0.005, 1.0])
    d["absice1"] = _smooth(rng, (2, 5), 0.005) + np.array([[0.002], [3.0]])
    d["absice2"] = _smooth(rng, (43, P.NBANDS_LW), 0.004)
    d["absice3"] = _smooth(rng, (46, P.NBANDS_LW), 0.004)

    for b in range(P.NBANDS_LW):
        ng = P.NG_LW[b]
        band: Dict = {}
        band["selfref"] = _smooth(rng, (ng, 10), 0.3)
        band["forref"] = _smooth(rng, (ng, 4), 0.1)
        band["absa"] = _smooth(rng, (ng, _rows_a(P.NSPA_LW[b])), 4.0e-3)
        if b not in LW_NO_UPPER_TABLE:
            band["absb"] = LW_ABSB_CAL.get(b, 1.0) * _smooth(
                rng, (ng, _rows_b(P.NSPB_LW[b])), 2.0e-3
            )
        if b in LW_TWO_SPECIES_LOWER:
            band["fracrefa"] = _smooth(rng, (ng, 9), 1.0 / ng)
        else:
            band["fracrefa"] = _smooth(rng, (ng,), 1.0 / ng)
        if b in LW_TWO_SPECIES_UPPER:
            band["fracrefb"] = _smooth(rng, (ng, 5), 1.0 / ng)
        elif b in (11, 14):  # bands 12/15: no upper fracs at all
            pass
        else:
            band["fracrefb"] = _smooth(rng, (ng,), 1.0 / ng)
        for name, kind in LW_BAND_MINORS.get(b, {}).items():
            if kind == "m1":
                band[name] = _smooth(rng, (ng, 19), 1.0e-7)
            elif kind == "m2":
                band[name] = _smooth(rng, (ng, 9, 19), 1.0e-7)
            elif kind == "m2u":
                band[name] = _smooth(rng, (ng, 5, 19), 1.0e-7)
            else:  # cfc: per-g cross sections
                band[name] = _smooth(rng, (ng,), 1.0e-4)
        # bands 6/13 carry fracrefb despite absent absb (cfc/o3 upper)
        if b == 5:
            band.pop("fracrefb", None)
        d[f"radlw_kgb{b + 1:02d}"] = band

    # normalize planck fractions so each band's fracs sum ~1 over g
    for b in range(P.NBANDS_LW):
        band = d[f"radlw_kgb{b + 1:02d}"]
        for key in ("fracrefa", "fracrefb"):
            if key in band:
                f = band[key]
                band[key] = f / f.sum(axis=0, keepdims=True).clip(1e-30)
    return d


# SW band k-table inventory (io.py:252-282); band index is 0-based
# (RRTMG band = 16+b).  Values: table name -> kind.
SW_BAND_TABLES = {
    0: {"selfref": "s", "forref": "f", "absa": "a", "absb": "b",
        "rayl": "r0"},
    1: {"selfref": "s", "forref": "f", "absa": "a", "absb": "b",
        "rayl": "r0"},
    2: {"selfref": "s", "forref": "f", "absa": "a", "absb": "b",
        "rayl": "r0"},
    3: {"selfref": "s", "forref": "f", "absa": "a", "absb": "b",
        "rayl": "r0"},
    4: {"selfref": "s", "forref": "f", "absa": "a", "absb": "b",
        "absch4": "g", "rayl": "r0"},
    5: {"selfref": "s", "forref": "f", "absa": "a", "absb": "b",
        "rayl": "r0"},
    6: {"selfref": "s", "forref": "f", "absa": "a", "absb": "b",
        "rayl": "r0"},
    7: {"selfref": "s", "forref": "f", "absa": "a", "rayl": "rg",
        "givfac": "r0"},
    8: {"selfref": "s", "forref": "f", "absa": "a", "absb": "b",
        "abso3a": "g", "abso3b": "g", "rayla": "r2", "raylb": "rg"},
    9: {"absa": "a", "abso3a": "g", "abso3b": "g", "rayl": "rg"},
    10: {"rayl": "rg"},
    11: {"absa": "a", "absb": "b", "rayl": "rg"},
    12: {"absa": "a", "absb": "b", "rayl": "r0"},
    13: {"selfref": "s", "forref": "f", "absa": "a", "absb": "b",
         "absh2o": "g", "absco2": "g", "rayl": "r0"},
}


def make_sw_tables(seed: int = 1):
    """Fabricate a complete ``swdict`` (reference io.py:180-295 layout:
    solar-source tables, setcoef reference data, cloud optics, per-band
    k-distributions).  SW k-tables are stored rows-leading [rows, ng]."""
    rng = np.random.default_rng(seed)
    d = {}

    # solar-source spectral tables
    d["strrat"] = np.exp(rng.uniform(np.log(0.1), np.log(50.0), 14))
    specwt = np.full(14, 8.0)
    specwt[[1, 12]] = 4.0  # bands 17/28 use the 5-row sfluxref02
    d["specwt"] = specwt
    layreffr = np.full(14, 6, dtype=np.int64)
    layreffr[[1, 12]] = 30  # upper-atmosphere reference layer
    d["layreffr"] = layreffr
    # key species pairs (1-based colamt indices)
    d["ix1"] = np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 3, 3, 1])
    d["ix2"] = np.array([5, 2, 5, 2, 2, 2, 6, 2, 6, 6, 6, 2, 6, 2])
    d["ibx"] = np.arange(1, 15)
    d["sfluxref01"] = _smooth(rng, (16, 1, 14), 1.0 / P.NGPT_SW)
    d["sfluxref02"] = _smooth(rng, (16, 5, 14), 1.0 / P.NGPT_SW)
    d["sfluxref03"] = _smooth(rng, (16, 9, 14), 1.0 / P.NGPT_SW)
    d["scalekur"] = 0.935
    # the real sfluxref tables carry ABSOLUTE spectral fluxes summing to
    # the internal solar constant s0 (ssolar is the dimensionless
    # solcon/s0 * cosz); normalize so sfluxzen sums to s0 over the 112
    # g-points whatever reference column is selected
    for key in ("sfluxref01", "sfluxref02", "sfluxref03"):
        tab = d[key]
        for b in range(P.NBANDS_SW):
            ng = P.NG_SW[b]
            colsum = tab[:ng, :, b].sum(axis=0, keepdims=True)
            tab[:ng, :, b] *= P.S0_SW / (P.NBANDS_SW * colsum)
        d[key] = tab

    d["preflog"] = 6.96 - 0.2 * np.arange(59)
    d["tref"] = 288.0 - 1.5 * np.arange(59) + 20.0 * np.exp(
        -((np.arange(59) - 40.0) / 10.0) ** 2
    )

    # cloud optics
    for name, shape, scale in [
        ("extliq1", (58, 14), 0.1), ("extliq2", (58, 14), 0.1),
        ("extice2", (43, 14), 0.05), ("extice3", (46, 14), 0.05),
    ]:
        d[name] = _smooth(rng, shape, scale)
    for name, shape in [
        ("ssaliq1", (58, 14)), ("ssaliq2", (58, 14)),
        ("ssaice2", (43, 14)), ("ssaice3", (46, 14)),
    ]:
        d[name] = 0.4 + 0.55 * rng.random(shape)
    for name, shape in [
        ("asyliq1", (58, 14)), ("asyliq2", (58, 14)),
        ("asyice2", (43, 14)), ("asyice3", (46, 14)),
    ]:
        d[name] = 0.2 + 0.7 * rng.random(shape)
    d["abari"] = 0.003 + 0.002 * rng.random(5)
    d["bbari"] = 1.0 + rng.random(5)
    d["cbari"] = 0.01 * rng.random(5)
    d["dbari"] = 1e-4 * rng.random(5)
    d["ebari"] = 0.7 + 0.1 * rng.random(5)
    d["fbari"] = 1e-3 * rng.random(5)
    d["b0s"] = 0.03 * rng.random(14)
    d["b1s"] = 1e-4 * rng.random(14)
    d["b0r"] = 0.2 * rng.random(14)
    d["c0s"] = 0.5 + 0.4 * rng.random(14)
    d["c0r"] = 0.5 + 0.4 * rng.random(14)
    d["a0r"] = 3.07e-3
    d["a1r"] = 0.0
    d["a0s"] = 0.0
    d["a1s"] = 1.5

    for b in range(P.NBANDS_SW):
        ng = P.NG_SW[b]
        band = {}
        for name, kind in SW_BAND_TABLES[b].items():
            if kind == "s":
                band[name] = _smooth(rng, (10, ng), 0.02)
            elif kind == "f":
                band[name] = _smooth(rng, (4, ng), 0.01)
            elif kind == "a":
                band[name] = _smooth(
                    rng, (_rows_a(P.NSPA_SW[b]), ng), 2.0e-4
                )
            elif kind == "b":
                band[name] = SW_ABSB_CAL.get(b, 1.0) * _smooth(
                    rng, (_rows_b(P.NSPB_SW[b]), ng), 1.0e-4
                )
            elif kind == "g":  # per-g cross section
                band[name] = _smooth(rng, (ng,), 1.0e-5)
                if name in ("abso3a", "abso3b"):
                    band[name] = SW_O3_CAL * band[name]
            elif kind == "rg":  # per-g rayleigh
                band[name] = _smooth(rng, (ng,), 5.0e-7)
            elif kind == "r2":  # species-dependent rayleigh [ng, 9]
                band[name] = _smooth(rng, (ng, 9), 5.0e-7)
            else:  # scalar
                band[name] = (
                    float(_smooth(rng, (1,), 5.0e-7)[0])
                    if name == "rayl"
                    else 1.0 + 0.1 * rng.random()
                )
        d[f"radsw_kgb{b + 16}"] = band
    return d
