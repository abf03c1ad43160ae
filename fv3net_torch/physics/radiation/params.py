"""Band structure of the synthetic band model (a copy of
``fv3net_tpu/physics/radiation/params.py``, numpy only; the two must
stay identical below this docstring; tests/test_torch_synthband.py
holds them so).

Reference: external/radiation/radiation/radlw/radlw_param.py:1-260 and
radsw/radsw_param.py:1-300 -- band counts, per-band g-point counts, and
band wavenumber limits are the published RRTMG_LW/RRTMG_SW spectral
discretization (Mlawer et al. 1997; Iacono et al. 2008).
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- longwave
NBANDS_LW = 16
# g-points per LW band (radlw_param.py ng01..ng16)
NG_LW = np.array([10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2])
NGPT_LW = int(NG_LW.sum())  # 140
# band wavenumber limits [cm^-1] (radlw_param.py wvnlw1/wvnlw2)
WVN1_LW = np.array(
    [10.0, 350.0, 500.0, 630.0, 700.0, 820.0, 980.0, 1080.0,
     1180.0, 1390.0, 1480.0, 1800.0, 2080.0, 2250.0, 2380.0, 2600.0]
)
WVN2_LW = np.array(
    [350.0, 500.0, 630.0, 700.0, 820.0, 980.0, 1080.0, 1180.0,
     1390.0, 1480.0, 1800.0, 2080.0, 2250.0, 2380.0, 2600.0, 3250.0]
)

# --------------------------------------------------------------- shortwave
NBANDS_SW = 14
# g-points per SW band, bands 16-29 (radsw_param.py NG16..NG29)
NG_SW = np.array([6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12])
NGPT_SW = int(NG_SW.sum())  # 112
# band wavenumber limits [cm^-1] (radsw_param.py wvnum1/wvnum2); the last
# band (820-2600) wraps around to the thermal IR end of the solar spectrum.
WVN1_SW = np.array(
    [2600.0, 3250.0, 4000.0, 4650.0, 5150.0, 6150.0, 7700.0, 8050.0,
     12850.0, 16000.0, 22650.0, 29000.0, 38000.0, 820.0]
)
WVN2_SW = np.array(
    [3250.0, 4000.0, 4650.0, 5150.0, 6150.0, 7700.0, 8050.0, 12850.0,
     16000.0, 22650.0, 29000.0, 38000.0, 50000.0, 2600.0]
)
# internal solar constant of the spectral data [W/m2] (radsw_param.py s0)
S0 = 1368.22

# diffusivity angle secant for LW flux integration (radlw_param.py a0/bpade
# machinery collapses to the standard 1.66 for the flux transmittance)
DIFFUSIVITY = 1.66

# gas indices in the vmr stack handed to the optics
GASES = ("h2o", "co2", "o3", "ch4", "n2o", "o2")
NGAS = len(GASES)


def band_expand(per_band: np.ndarray, ng: np.ndarray) -> np.ndarray:
    """Repeat a per-band value onto g-points: [nbands,...] -> [ngpt,...]."""
    return np.repeat(np.asarray(per_band), ng, axis=0)


def gpoint_intervals(ng_band: int) -> tuple[np.ndarray, np.ndarray]:
    """Cumulative-probability midpoints + weights for one band's g-points.

    RRTMG concentrates g-resolution near g=1 where the absorption
    coefficient varies fastest; a quadratic taper of the interval edges
    reproduces that refinement.
    """
    i = np.arange(ng_band + 1, dtype=np.float64)
    edges = 1.0 - (1.0 - i / ng_band) ** 2
    mid = 0.5 * (edges[:-1] + edges[1:])
    weights = np.diff(edges)
    return mid, weights
