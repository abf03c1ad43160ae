"""RRTMG spectral constants (published model spec); a copy of the
numpy-only ``fv3net_tpu/physics/radiation/rrtmg/params.py``.

These are the fixed spectral-discretization constants of RRTMG-LW v4.82
/ RRTMG-SW v5.1 (band counts, g-points per band, reference-atmosphere
grid sizes).  reference: external/radiation/radiation/radlw/radlw_param.py
and radsw/radsw_param.py — they are part of the published RRTM spec
(Mlawer et al. 1997; Iacono et al. 2008), not tunable data.
"""
import numpy as np

# ---------------------------------------------------------------- longwave
NBANDS_LW = 16
NGPT_LW = 140
MAXGAS = 7  # h2o, co2, o3, n2o, ch4, o2, co
MAXXSEC = 4  # ccl4, cfc11, cfc12, cfc22
NRATES = 6
NPLNK = 181
NTBL = 10000  # transmittance lookup table resolution

# g-points per LW band
NG_LW = (10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2)
# starting g-index of each band
NS_LW = tuple(int(x) for x in np.concatenate([[0], np.cumsum(NG_LW)[:-1]]))
# band index (0-based) for each g-point
NGB_LW = np.repeat(np.arange(NBANDS_LW), NG_LW)

# number of reference-atmosphere key-species columns per band
NSPA_LW = (1, 1, 9, 9, 9, 1, 9, 1, 9, 1, 1, 9, 9, 1, 9, 9)
NSPB_LW = (1, 1, 5, 5, 5, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0, 0)

# band wavenumber widths (cm-1) — weights the Planck table
DELWAVE_LW = np.array(
    [340.0, 150.0, 130.0, 70.0, 120.0, 160.0, 100.0, 100.0,
     210.0, 90.0, 320.0, 280.0, 170.0, 130.0, 220.0, 650.0]
)

# Ebert&Curry ice band index per LW band (ilwcice=1)
IPAT = (1, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5)

# diffusivity-angle fit coefficients per band (secdiff)
A0_LW = np.array([1.66, 1.55, 1.58, 1.66, 1.54, 1.454, 1.89, 1.33,
                  1.668, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66])
A1_LW = np.array([0.00, 0.25, 0.22, 0.00, 0.13, 0.446, -0.10, 0.40,
                  -0.006, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00])
A2_LW = np.array([0.00, -12.0, -11.7, 0.00, -0.72, -0.243, 0.19,
                  -0.062, 0.414, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00,
                  0.00])

ABSRAIN = 0.33e-3  # rain drop absorption coefficient m^2/g (ncar)
ABSSNOW0 = 1.5  # snow flake absorption coefficient micron (fu)

EPS = 1.0e-6
ONEMINUS = 1.0 - EPS
BPADE = 1.0 / 0.278
WTDIFF = 0.5
FLUXFAC = np.pi * 2.0e4
CLDMIN = 1.0e-80

# physical constants (GFS phys_const values)
CON_G = 9.80665
CON_CP = 1.0046e3
CON_AVGD = 6.0221415e23
CON_AMD = 28.9644
CON_AMW = 18.0154
CON_AMO3 = 47.9982
AMDW = CON_AMD / CON_AMW
AMDO3 = CON_AMD / CON_AMO3
HEATFAC = CON_G * 1.0e-2 / CON_CP  # K/s (ilwrate=2)

# ---------------------------------------------------------------- shortwave
NBANDS_SW = 14
NGPT_SW = 112
NG_SW = (6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12)
NS_SW = tuple(int(x) for x in np.concatenate([[0], np.cumsum(NG_SW)[:-1]]))
NGB_SW = np.repeat(np.arange(NBANDS_SW), NG_SW)
NSPA_SW = (9, 9, 9, 9, 1, 9, 9, 1, 9, 1, 0, 1, 9, 1)
NSPB_SW = (1, 5, 1, 1, 1, 5, 1, 0, 1, 0, 0, 1, 5, 1)
NBLOW = 16  # first SW band number (RRTMG band numbering 16..29)
# surface-flux spectral group per band: 1 nir, 2 uv+vis, 0 split
IDXSFC_SW = (1, 1, 1, 1, 1, 1, 1, 1, 0, 2, 2, 2, 2, 1)
# Ebert&Curry ice band index per SW band
IDXEBC_SW = (5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 1, 5)
NUVB_SW = 27  # uv-b band number
S0_SW = 1368.22  # internal solar constant W/m^2
FTINY = 1.0e-12
FLIMIT = 1.0e-20
