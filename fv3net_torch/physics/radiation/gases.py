"""Radiatively active gas amounts (port of
``fv3net_tpu/physics/radiation/gases.py``): the global-mean well-mixed gas
volume mixing ratios and the analytic ozone climatology."""
from __future__ import annotations

import torch

# molecular weights [g/mol]
_M_AIR = 28.9644
_MW = {"h2o": 18.0152, "co2": 44.0099, "o3": 47.9982, "ch4": 16.043,
       "n2o": 44.0128, "o2": 31.9988}

# global-mean volume mixing ratios (reference radiation_gases.py defaults)
CO2VMR_DEF = 348.0e-6
CH4VMR_DEF = 1.50e-6
N2OVMR_DEF = 0.31e-6
O2VMR_DEF = 0.209


def co2vmr(year: int, ico2: int = 0) -> float:
    """Global-mean CO2; ico2=0 fixed climatology, ico2>0 linear trend."""
    if ico2 == 0:
        return CO2VMR_DEF
    return 368.0e-6 + 2.1e-6 * (year - 2000)


def vmr_to_mmr(vmr, gas: str):
    return vmr * (_MW[gas] / _M_AIR)


def ozone_profile(play: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """Analytic ozone climatology, mass mixing ratio [kg/kg]: a
    lognormal-in-pressure stratospheric peak near 10 hPa (25 hPa at the
    poles) plus a small tropospheric background.

    play: [..., nz] layer pressure [Pa]; lat: [...] radians."""
    s2 = torch.sin(lat) ** 2
    p_peak = 1000.0 * (1.0 + 1.5 * s2[..., None])
    width = 1.2
    peak_vmr = 9.0e-6 * (1.0 - 0.25 * s2[..., None])
    lnp = torch.log(play / p_peak)
    strat = peak_vmr * torch.exp(-0.5 * (lnp / width) ** 2)
    tropo = 3.0e-8
    return vmr_to_mmr(strat + tropo, "o3")


def well_mixed(play: torch.Tensor, year: int = 2016, ico2: int = 0):
    """Well-mixed gas mass mixing ratios broadcast to the layers' shape."""
    one = torch.ones_like(play)
    return {
        "co2": one * vmr_to_mmr(co2vmr(year, ico2), "co2"),
        "ch4": one * vmr_to_mmr(CH4VMR_DEF, "ch4"),
        "n2o": one * vmr_to_mmr(N2OVMR_DEF, "n2o"),
        "o2": one * vmr_to_mmr(O2VMR_DEF, "o2"),
    }
