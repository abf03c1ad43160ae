"""Declarative data transforms for training data (port of
``fv3net_tpu/data_transform.py``; reference:
external/vcm/vcm/data_transform.py:16-363): a registry of named
transforms with declared inputs and outputs (the Q1/Q2/Qm algebra, the
tendency <-> flux conversions, tapering, the in-cloud conversions),
composed by ``DataTransform`` / ``ChainedDataTransform`` configs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from fv3net_torch.core.constants import GRAVITY
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.ops import thermo

DELP = "pressure_thickness_of_atmospheric_layer"
DLW_SFC = "total_sky_downward_longwave_flux_at_surface"
DSW_SFC = "total_sky_downward_shortwave_flux_at_surface"
DSW_TOA = "total_sky_downward_shortwave_flux_at_top_of_atmosphere"
ULW_SFC = "total_sky_upward_longwave_flux_at_surface"
ULW_TOA = "total_sky_upward_longwave_flux_at_top_of_atmosphere"
USW_SFC = "total_sky_upward_shortwave_flux_at_surface"
USW_TOA = "total_sky_upward_shortwave_flux_at_top_of_atmosphere"
LHF = "latent_heat_flux"
SHF = "sensible_heat_flux"
COL_T_NUDGE = "storage_of_internal_energy_path_due_to_fine_res_temperature_nudging"


@dataclasses.dataclass
class DataTransformRegistryEntry:
    func: Callable
    inputs: List[str]
    outputs: List[str]


DATA_TRANSFORM_REGISTRY: Dict[str, DataTransformRegistryEntry] = {}


def register(inputs: Sequence[str], outputs: Sequence[str]):
    def decorator(func):
        DATA_TRANSFORM_REGISTRY[func.__name__] = DataTransformRegistryEntry(
            func=func, inputs=list(inputs), outputs=list(outputs)
        )
        return func

    return decorator


def _d(q):
    return torch.as_tensor(q.data if isinstance(q, Quantity) else q)


def _taper(q: Quantity, cutoff: int, rate: float) -> torch.Tensor:
    x = _d(q)
    scale = vertical_tapering_scale_factors(q.sizes["z"], cutoff, rate)
    shape = [1] * len(q.dims)
    shape[_zax(q)] = len(scale)
    return x * torch.as_tensor(scale.reshape(shape), dtype=x.dtype,
                               device=x.device)


def _zax(q: Quantity) -> int:
    return q.dims.index("z")


def vertical_tapering_scale_factors(n_levels: int, cutoff: int, rate: float):
    """Exponential upper-atmosphere taper (reference
    fv3fit/_shared/taper_function.py semantics used by tapered_dQ)."""
    k = np.arange(n_levels)
    return np.where(k < cutoff, np.exp(-(cutoff - k) / rate), 1.0)


@register(["dQ1"], ["tapered_dQ1"])
def tapered_dQ1(ds: Dataset, cutoff: int = 10, rate: float = 5.0) -> Dataset:
    q = ds["dQ1"]
    ds["tapered_dQ1"] = Quantity(_taper(q, cutoff, rate), q.dims, q.units)
    return ds


@register(["dQ2"], ["tapered_dQ2"])
def tapered_dQ2(ds: Dataset, cutoff: int = 10, rate: float = 5.0) -> Dataset:
    q = ds["dQ2"]
    ds["tapered_dQ2"] = Quantity(_taper(q, cutoff, rate), q.dims, q.units)
    return ds


@register(["Q1", "Q2"], ["Qm"])
def Qm_from_Q1_Q2(ds: Dataset) -> Dataset:
    ds["Qm"] = Quantity(
        thermo.moist_static_energy_tendency(_d(ds["Q1"]), _d(ds["Q2"])),
        ds["Q1"].dims,
        "W/kg",
    )
    return ds


@register(["Qm", "Q2"], ["Q1"])
def Q1_from_Qm_Q2(ds: Dataset) -> Dataset:
    ds["Q1"] = Quantity(
        thermo.temperature_tendency(_d(ds["Qm"]), _d(ds["Q2"])),
        ds["Qm"].dims,
        "K/s",
    )
    return ds


@register(["Q1", "Q2", "air_temperature"], ["Qm"])
def Qm_from_Q1_Q2_temperature_dependent(ds: Dataset) -> Dataset:
    ds["Qm"] = Quantity(
        thermo.moist_static_energy_tendency(
            _d(ds["Q1"]), _d(ds["Q2"]), temperature=_d(ds["air_temperature"])
        ),
        ds["Q1"].dims,
        "W/kg",
    )
    return ds


@register(["Qm", "Q2", "air_temperature"], ["Q1"])
def Q1_from_Qm_Q2_temperature_dependent(ds: Dataset) -> Dataset:
    ds["Q1"] = Quantity(
        thermo.temperature_tendency(
            _d(ds["Qm"]), _d(ds["Q2"]), temperature=_d(ds["air_temperature"])
        ),
        ds["Qm"].dims,
        "K/s",
    )
    return ds


@register(["dQ1", "pQ1"], ["Q1"])
def Q1_from_dQ1_pQ1(ds: Dataset) -> Dataset:
    ds["Q1"] = Quantity(
        _d(ds["dQ1"]) + _d(ds["pQ1"]), ds["dQ1"].dims, "K/s"
    )
    return ds


@register(["dQ2", "pQ2"], ["Q2"])
def Q2_from_dQ2_pQ2(ds: Dataset) -> Dataset:
    ds["Q2"] = Quantity(
        _d(ds["dQ2"]) + _d(ds["pQ2"]), ds["dQ2"].dims, "kg/kg/s"
    )
    return ds


# ---------------------------------------------------------------------------
# tendency <-> flux form (reference data_transform.py:132-243 +
# vcm/calc/flux_form.py)
# ---------------------------------------------------------------------------


def _tendency_to_flux(tendency, toa_net_flux, surface_upward_flux, delp,
                      axis: int, rectify: bool):
    """Interface fluxes implied by a column tendency.

    F(0) = toa_net_flux; F(k+1) = F(k) - tendency_k * delp_k / g.
    Returns (interface fluxes (..., nz+1), implied downward surface flux
    = F(nz) + surface_upward_flux, optionally rectified >= 0).
    """
    dm = torch.movedim(_d(tendency) * _d(delp) / GRAVITY, axis, -1)
    toa = _d(toa_net_flux)
    cum = torch.cumsum(dm, dim=-1)
    F = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1)
    F = toa[..., None] - F
    sfc_down = F[..., -1] + _d(surface_upward_flux)
    if rectify:
        sfc_down = torch.clamp(sfc_down, min=0.0)
    return F, sfc_down


def _flux_to_tendency(net_flux_if, surface_downward_flux, surface_upward_flux,
                      delp, axis: int):
    """Invert _tendency_to_flux: replace the bottom interface flux with the
    (possibly rectified) surface value, then divergence."""
    F = _d(net_flux_if)
    F = torch.cat(
        [
            F[..., :-1],
            (_d(surface_downward_flux) - _d(surface_upward_flux))[..., None],
        ],
        dim=-1,
    )
    dm = torch.movedim(_d(delp), axis, -1) / GRAVITY
    tend = (F[..., :-1] - F[..., 1:]) / dm
    return torch.movedim(tend, -1, axis)


@register(
    [
        "Qm", DELP, DLW_SFC, DSW_SFC, DSW_TOA, ULW_SFC, ULW_TOA, USW_SFC,
        USW_TOA, LHF, SHF, COL_T_NUDGE,
    ],
    ["Qm_flux", "implied_downward_radiative_flux_at_surface"],
)
def Qm_flux_from_Qm_tendency(
    ds: Dataset,
    rectify_downward_radiative_flux: bool = True,
    include_temperature_nudging: bool = True,
) -> Dataset:
    toa_net = _d(ds[DSW_TOA]) - _d(ds[USW_TOA]) - _d(ds[ULW_TOA])
    if include_temperature_nudging and COL_T_NUDGE in ds:
        toa_net = toa_net + _d(ds[COL_T_NUDGE])
    sfc_up = _d(ds[LHF]) + _d(ds[SHF]) + _d(ds[USW_SFC]) + _d(ds[ULW_SFC])
    q = ds["Qm"]
    ax = _zax(q)
    F, sfc_down = _tendency_to_flux(
        q, toa_net, sfc_up, ds[DELP], ax, rectify_downward_radiative_flux
    )
    dims_if = tuple(d if d != "z" else "z_interface" for d in q.dims[:ax]) + (
        "z_interface",
    ) + tuple(q.dims[ax + 1 :])
    ds["Qm_flux"] = Quantity(torch.movedim(F, -1, ax), dims_if, "W/m^2")
    dims2d = tuple(d for d in q.dims if d != "z")
    ds["implied_downward_radiative_flux_at_surface"] = Quantity(
        sfc_down, dims2d, "W/m^2"
    )
    return ds


@register(["Q2", DELP, LHF], ["Q2_flux", "implied_surface_precipitation_rate"])
def Q2_flux_from_Q2_tendency(
    ds: Dataset, rectify_surface_precipitation_rate: bool = True
) -> Dataset:
    sfc_up = thermo.latent_heat_flux_to_evaporation(_d(ds[LHF]))
    q = ds["Q2"]
    ax = _zax(q)
    F, sfc_down = _tendency_to_flux(
        q, torch.zeros_like(_d(ds[LHF])), sfc_up, ds[DELP], ax,
        rectify_surface_precipitation_rate,
    )
    dims_if = tuple(d if d != "z" else "z_interface" for d in q.dims[:ax]) + (
        "z_interface",
    ) + tuple(q.dims[ax + 1 :])
    ds["Q2_flux"] = Quantity(torch.movedim(F, -1, ax), dims_if, "kg/s/m^2")
    dims2d = tuple(d for d in q.dims if d != "z")
    ds["implied_surface_precipitation_rate"] = Quantity(
        sfc_down, dims2d, "kg/s/m^2"
    )
    return ds


@register(
    [
        "Qm_flux", "implied_downward_radiative_flux_at_surface", DELP,
        ULW_SFC, USW_SFC, LHF, SHF,
    ],
    ["Qm"],
)
def Qm_tendency_from_Qm_flux(ds: Dataset) -> Dataset:
    sfc_up = _d(ds[LHF]) + _d(ds[SHF]) + _d(ds[USW_SFC]) + _d(ds[ULW_SFC])
    qf = ds["Qm_flux"]
    ax = qf.dims.index("z_interface")
    tend = _flux_to_tendency(
        torch.movedim(_d(qf), ax, -1),
        ds["implied_downward_radiative_flux_at_surface"],
        sfc_up,
        ds[DELP],
        _zax(ds[DELP]),
    )
    ds["Qm"] = Quantity(tend, ds[DELP].dims, "W/kg")
    return ds


@register(
    ["Q2_flux", "implied_surface_precipitation_rate", DELP, LHF], ["Q2"],
)
def Q2_tendency_from_Q2_flux(ds: Dataset) -> Dataset:
    sfc_up = thermo.latent_heat_flux_to_evaporation(_d(ds[LHF]))
    qf = ds["Q2_flux"]
    ax = qf.dims.index("z_interface")
    tend = _flux_to_tendency(
        torch.movedim(_d(qf), ax, -1),
        ds["implied_surface_precipitation_rate"],
        sfc_up,
        ds[DELP],
        _zax(ds[DELP]),
    )
    ds["Q2"] = Quantity(tend, ds[DELP].dims, "kg/kg/s")
    return ds


@register(["cloud_amount", "incloud_water_mixing_ratio"],
          ["cloud_water_mixing_ratio"])
def cloud_water_mixing_ratio_from_incloud(ds: Dataset) -> Dataset:
    q = ds["incloud_water_mixing_ratio"]
    ds["cloud_water_mixing_ratio"] = Quantity(
        _d(q) * _d(ds["cloud_amount"]), q.dims, "kg/kg"
    )
    return ds


@register(["cloud_amount", "incloud_ice_mixing_ratio"],
          ["cloud_ice_mixing_ratio"])
def cloud_ice_mixing_ratio_from_incloud(ds: Dataset) -> Dataset:
    q = ds["incloud_ice_mixing_ratio"]
    ds["cloud_ice_mixing_ratio"] = Quantity(
        _d(q) * _d(ds["cloud_amount"]), q.dims, "kg/kg"
    )
    return ds


# ---------------------------------------------------------------------------
# config-driven composition (reference data_transform.py:326-363)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DataTransform:
    name: str
    kwargs: Dict = dataclasses.field(default_factory=dict)

    def apply(self, ds: Dataset) -> Dataset:
        entry = DATA_TRANSFORM_REGISTRY[self.name]
        return entry.func(ds, **self.kwargs)

    @property
    def input_variables(self) -> List[str]:
        return DATA_TRANSFORM_REGISTRY[self.name].inputs

    @property
    def output_variables(self) -> List[str]:
        return DATA_TRANSFORM_REGISTRY[self.name].outputs


@dataclasses.dataclass
class ChainedDataTransform:
    transforms: List[DataTransform]

    def apply(self, ds: Dataset) -> Dataset:
        for t in self.transforms:
            ds = t.apply(ds)
        return ds

    @property
    def input_variables(self) -> List[str]:
        inputs: List[str] = []
        outputs: List[str] = []
        for t in self.transforms:
            for v in t.input_variables:
                if v not in outputs and v not in inputs:
                    inputs.append(v)
            outputs.extend(t.output_variables)
        return inputs

    @property
    def output_variables(self) -> List[str]:
        out: List[str] = []
        for t in self.transforms:
            out.extend(t.output_variables)
        return out
