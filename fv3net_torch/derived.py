"""DerivedMapping: named access to existing and derived variables (port
of ``fv3net_tpu/derived.py``; reference:
external/vcm/vcm/derived_mapping.py:8-577): a Mapping with a
``@DerivedMapping.register`` registry, dependency declarations and the
recursive resolution of required inputs.  Derived values are Quantities
of torch tensors on their inputs' device.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping

import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.ops import thermo, zenith


class DerivedMapping(Mapping):
    """Mapping over existing + registered derived variables
    (reference derived_mapping.py:8-98)."""

    VARIABLES: Dict[str, Callable] = {}
    REQUIRED_INPUTS: Dict[str, Iterable[str]] = {}
    USE_NONDERIVED_IF_EXISTS: List[str] = []

    def __init__(self, mapper: Mapping[str, Quantity]):
        self._mapper = mapper

    @classmethod
    def register(
        cls,
        name: str,
        required_inputs: Iterable[str] = None,
        use_nonderived_if_exists: bool = False,
    ):
        def decorator(func):
            cls.VARIABLES[name] = func
            if required_inputs:
                cls.REQUIRED_INPUTS[name] = list(required_inputs)
            if use_nonderived_if_exists:
                cls.USE_NONDERIVED_IF_EXISTS.append(name)
            return func

        return decorator

    def __getitem__(self, key: str) -> Quantity:
        if key in self.VARIABLES:
            if key in self.USE_NONDERIVED_IF_EXISTS:
                try:
                    return self._mapper[key]
                except KeyError:
                    return self.VARIABLES[key](self)
            return self.VARIABLES[key](self)
        return self._mapper[key]

    def keys(self):
        return set(self._mapper) | set(self.VARIABLES)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self.keys())

    def dataset(self, keys: Iterable[str]) -> Dataset:
        return Dataset({k: self[k] for k in keys})

    @classmethod
    def find_all_required_inputs(cls, derived_variables) -> List[str]:
        """Recursively resolve non-derived inputs needed for the requested
        derived variables (reference derived_mapping.py:85-112)."""
        deps: List[str] = []

        def recurse(vars_):
            with_deps = [v for v in vars_ if v in cls.REQUIRED_INPUTS]
            if not with_deps:
                return
            new = []
            for v in with_deps:
                for dep in cls.REQUIRED_INPUTS[v]:
                    if dep not in deps:
                        deps.append(dep)
                        new.append(dep)
            recurse(new)

        recurse(list(derived_variables))
        nonderived = [d for d in deps if d not in cls.VARIABLES]
        maybe = [d for d in deps if d in cls.USE_NONDERIVED_IF_EXISTS]
        return list(dict.fromkeys(nonderived + maybe))


# ---------------------------------------------------------------------------
# registered derived variables (reference derived_mapping.py:114-577)
# ---------------------------------------------------------------------------

DELP = "pressure_thickness_of_atmospheric_layer"
_Z_AXIS = 1  # model layout [tile, z, y, x]


def _d(q):  # data of quantity or array
    return torch.as_tensor(q.data if isinstance(q, Quantity) else q)


@DerivedMapping.register("cos_zenith_angle", required_inputs=["time", "lon", "lat"])
def cos_zenith_angle(self):
    days = zenith.days_from_2000(self["time"])
    lon = self["lon"]
    lat = self["lat"]
    cz = zenith.cos_zenith_angle(days, _d(lon), _d(lat))
    return Quantity(cz, lon.dims, "")


@DerivedMapping.register("evaporation", required_inputs=["latent_heat_flux"])
def evaporation(self):
    lhf = self["latent_heat_flux"]
    return Quantity(
        thermo.latent_heat_flux_to_evaporation(_d(lhf)), lhf.dims, "kg/m^2/s"
    )


@DerivedMapping.register("dQu", use_nonderived_if_exists=True)
def dQu(self):
    # A-grid native: no D-grid rotation needed (contrast reference :143)
    return self._mapper["dQu"]


@DerivedMapping.register("dQv", use_nonderived_if_exists=True)
def dQv(self):
    return self._mapper["dQv"]


@DerivedMapping.register(
    "dQu_parallel_to_eastward_wind", required_inputs=["eastward_wind", "dQu"]
)
def dQu_parallel_to_eastward_wind(self):
    u = _d(self["eastward_wind"])
    dqu = _d(self["dQu"])
    return Quantity(torch.sign(u / dqu) * torch.abs(dqu), self["dQu"].dims)


@DerivedMapping.register(
    "dQv_parallel_to_northward_wind", required_inputs=["northward_wind", "dQv"]
)
def dQv_parallel_to_northward_wind(self):
    v = _d(self["northward_wind"])
    dqv = _d(self["dQv"])
    return Quantity(torch.sign(v / dqv) * torch.abs(dqv), self["dQv"].dims)


@DerivedMapping.register(
    "net_shortwave_sfc_flux_derived",
    required_inputs=[
        "surface_diffused_shortwave_albedo",
        "override_for_time_adjusted_total_sky_downward_shortwave_flux_at_surface",
    ],
)
def net_shortwave_sfc_flux_derived(self):
    albedo = _d(self["surface_diffused_shortwave_albedo"])
    down = self[
        "override_for_time_adjusted_total_sky_downward_shortwave_flux_at_surface"
    ]
    return Quantity((1 - albedo) * _d(down), down.dims, "W/m^2")


@DerivedMapping.register(
    "shortwave_transmissivity_of_atmospheric_column",
    required_inputs=[
        "total_sky_downward_shortwave_flux_at_surface",
        "total_sky_downward_shortwave_flux_at_top_of_atmosphere",
    ],
    use_nonderived_if_exists=True,
)
def shortwave_transmissivity_of_atmospheric_column(self):
    toa = _d(self["total_sky_downward_shortwave_flux_at_top_of_atmosphere"])
    sfc = self["total_sky_downward_shortwave_flux_at_surface"]
    positive = toa > 0
    trans = torch.where(
        positive, _d(sfc) / torch.where(positive, toa, torch.ones_like(toa)),
        torch.zeros_like(toa))
    return Quantity(trans, sfc.dims, "")


def _onehot(self, value):
    mask = _d(self["land_sea_mask"])
    dtype = mask.dtype if mask.is_floating_point() else torch.float32
    return Quantity(
        (torch.abs(mask - value) < 0.5).to(dtype),
        self["land_sea_mask"].dims,
    )


@DerivedMapping.register("is_land", required_inputs=["land_sea_mask"])
def is_land(self):
    return _onehot(self, 1)


@DerivedMapping.register("is_sea", required_inputs=["land_sea_mask"])
def is_sea(self):
    return _onehot(self, 0)


@DerivedMapping.register("is_sea_ice", required_inputs=["land_sea_mask"])
def is_sea_ice(self):
    return _onehot(self, 2)


@DerivedMapping.register("pQ1", required_inputs=[DELP], use_nonderived_if_exists=True)
def pQ1(self):
    q = self[DELP]
    return Quantity(torch.zeros_like(_d(q)), q.dims, "K/s")


@DerivedMapping.register("pQ2", required_inputs=[DELP], use_nonderived_if_exists=True)
def pQ2(self):
    q = self[DELP]
    return Quantity(torch.zeros_like(_d(q)), q.dims, "kg/kg/s")


@DerivedMapping.register("Q1", required_inputs=["pQ1"], use_nonderived_if_exists=True)
def Q1(self):
    if "dQ1" in self.keys() and "dQ1" in self._mapper:
        return Quantity(
            _d(self["dQ1"]) + _d(self["pQ1"]), self["pQ1"].dims, "K/s"
        )
    return self["pQ1"]


@DerivedMapping.register("Q2", required_inputs=["pQ2"], use_nonderived_if_exists=True)
def Q2(self):
    if "dQ2" in self.keys() and "dQ2" in self._mapper:
        return Quantity(
            _d(self["dQ2"]) + _d(self["pQ2"]), self["pQ2"].dims, "kg/kg/s"
        )
    return self["pQ2"]


@DerivedMapping.register("internal_energy", required_inputs=["air_temperature"])
def internal_energy(self):
    T = self["air_temperature"]
    return Quantity(thermo.internal_energy(_d(T)), T.dims, "J/kg")


def _zaxis(q: Quantity) -> int:
    return q.dims.index("z")


@DerivedMapping.register("column_integrated_dQ1", required_inputs=["dQ1", DELP])
def column_integrated_dQ1(self):
    q = self["dQ1"]
    ax = _zaxis(q)
    out = thermo.column_integrated_heating_from_isochoric_transition(
        _d(q), _d(self[DELP]), axis=ax
    )
    dims = tuple(d for d in q.dims if d != "z")
    return Quantity(out, dims, "W/m^2")


@DerivedMapping.register("column_integrated_dQ2", required_inputs=["dQ2", DELP])
def column_integrated_dQ2(self):
    q = self["dQ2"]
    ax = _zaxis(q)
    out = -thermo.minus_column_integrated_moistening(
        _d(q), _d(self[DELP]), axis=ax
    )
    dims = tuple(d for d in q.dims if d != "z")
    return Quantity(out, dims, "mm/day")


@DerivedMapping.register("column_integrated_Q1", required_inputs=["Q1", DELP])
def column_integrated_Q1(self):
    q = self["Q1"]
    ax = _zaxis(q)
    out = thermo.column_integrated_heating_from_isochoric_transition(
        _d(q), _d(self[DELP]), axis=ax
    )
    dims = tuple(d for d in q.dims if d != "z")
    return Quantity(out, dims, "W/m^2")


@DerivedMapping.register("column_integrated_Q2", required_inputs=["Q2", DELP])
def column_integrated_Q2(self):
    q = self["Q2"]
    ax = _zaxis(q)
    out = -thermo.minus_column_integrated_moistening(
        _d(q), _d(self[DELP]), axis=ax
    )
    dims = tuple(d for d in q.dims if d != "z")
    return Quantity(out, dims, "mm/day")


@DerivedMapping.register(
    "water_vapor_path",
    required_inputs=["specific_humidity", DELP],
    use_nonderived_if_exists=True,
)
def water_vapor_path(self):
    q = self["specific_humidity"]
    ax = _zaxis(q)
    out = thermo.column_integrated_liquid_water_equivalent(
        _d(q), _d(self[DELP]), axis=ax
    )
    dims = tuple(d for d in q.dims if d != "z")
    return Quantity(out, dims, "mm")


@DerivedMapping.register(
    "upward_heat_flux_at_surface",
    required_inputs=[
        "total_sky_upward_shortwave_flux_at_surface",
        "total_sky_upward_longwave_flux_at_surface",
        "sensible_heat_flux",
    ],
)
def upward_heat_flux_at_surface(self):
    q = self["sensible_heat_flux"]
    out = (
        _d(self["total_sky_upward_shortwave_flux_at_surface"])
        + _d(self["total_sky_upward_longwave_flux_at_surface"])
        + _d(q)
    )
    return Quantity(out, q.dims, "W/m^2")


CLIMIT1 = 1.0e-3
CLIMIT2 = 5.0e-2


def gridcell_to_incloud_condensate(
    cloud_amount, condensate, climit1=CLIMIT1, climit2=CLIMIT2
):
    """In-cloud condensate from gridcell mean via the GFS condensate
    normalization (reference vcm/calc/clouds.py:7-38): below ``climit1``
    the values are identical; the scaling fraction is floored at
    ``climit2``."""
    cloud_amount = torch.as_tensor(cloud_amount)
    frac = torch.clamp(cloud_amount, min=climit2)
    return torch.where(cloud_amount <= climit1, condensate, condensate / frac)


def incloud_to_gridcell_condensate(
    cloud_amount, incloud_condensate, climit1=CLIMIT1, climit2=CLIMIT2
):
    """Inverse of :func:`gridcell_to_incloud_condensate` (reference
    vcm/calc/clouds.py:41-68)."""
    cloud_amount = torch.as_tensor(cloud_amount)
    frac = torch.clamp(cloud_amount, min=climit2)
    return torch.where(
        cloud_amount <= climit1, incloud_condensate, incloud_condensate * frac
    )


@DerivedMapping.register(
    "incloud_water_mixing_ratio",
    required_inputs=["cloud_amount", "cloud_water_mixing_ratio"],
)
def incloud_water_mixing_ratio(self):
    q = self["cloud_water_mixing_ratio"]
    out = gridcell_to_incloud_condensate(_d(self["cloud_amount"]), _d(q))
    return Quantity(out, q.dims, "kg/kg")


@DerivedMapping.register(
    "incloud_ice_mixing_ratio",
    required_inputs=["cloud_amount", "cloud_ice_mixing_ratio"],
)
def incloud_ice_mixing_ratio(self):
    q = self["cloud_ice_mixing_ratio"]
    out = gridcell_to_incloud_condensate(_d(self["cloud_amount"]), _d(q))
    return Quantity(out, q.dims, "kg/kg")


@DerivedMapping.register("pressure", required_inputs=[DELP])
def pressure(self):
    q = self[DELP]
    ax = _zaxis(q)
    out = thermo.pressure_at_midpoint_log(_d(q), axis=ax)
    return Quantity(out, q.dims, "Pa")


@DerivedMapping.register(
    "relative_humidity",
    required_inputs=["air_temperature", "specific_humidity", "pressure"],
)
def relative_humidity(self):
    T = self["air_temperature"]
    out = thermo.relative_humidity_from_pressure(
        _d(T), _d(self["specific_humidity"]), _d(self["pressure"])
    )
    return Quantity(out, T.dims, "")
