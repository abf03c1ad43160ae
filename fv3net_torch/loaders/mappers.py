"""Training-data mappers (port of ``fv3net_tpu/loaders/mappers.py``;
reference: external/loaders/loaders/mappers/ — GeoMapper and
MultiDatasetMapper (_base.py:13-49), open_nudge_to_fine
(_nudged/_nudged.py:118), open_fine_resolution and its Approach enum
(_fine_res.py:91-230), SubsetTimes/KeyMap/ValMap
(_transformations.py:10-48)).  Values are the port's Datasets; derived
fields are torch tensors on the CPU.
"""
from __future__ import annotations

import enum
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence

import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.loaders.batches import ZarrMapper


def _t(q) -> torch.Tensor:
    return torch.as_tensor(q.data if isinstance(q, Quantity) else q)


TEMP_TENDENCY = "air_temperature_tendency_due_to_nudging"
SPHUM_TENDENCY = "specific_humidity_tendency_due_to_nudging"


class GeoMapper(Mapping[str, Dataset]):
    """Base time-keyed mapper (reference mappers/_base.py:13)."""

    def keys(self):
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(list(self.keys()))


class MergedMapper(GeoMapper):
    """Merge several time-aligned mappers per key
    (the merge step of the nudged mappers)."""

    def __init__(self, *mappers: Mapping[str, Dataset]):
        self._mappers = mappers

    def keys(self):
        keys = set(self._mappers[0])
        for m in self._mappers[1:]:
            keys &= set(m)
        return sorted(keys)

    def __getitem__(self, key: str) -> Dataset:
        out: Dict[str, Quantity] = {}
        for m in self._mappers:
            ds = m[key]
            out.update({k: ds[k] for k in ds})
        return Dataset(out)


class MultiDatasetMapper(GeoMapper):
    """Stack several mappers along a new 'dataset' dimension
    (reference _base.py MultiDatasetMapper)."""

    def __init__(self, mappers: Sequence[Mapping[str, Dataset]]):
        self._mappers = list(mappers)

    def keys(self):
        keys = set(self._mappers[0])
        for m in self._mappers[1:]:
            keys &= set(m)
        return sorted(keys)

    def __getitem__(self, key: str) -> Dataset:
        dss = [m[key] for m in self._mappers]
        out = {}
        for name in dss[0]:
            arrs = [_t(d[name]) for d in dss]
            out[name] = Quantity(
                torch.stack(arrs), ("dataset",) + dss[0][name].dims,
                dss[0][name].units,
            )
        return Dataset(out)


class ValMap(GeoMapper):
    """Apply a function to every value (reference _transformations.py:10)."""

    def __init__(self, func: Callable[[Dataset], Dataset],
                 mapper: Mapping[str, Dataset]):
        self._func = func
        self._mapper = mapper

    def keys(self):
        return sorted(self._mapper)

    def __getitem__(self, key: str) -> Dataset:
        return self._func(self._mapper[key])


class KeyMap(GeoMapper):
    """Apply a function to every key (reference _transformations.py:25)."""

    def __init__(self, func: Callable[[str], str],
                 mapper: Mapping[str, Dataset]):
        self._mapper = mapper
        self._key_map = {func(k): k for k in mapper}

    def keys(self):
        return sorted(self._key_map)

    def __getitem__(self, key: str) -> Dataset:
        return self._mapper[self._key_map[key]]


class SubsetTimes(GeoMapper):
    """Skip initial spinup keys and limit count
    (reference _transformations.py SubsetTimes)."""

    def __init__(self, i_start: int, n_times: Optional[int],
                 mapper: Mapping[str, Dataset]):
        keys = sorted(mapper)
        stop = None if n_times is None else i_start + n_times
        self._keys = keys[i_start:stop]
        self._mapper = mapper

    def keys(self):
        return list(self._keys)

    def __getitem__(self, key: str) -> Dataset:
        if key not in self._keys:
            raise KeyError(key)
        return self._mapper[key]


def _rename(ds: Dataset, names: Mapping[str, str]) -> Dataset:
    return ds.rename({k: v for k, v in names.items() if k in ds})


def open_nudge_to_fine(
    state_zarr: str,
    nudging_zarr: Optional[str] = None,
    nudging_variables: Sequence[str] = ("air_temperature",
                                        "specific_humidity"),
    consolidated: bool = True,
) -> GeoMapper:
    """Nudged-to-fine training data (reference _nudged/_nudged.py:118):
    state snapshots merged with nudging tendencies, with the tendencies
    renamed to the corrective-tendency names (dQ1/dQ2)."""
    state = ZarrMapper(state_zarr)
    mappers = [state]
    if nudging_zarr is not None and nudging_zarr != state_zarr:
        mappers.append(ZarrMapper(nudging_zarr))
    merged = MergedMapper(*mappers) if len(mappers) > 1 else state
    rename = {TEMP_TENDENCY: "dQ1", SPHUM_TENDENCY: "dQ2"}
    return ValMap(lambda ds: _rename(ds, rename), merged)


def open_nudge_to_obs(
    state_zarr: str,
    nudging_zarr: Optional[str] = None,
    rename: Optional[Mapping[str, str]] = None,
) -> GeoMapper:
    """Nudged-to-observations training data (reference
    _nudged/_nudged.py:22 open_nudge_to_obs): like open_nudge_to_fine but
    with the obs-nudging tendency names (the GFS-analysis convention
    ``dQ* = -{var}_tendency_due_to_nudging`` sign handled by the caller's
    transform in the reference; here the rename map is configurable)."""
    default_rename = {
        "t_dt_nudge": "dQ1",
        "q_dt_nudge": "dQ2",
        "u_dt_nudge": "dQu",
        "v_dt_nudge": "dQv",
        TEMP_TENDENCY: "dQ1",
        SPHUM_TENDENCY: "dQ2",
    }
    rename = dict(rename or default_rename)
    state = ZarrMapper(state_zarr)
    mappers = [state]
    if nudging_zarr is not None and nudging_zarr != state_zarr:
        mappers.append(ZarrMapper(nudging_zarr))
    merged = MergedMapper(*mappers) if len(mappers) > 1 else state
    return ValMap(lambda ds: _rename(ds, rename), merged)


class Approach(enum.Enum):
    """(reference _fine_res.py:91-95: apparent_sources_only /
    plus_nudging_tendencies / extend_lower / dynamics_difference)"""

    apparent_sources_only = "apparent_sources_only"
    apparent_sources_plus_nudging_tendencies = (
        "apparent_sources_plus_nudging_tendencies"
    )
    apparent_sources_extend_lower = "apparent_sources_extend_lower"
    dynamics_difference = "dynamics_difference"


def _extend_lower(q: Quantity, n_levels: int = 2) -> Quantity:
    """Override the lowest ``n_levels`` layers with the value just above
    them (reference _fine_res.py:181-200: fine-res apparent sources are
    unreliable in the surface layer over coarse terrain)."""
    try:
        z_ax = q.dims.index("z")
    except ValueError:
        raise ValueError(f"no 'z' dim in {q.dims}")
    data = _t(q)
    nz = data.shape[z_ax]
    if nz <= n_levels:
        raise ValueError("vertical_dim must be greater than n_levels")
    src = data.narrow(z_ax, nz - (n_levels + 1), 1)
    reps = [1] * data.ndim
    reps[z_ax] = n_levels
    new = torch.cat([data.narrow(z_ax, 0, nz - n_levels), src.repeat(*reps)],
                    dim=z_ax)
    return Quantity(new, q.dims, q.units)


def open_fine_resolution(
    budget_zarr: str,
    approach: Approach = Approach.apparent_sources_only,
    nudging_zarr: Optional[str] = None,
    include_temperature_nudging: bool = False,
) -> GeoMapper:
    """Fine-resolution apparent-source training data
    (reference _fine_res.py:216 + compute_budget:128-155): budgets from
    fv3net_torch.pipelines.fine_res_budget provide Q1/Q2/dQ1/dQ2 directly;
    ``plus_nudging_tendencies`` adds the coarse-run nudging tendencies,
    ``extend_lower`` overrides the lowest two layers of the heating
    source, ``dynamics_difference`` computes
    Q = fine storage - fine nudging - coarse dynamics tendency
    (reference DynamicsDifferenceApparentSource:98-125)."""
    if isinstance(approach, str):  # YAML/MapperConfig kwargs pass names
        approach = Approach[approach]
    budgets = ZarrMapper(budget_zarr)
    if approach == Approach.apparent_sources_only:
        return budgets

    if approach == Approach.apparent_sources_extend_lower:
        def extend(ds: Dataset) -> Dataset:
            for key in ("Q1", "dQ1"):
                if key in ds:
                    ds[key] = _extend_lower(ds[key])
            return ds

        return ValMap(extend, budgets)

    if approach == Approach.dynamics_difference:
        def dyn_diff(ds: Dataset) -> Dataset:
            t_stor = _t(ds["T_storage"])
            q_stor = _t(ds["sphum_storage"])
            t_dyn = _t(ds["tendency_of_air_temperature_due_to_dynamics"])
            q_dyn = _t(ds["tendency_of_specific_humidity_due_to_dynamics"])
            q1 = t_stor - t_dyn
            if (
                not include_temperature_nudging
                and "t_dt_nudge_coarse" in ds
            ):
                q1 = q1 - _t(ds["t_dt_nudge_coarse"])
            dims = ds["T_storage"].dims
            ds["Q1"] = Quantity(q1, dims, "K/s")
            ds["Q2"] = Quantity(q_stor - q_dyn, dims, "kg/kg/s")
            return ds

        return ValMap(dyn_diff, budgets)

    if nudging_zarr is None:
        raise ValueError(f"{approach} requires nudging_zarr")
    nudge = ZarrMapper(nudging_zarr)

    def add_nudging(ds: Dataset) -> Dataset:
        for tend, dq in ((TEMP_TENDENCY, "dQ1"), (SPHUM_TENDENCY, "dQ2")):
            if tend in ds and dq in ds:
                ds[dq] = Quantity(
                    _t(ds[dq]) + _t(ds[tend]),
                    ds[dq].dims, ds[dq].units,
                )
        return ds

    return ValMap(add_nudging, MergedMapper(budgets, nudge))


# SCREAM nudged-run variable conventions (reference
# _nudged/_nudged.py:233-303 open_nudge_to_fine_scream rename_vars)
SCREAM_RENAME: Mapping[str, str] = {
    "T_mid_tendency_due_to_nudging": "dQ1",
    "qv_tendency_due_to_nudging": "dQ2",
    "U_tendency_due_to_nudging": "dQu",
    "V_tendency_due_to_nudging": "dQv",
    "tendency_of_T_mid_due_to_scream_physics": "pQ1",
    "tendency_of_qv_due_to_scream_physics": "pQ2",
    "tendency_of_U_due_to_scream_physics": "pQu",
    "tendency_of_V_due_to_scream_physics": "pQv",
    "T_mid": "air_temperature",
    "qv": "specific_humidity",
    "U": "eastward_wind",
    "V": "northward_wind",
}


def open_nudge_to_fine_scream(
    state_zarr: str,
    nudging_zarr: Optional[str] = None,
    nudging_variables: Sequence[str] = ("T_mid", "qv"),
    physics_timestep_seconds: float = 900.0,
) -> GeoMapper:
    """Nudge-to-fine training data in SCREAM variable conventions
    (reference _nudged/_nudged.py:233 open_nudge_to_fine_scream): the
    nudging increment is subtracted to recover the pre-nudging state,
    then SCREAM names are mapped onto the fv3 training names."""
    state = ZarrMapper(state_zarr)
    mappers = [state]
    if nudging_zarr is not None and nudging_zarr != state_zarr:
        mappers.append(ZarrMapper(nudging_zarr))
    merged = MergedMapper(*mappers) if len(mappers) > 1 else state

    def transform(ds: Dataset) -> Dataset:
        out = dict(ds.items())
        for v in nudging_variables:
            tend_name = f"{v}_tendency_due_to_nudging"
            if v in out and tend_name in out:
                q = out[v]
                out[v] = Quantity(
                    _t(q) - _t(out[tend_name]) * physics_timestep_seconds,
                    q.dims,
                    q.units,
                )
        renamed = {SCREAM_RENAME.get(k, k): q for k, q in out.items()}
        return Dataset(renamed)

    return ValMap(transform, merged)


def open_nudge_to_fine_multiple_datasets(
    data_path: str,
    additional_paths: Sequence[str],
    **kwargs,
) -> GeoMapper:
    """Stack several nudged runs along a new 'dataset' dimension
    (reference _nudged/_nudged.py:188-213): each path is opened with
    :func:`open_nudge_to_fine` and the results are merged by
    MultiDatasetMapper over their common timestamps."""
    paths = [data_path, *additional_paths]
    return MultiDatasetMapper([open_nudge_to_fine(p, **kwargs) for p in paths])


# SHiELD coarsened-diagnostic names -> training names (reference
# loaders/constants.py:8-19 RENAMED_SHIELD_DIAG_VARS)
RENAMED_SHIELD_DIAG_VARS: Mapping[str, str] = {
    "DSWRFtoa_coarse": "total_sky_downward_shortwave_flux_at_top_of_atmosphere",
    "DSWRFsfc_coarse": "total_sky_downward_shortwave_flux_at_surface",
    "USWRFtoa_coarse": "total_sky_upward_shortwave_flux_at_top_of_atmosphere",
    "USWRFsfc_coarse": "total_sky_upward_shortwave_flux_at_surface",
    "DLWRFsfc_coarse": "total_sky_downward_longwave_flux_at_surface",
    "ULWRFtoa_coarse": "total_sky_upward_longwave_flux_at_top_of_atmosphere",
    "ULWRFsfc_coarse": "total_sky_upward_longwave_flux_at_surface",
    "SHTFLsfc_coarse": "sensible_heat_flux",
    "LHTFLsfc_coarse": "latent_heat_flux",
    "PRATEsfc_coarse": "surface_precipitation_rate",
}


def _assign_net_physics_terms(ds: Dataset) -> Dataset:
    """net_heating / net_precipitation from physics fluxes (reference
    loaders/_utils.py:182-212)."""
    from fv3net_torch.ops import thermo

    def _d(name):
        return _t(ds[name])

    heating = thermo.net_heating(
        _d("total_sky_downward_longwave_flux_at_surface"),
        _d("total_sky_downward_shortwave_flux_at_surface"),
        _d("total_sky_upward_longwave_flux_at_surface"),
        _d("total_sky_upward_longwave_flux_at_top_of_atmosphere"),
        _d("total_sky_upward_shortwave_flux_at_surface"),
        _d("total_sky_upward_shortwave_flux_at_top_of_atmosphere"),
        _d("total_sky_downward_shortwave_flux_at_top_of_atmosphere"),
        _d("sensible_heat_flux"),
        _d("surface_precipitation_rate"),
    )
    precip = thermo.net_precipitation(
        _d("latent_heat_flux"), _d("surface_precipitation_rate")
    )
    dims = ds["sensible_heat_flux"].dims
    ds["net_heating"] = Quantity(heating, dims, "W/m^2")
    ds["net_precipitation"] = Quantity(precip, dims, "mm/day")
    return ds


def open_high_res_diags(
    data_path: str,
    renamed_vars: Optional[Mapping[str, str]] = None,
    time_dim: str = "time",
) -> GeoMapper:
    """Mapper over coarsened SHiELD 2-D diagnostics (reference
    _high_res_diags.py:17-55): rename the *_coarse flux names to training
    names, keep only those, and insert net_heating/net_precipitation."""
    renamed = dict(RENAMED_SHIELD_DIAG_VARS if renamed_vars is None else renamed_vars)
    base = ZarrMapper(data_path, time_dim)

    def transform(ds: Dataset) -> Dataset:
        out = {renamed[k]: q for k, q in ds.items() if k in renamed}
        missing = set(renamed.values()) - set(out)
        if missing:
            raise KeyError(
                f"high-res diagnostics missing variables: {sorted(missing)}"
            )
        return _assign_net_physics_terms(Dataset(out, coords=dict(ds.coords)))

    return ValMap(transform, base)


def open_fine_resolution_nudging_hybrid(
    budget_zarr: str,
    approach: str = "apparent_sources_only",
    nudging_zarr: Optional[str] = None,
    include_temperature_nudging: bool = False,
) -> GeoMapper:
    """Hybrid fine-res + nudging training data (reference
    _hybrid.py:22-64): compute the fine-res budget for the requested
    approach, then split it against the coarse physics tendencies —
    dQ1/dQ2 = Q1/Q2 - physics, pQ1/pQ2 = physics, and the nudging wind
    tendencies become dQxwind/dQywind (reference compute_hybrid_budget,
    _hybrid.py:11-18)."""
    base = open_fine_resolution(
        budget_zarr,
        Approach[approach] if isinstance(approach, str) else approach,
        nudging_zarr=nudging_zarr,
        include_temperature_nudging=include_temperature_nudging,
    )

    PHYS_T = "tendency_of_air_temperature_due_to_fv3_physics"
    PHYS_Q = "tendency_of_specific_humidity_due_to_fv3_physics"

    def hybrid(ds: Dataset) -> Dataset:
        for total, phys, dq, pq, unit in (
            ("Q1", PHYS_T, "dQ1", "pQ1", "K/s"),
            ("Q2", PHYS_Q, "dQ2", "pQ2", "kg/kg/s"),
        ):
            if total in ds and phys in ds:
                q = ds[total]
                ds[dq] = Quantity(
                    _t(q) - _t(ds[phys]),
                    q.dims, unit,
                )
                ds[pq] = Quantity(_t(ds[phys]), q.dims, unit)
        for src, dst in (
            ("x_wind_tendency_due_to_nudging", "dQxwind"),
            ("y_wind_tendency_due_to_nudging", "dQywind"),
        ):
            if src in ds:
                ds[dst] = ds[src]
        return ds

    return ValMap(hybrid, base)
