"""Canned synthetic-dataset generators for model-shaped data, their
tensors on ``device`` (port of ``fv3net_tpu/synth/generators.py``;
reference: external/synth/synth/__init__.py:14-31 generate_nudging /
generate_restart_data and the pytest fixtures in _dataset_fixtures.py)."""
from __future__ import annotations

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.synth.core import DatasetSchema, Range, VariableSchema, generate

DIMS_3D = ("time", "tile", "z", "y", "x")
DIMS_2D = ("time", "tile", "y", "x")


def _schema_for(names_3d, names_2d, nt, nz, n):
    variables = {}
    for name in names_3d:
        variables[name] = VariableSchema(
            name=name, dims=list(DIMS_3D), shape=[nt, 6, nz, n, n]
        )
    for name in names_2d:
        variables[name] = VariableSchema(
            name=name, dims=list(DIMS_2D), shape=[nt, 6, n, n]
        )
    return DatasetSchema(variables=variables)


def generate_nudging(nt: int = 4, nz: int = 8, n: int = 8,
                     device="cuda") -> Dataset:
    """Nudged-run training dataset: state + nudging tendencies
    (the open_nudge_to_fine data layout, reference
    external/loaders/loaders/mappers/_nudged/_nudged.py:118)."""
    schema = _schema_for(
        [
            "air_temperature",
            "specific_humidity",
            "pressure_thickness_of_atmospheric_layer",
            "air_temperature_tendency_due_to_nudging",
            "specific_humidity_tendency_due_to_nudging",
        ],
        ["latent_heat_flux", "sensible_heat_flux", "surface_precipitation_rate"],
        nt, nz, n,
    )
    ranges = {
        "air_temperature": Range(220.0, 310.0),
        "specific_humidity": Range(0.0, 0.02),
        "pressure_thickness_of_atmospheric_layer": Range(800.0, 1500.0),
        "air_temperature_tendency_due_to_nudging": Range(-1e-4, 1e-4),
        "specific_humidity_tendency_due_to_nudging": Range(-1e-7, 1e-7),
        "latent_heat_flux": Range(0.0, 200.0),
        "sensible_heat_flux": Range(-50.0, 100.0),
        "surface_precipitation_rate": Range(0.0, 1e-3),
    }
    return generate(schema, ranges, device=device)


def generate_restart_data(nz: int = 8, n: int = 8,
                          device="cuda") -> Dataset:
    """Restart-shaped fields (fv_core-style state, single time)."""
    names_3d = ["T", "sphum", "delp", "u_cartesian_0", "u_cartesian_1",
                "u_cartesian_2"]
    variables = {
        name: VariableSchema(
            name=name, dims=["tile", "z", "y", "x"], shape=[6, nz, n, n]
        )
        for name in names_3d
    }
    variables["phis"] = VariableSchema(
        name="phis", dims=["tile", "y", "x"], shape=[6, n, n]
    )
    schema = DatasetSchema(variables=variables)
    ranges = {
        "T": Range(220.0, 310.0),
        "sphum": Range(0.0, 0.02),
        "delp": Range(800.0, 1500.0),
        "phis": Range(0.0, 5000.0),
    }
    return generate(schema, ranges, device=device)


#: the reference fine-res diagnostic variable set (reference
#: external/synth/synth/_dataset_fixtures/fine_res_budget.json schema)
FINE_RES_VARIABLES = [
    "T",
    "T_storage",
    "T_vulcan_omega_coarse",
    "delp",
    "eddy_flux_vulcan_omega_sphum",
    "eddy_flux_vulcan_omega_temp",
    "qv_dt_fv_sat_adj_coarse",
    "qv_dt_phys_coarse",
    "sphum",
    "sphum_storage",
    "sphum_vulcan_omega_coarse",
    "t_dt_fv_sat_adj_coarse",
    "t_dt_nudge_coarse",
    "t_dt_phys_coarse",
    "vulcan_omega_coarse",
]


def generate_fine_res(datadir=None, times=(), nz: int = 8, n: int = 8,
                      device="cuda"):
    """Fine-res budget diagnostics (reference synth/_fine_res.py:8-22 +
    fine_res_budget.json): the 15-variable raw fine-res set on
    [tile, z, y, x].  When ``datadir`` is given, write the reference's
    per-time, per-tile NetCDF layout ``{time}.tile{tile}.nc`` for each
    timestamp in ``times`` and return the full Dataset."""
    variables = {
        name: VariableSchema(
            name=name, dims=["tile", "z", "y", "x"], shape=[6, nz, n, n]
        )
        for name in FINE_RES_VARIABLES
    }
    ranges = {
        "T": Range(220.0, 310.0),
        "sphum": Range(0.0, 0.02),
        "delp": Range(800.0, 1500.0),
        "T_storage": Range(-1e-4, 1e-4),
        "sphum_storage": Range(-1e-7, 1e-7),
        "t_dt_phys_coarse": Range(-1e-4, 1e-4),
        "qv_dt_phys_coarse": Range(-1e-7, 1e-7),
        "t_dt_fv_sat_adj_coarse": Range(-1e-5, 1e-5),
        "qv_dt_fv_sat_adj_coarse": Range(-1e-8, 1e-8),
        "t_dt_nudge_coarse": Range(-1e-5, 1e-5),
        "vulcan_omega_coarse": Range(-1.0, 1.0),
    }
    ds = generate(DatasetSchema(variables=variables), ranges, device=device)
    if datadir is not None:
        import os

        from fv3net_torch.core.netcdfio import write_netcdf
        from fv3net_torch.core.quantity import Quantity

        os.makedirs(datadir, exist_ok=True)
        for time in times:
            for tile in range(1, 7):
                sel = Dataset(
                    {
                        name: Quantity(
                            ds[name].data[tile - 1],
                            ds[name].dims[1:],
                            ds[name].units,
                        )
                        for name in ds
                    }
                )
                write_netcdf(
                    sel, os.path.join(datadir, f"{time}.tile{tile}.nc")
                )
    return ds
