"""fv3net_torch's copies and I/O of the segmented run held against
fv3net_tpu's: the run configuration (valid and invalid dicts, Fortran
namelists, base presets), the time selectors, the diagnostics stores,
the restarts in both formats, the dense model's artifact format, the
prescriber's data path and the per-stepper diagnostics."""
import dataclasses
import datetime
import inspect
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    dry_emulator_model,
    event_summary,
    make_state_numpy,
    rel_diff,
)

from fv3net_torch.core import convenience, netcdfio, zarrio
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.fit import io
from fv3net_torch.runtime import checkpoint, config, metrics, names
from fv3net_torch.runtime.derived_state import ModelState
from fv3net_torch.runtime.diagnostics import compute, times
from fv3net_torch.runtime.diagnostics.manager import DiagnosticsManager
from fv3net_torch.runtime.segmented_run import prepare_config

jax.config.update("jax_enable_x64", True)

NPX, NPZ = 6, 8
T0 = datetime.datetime(2016, 8, 1)


# ------------------------------------------------------------ config
_DIAGS = [
    {"name": "diags.zarr", "variables": ["ULWRFtoa", "PRATEsfc"],
     "times": {"kind": "interval-average", "frequency": 3600.0},
     "chunks": {"time": 2}, "renames": {"PRATEsfc": "precip"},
     "pull_dtype": "bfloat16"},
    {"name": "state.zarr", "variables": ["air_temperature"],
     "times": {"kind": "selected", "times": ["20160801.003000"]}},
]
VALID = {
    # tests/test_segmented_run.py
    "segmented_run": {
        "namelist": {"npx": 6, "npz": 10, "dt_atmos": 900.0, "n_split": 2},
        "duration_seconds": 1800.0,
        "initial_time": "2016-08-01T00:00:00",
        "diagnostics": [{"name": "diags.zarr",
                         "variables": ["surface_precipitation_rate"],
                         "times": {"kind": "every"}}],
    },
    # tests/test_fused_loop.py
    "fused_loop": {"namelist": {"npx": 6, "npz": 8},
                   "duration_seconds": 3600.0, "fused_chunk_steps": 4},
    "fused_segment": {
        "namelist": {"npx": 6, "npz": 8}, "duration_seconds": 3600.0,
        "fused_chunk_steps": 4,
        "diagnostics": [{"name": "state_after_timestep.zarr",
                         "variables": ["air_temperature",
                                       "surface_pressure"],
                         "times": {"kind": "every"}}],
    },
    # tests/test_config_keys.py
    "wrapper": {"namelist": {"npx": 6}, "wrapper": "shield.wrapper"},
    "fortran_diagnostics": {
        "namelist": {"npx": NPX, "npz": NPZ, "dt_atmos": 900.0},
        "duration_seconds": 1800.0,
        "fortran_diagnostics": [{
            "name": "atmos_dt_atmos.zarr", "times": {"kind": "every"},
            "variables": [{"module_name": "dynamics",
                           "field_name": "PRATEsfc",
                           "output_name": "PRATEsfc_coarse"}]}],
    },
    "steppers": {
        "namelist": {"npx": 6, "slab_ocean": True, "sea_ice": True,
                     "land_model": "noah", "radiation": "rrtmg"},
        "tendency_prescriber": {"dataset": "x", "variables": ["dQ1"],
                                "limit_quantiles": {"lower": 0.01}},
        "bias_correction": {"dataset": "x", "variables": ["dQ1"],
                            "apply_interval_seconds": 1800.0},
        "online_emulator": {"url": "x", "target": "gscond",
                            "piggy_back": True},
        "reservoir_corrector": {"model_path": "x", "synchronize_steps": 2,
                                "rename_mapping": {"a": "b"}},
        "radiation_scheme": {"kind": "python", "scheme": "gray"},
        "scikit_learn": {"model": ["m"], "online": False},
        "prephysics": [{"dataset": "x", "variables": ["a"]}],
        "diagnostics": _DIAGS,
        "fused_chunk_steps": 8, "radiation_interval_steps": 4,
    },
    "nudging": {"namelist": {"npx": 6},
                "nudging": {"restarts_path": "x",
                            "timescale_hours": {"air_temperature": 3.0}}},
    # a reference fv3config.yml: Fortran *_nml sections, data assets
    "fortran_nml": {
        "data_table": "default", "diag_table": "default",
        "experiment_name": "default_experiment",
        "forcing": "gs://vcm-fv3config/data/base_forcing/v1.1/",
        "namelist": {
            "amip_interp_nml": {"data_set": "reynolds_oi"},
            "coupler_nml": {"dt_atmos": 900, "days": 0, "hours": 3,
                            "minutes": 0, "seconds": 0},
            "fv_core_nml": {"npx": 49, "npy": 49, "npz": 79,
                            "n_split": 6, "hydrostatic": False,
                            "tau": 5.0, "rf_cutoff": 800.0, "d2_bg": 0.0,
                            "kord_tm": -9, "hord_mt": 6},
            "gfs_physics_nml": {"fhswr": 3600.0, "imp_physics": 11},
        },
    },
    "flat_keys_win": {
        "namelist": {"fv_core_nml": {"npx": 49, "npz": 79}, "npz": 32,
                     "radiation": "gray",
                     "gfs_physics_nml": {"fhswr": 1800.0}},
        "duration_seconds": 600.0,
    },
    "base_version": {"base_version": "v0.1/aquaplanet_c12_test",
                     "duration_seconds": 900.0},
    "base_version_c48": {"base_version": "v0.1/aquaplanet_c48",
                         "namelist": {"npz": 16}},
}
INVALID = {
    "unknown_key": {"namelist": {"npx": 6}, "no_such_key": 1},
    "unknown_namelist_key": {"namelist": {"npx": 6, "no_such_key": 1}},
    "unknown_scheme": {"namelist": {"radiation": "none"}},
    "sea_ice_without_slab_ocean": {"namelist": {"sea_ice": True}},
    "pull_dtype_not_a_dtype": {"diagnostics": [
        {"name": "d.zarr", "variables": ["a"], "pull_dtype": "no_dtype"}]},
    "pull_dtype_not_floating": {"diagnostics": [
        {"name": "d.zarr", "variables": ["a"], "pull_dtype": "int32"}]},
    "wrapper": {"wrapper": "other.wrapper"},
    "nudging_with_ml": {"scikit_learn": {"model": ["m"]},
                        "nudging": {"timescale_hours": {"a": 1.0}}},
    "months": {"namelist": {"coupler_nml": {"months": 1}}},
}


@pytest.mark.parametrize("name", sorted(VALID))
def test_get_config_matches_reference(name):
    from fv3net_tpu.runtime.config import get_config as jget_config

    got = dataclasses.asdict(config.get_config(VALID[name]))
    want = dataclasses.asdict(jget_config(VALID[name]))
    assert got == want


@pytest.mark.parametrize("name", sorted(INVALID))
def test_invalid_config_raises_as_reference(name):
    from fv3net_tpu.runtime.config import get_config as jget_config

    with pytest.raises(ValueError) as want:
        jget_config(INVALID[name])
    with pytest.raises(ValueError) as got:
        config.get_config(INVALID[name])
    assert str(got.value) == str(want.value)


def test_config_copies_keep_the_reference_fields(tmp_path):
    """Every config class has the reference's fields and defaults, the
    presets and the lowering constants are equal, and load_config reads
    a yaml file."""
    import yaml

    from fv3net_tpu.runtime import config as jconfig
    from fv3net_tpu.runtime.segmented_run import prepare_config as jprep

    for cls_name in ("MachineLearningConfig", "RadiationSchemeConfig",
                     "NudgingConfig", "DiagnosticFileConfig",
                     "FortranVariableNameSpec", "FortranFileConfig",
                     "TendencyPrescriberConfig", "BiasCorrectionConfig",
                     "OnlineEmulatorConfig", "ReservoirCorrectorConfig",
                     "TimeConfig", "NamelistConfig", "UserConfig"):
        def fields(cls):
            return [(f.name, f.default, str(f.type))
                    for f in dataclasses.fields(cls)]

        assert fields(getattr(config, cls_name)) == fields(
            getattr(jconfig, cls_name)), cls_name
    assert config.MODEL_KEYS == jconfig.MODEL_KEYS
    assert config.FV3CONFIG_ASSET_KEYS == jconfig.FV3CONFIG_ASSET_KEYS
    assert config._HORD_MAP == jconfig._HORD_MAP
    assert prepare_config.BASE_CONFIGS == jprep.BASE_CONFIGS
    user = VALID["base_version_c48"]
    assert prepare_config.prepare_config(user) == jprep.prepare_config(user)
    ff = config.get_config(VALID["fortran_diagnostics"]).fortran_diagnostics[0]
    jff = jconfig.get_config(
        VALID["fortran_diagnostics"]).fortran_diagnostics[0]
    assert ff.to_diag_table_lines(900.0) == jff.to_diag_table_lines(900.0)
    assert (dataclasses.asdict(ff.to_diagnostic_config())
            == dataclasses.asdict(jff.to_diagnostic_config()))
    path = tmp_path / "fv3config.yml"
    path.write_text(yaml.safe_dump(VALID["steppers"]))
    assert (dataclasses.asdict(config.load_config(str(path)))
            == dataclasses.asdict(jconfig.load_config(str(path))))


def test_convenience_copy_matches_reference():
    from fv3net_tpu.core import convenience as jconv

    t = datetime.datetime(2016, 8, 1, 3, 15, 0)
    assert convenience.encode_time(t) == jconv.encode_time(t)
    s = "20160801.031500"
    assert convenience.parse_datetime_from_str(s) == \
        jconv.parse_datetime_from_str(s)


# ------------------------------------------------------------ times
@pytest.mark.parametrize("cfg", [
    {"kind": "every"},
    {"kind": "interval", "frequency": 3600.0},
    {"kind": "interval-average", "frequency": 7200.0},
    {"kind": "selected", "times": ["20160801.003000", "20160801.120000"]},
])
def test_time_indicators_match_reference(cfg):
    from fv3net_tpu.runtime.config import TimeConfig as JTimeConfig
    from fv3net_tpu.runtime.diagnostics import times as jtimes

    got = times.time_container_from_config(config.TimeConfig(**cfg), T0)
    want = jtimes.time_container_from_config(JTimeConfig(**cfg), T0)
    for k in range(1, 97):  # a day of 900 s steps
        t = T0 + datetime.timedelta(seconds=900 * k)
        assert got.indicator(t) == want.indicator(t), t


# ------------------------------------------------------------ diagnostics
def _observations(n=7, seed=0):
    """A seeded sequence of (time, diagnostics) at 900 s: a 3-D and two
    2-D fields, float64."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(1, n + 1):
        out.append((T0 + datetime.timedelta(seconds=900 * k), {
            "air_temperature": 250 + 50 * rng.rand(6, NPZ, NPX, NPX),
            "ULWRFtoa": 240 + 20 * rng.rand(6, NPX, NPX),
            "PRATEsfc": 1e-4 * rng.rand(6, NPX, NPX),
        }))
    return out


MANAGER_FILES = [
    {"name": "every.zarr", "variables": ["air_temperature", "ULWRFtoa"],
     "times": {"kind": "every"}, "chunks": {"time": 3, "x": 4}},
    {"name": "interval.zarr", "variables": ["ULWRFtoa", "PRATEsfc"],
     "times": {"kind": "interval", "frequency": 1800.0},
     "renames": {"PRATEsfc": "precip"}},
    {"name": "average.zarr", "variables": ["ULWRFtoa", "air_temperature"],
     "times": {"kind": "interval-average", "frequency": 2700.0}},
    {"name": "selected.zarr", "variables": ["PRATEsfc"],
     "times": {"kind": "selected",
               "times": ["20160801.004500", "20160801.013000"]}},
    {"name": "bf16.zarr", "variables": ["air_temperature", "PRATEsfc"],
     "times": {"kind": "every"}, "pull_dtype": "bfloat16"},
]


def test_diagnostics_stores_match_reference(tmp_path):
    """One seeded observation sequence through both DiagnosticsManagers
    (every, interval, interval-average, selected; chunks, renames,
    pull_dtype bfloat16, a Fortran file): stores of equal contents, each
    read with the other package's zarrio."""
    from fv3net_tpu.core import zarrio as jzarrio
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.runtime.config import get_config as jget_config
    from fv3net_tpu.runtime.diagnostics.manager import (
        DiagnosticsManager as JManager,
    )

    d = {"diagnostics": MANAGER_FILES, "fortran_diagnostics": [
        {"name": "fortran.zarr", "variables": [
            {"module_name": "dynamics", "field_name": "ULWRFtoa",
             "output_name": "olr"}]}]}
    tcfg, jcfg = config.get_config(d), jget_config(d)
    tm = DiagnosticsManager(tcfg.diagnostics + tcfg.fortran_diagnostics, T0,
                            str(tmp_path / "torch"))
    jm = JManager(jcfg.diagnostics + jcfg.fortran_diagnostics, T0,
                  str(tmp_path / "jax"))

    def dims(a):
        return ("tile", "z", "y", "x") if a.ndim == 4 else ("tile", "y", "x")

    for t, obs in _observations():
        tm.observe(t, {k: Quantity(torch.tensor(v), dims(v))
                       for k, v in obs.items()})
        jm.observe(t, {k: JQuantity(jnp.asarray(v), dims(v))
                       for k, v in obs.items()})
    tm.close()
    jm.close()
    rows = {"every.zarr": 7, "interval.zarr": 3, "average.zarr": 3,
            "selected.zarr": 2, "bf16.zarr": 7, "fortran.zarr": 7}
    for store, n in rows.items():
        got_t = jzarrio.open_zarr(str(tmp_path / "torch" / store))
        got = zarrio.open_zarr(str(tmp_path / "torch" / store))
        want = zarrio.open_zarr(str(tmp_path / "jax" / store))
        want_j = jzarrio.open_zarr(str(tmp_path / "jax" / store))
        assert set(got) == set(want) == set(got_t), store
        np.testing.assert_array_equal(got.coords["time"],
                                      want.coords["time"])
        for k in want:
            g, w = got[k].values, want[k].values
            assert g.shape[0] == n and g.shape == w.shape, (store, k)
            assert g.dtype == w.dtype == np.float32
            assert got[k].dims == want[k].dims
            np.testing.assert_array_equal(np.asarray(got_t[k].values), g)
            np.testing.assert_array_equal(np.asarray(want_j[k].values), w)
            if store == "average.zarr":
                # float64 sums in another grouping, stored as float32
                np.testing.assert_allclose(g, w, rtol=1.2e-7, err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{store} {k}")
    got = zarrio.ZarrArray(str(tmp_path / "torch" / "every.zarr" / "ULWRFtoa"))
    assert tuple(got.chunks) == (3, 6, NPX, 4)


def test_tensorboard_file_raises(tmp_path):
    """A ``tensorboard: true`` file is an event log under
    <rundir>/tensorboard, as the reference's manager makes it: the same
    steps, scalar means (float64 means, stored as float32) and PNG
    bytes, read back by the reference's ``read_events`` (the name is the
    one this test had when the option raised)."""
    import glob

    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.runtime import config as jconfig
    from fv3net_tpu.runtime.diagnostics import tensorboard as jtb
    from fv3net_tpu.runtime.diagnostics.manager import (
        DiagnosticsManager as JManager)

    from fv3net_torch.runtime.diagnostics import tensorboard as ttb

    raw = {"diagnostics": [{"name": "tb", "variables": ["a", "b"],
                            "tensorboard": True}]}
    cfg = config.get_config(raw)
    port = DiagnosticsManager(cfg.diagnostics, T0, str(tmp_path / "t"))
    ref = JManager(jconfig.get_config(raw).diagnostics, T0,
                   str(tmp_path / "j"))
    rng = np.random.RandomState(0)
    for step in range(3):
        a = rng.rand(6, 4, 4)
        b = rng.rand(6, 3, 4, 4)
        t = T0 + datetime.timedelta(seconds=900 * step)
        port.observe(t, {"a": Quantity(torch.tensor(a), ("tile", "y", "x")),
                         "b": Quantity(torch.tensor(b),
                                       ("tile", "z", "y", "x"))})
        ref.observe(t, {"a": JQuantity(jnp.asarray(a), ("tile", "y", "x")),
                        "b": JQuantity(jnp.asarray(b),
                                       ("tile", "z", "y", "x"))})
    port.close()
    ref.close()
    (got,) = glob.glob(str(tmp_path / "t" / "tensorboard" / "events.*"))
    (want,) = glob.glob(str(tmp_path / "j" / "tensorboard" / "events.*"))
    got_ev, want_ev = jtb.read_events(got), ttb.read_events(want)
    assert len(got_ev) == len(want_ev) == 4  # the version record + 3 steps
    for g, w in zip(got_ev[1:], want_ev[1:]):
        # the same tags, steps, scalar bytes and image bytes; wall times
        # differ (the clock)
        assert event_summary(g) == event_summary(w)
        assert any(image is not None for _, _, image in
                   event_summary(g)[1])



def test_scalar_log_and_global_means_match_reference(caplog):
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.runtime import metrics as jmetrics

    (t, obs), = _observations(1)
    area = make_state_numpy(NPX, NPZ)[1].area
    names_, vec = metrics.global_means(
        {k: Quantity(torch.tensor(v), ("tile", "y", "x")) for k, v in
         obs.items() if v.ndim == 3}, torch.tensor(area))
    jnames, jvec = jmetrics.globally_average_2d_diagnostics_async(
        {k: JQuantity(jnp.asarray(v), ("tile", "y", "x")) for k, v in
         obs.items() if v.ndim == 3}, area)
    assert names_ == jnames
    assert rel_diff(vec.numpy(), np.asarray(jvec)) <= 1e-14
    with caplog.at_level(logging.INFO, logger="statistics"):
        metrics.log_scalar(t, dict(zip(names_, vec.tolist())))
        jmetrics.log_scalar(t, dict(zip(jnames, np.asarray(jvec))))
    got, want = [json.loads(r.message) for r in caplog.records[-2:]]
    assert got.keys() == want.keys() and got["time"] == want["time"]


# ------------------------------------------------------------ restarts
def _seeded_state():
    st, grid, _, _ = make_state_numpy(NPX, NPZ, seed=2, moist=True)
    rng = np.random.RandomState(4)
    surface = {
        names.TSFC: 280 + 20 * rng.rand(6, NPX, NPX),
        names.SST: 280 + 20 * rng.rand(6, NPX, NPX),
        names.MASK: (rng.rand(6, NPX, NPX) > 0.7).astype(float),
        "ice_thickness": np.where(rng.rand(6, NPX, NPX) > 0.5,
                                  rng.rand(6, NPX, NPX), 0.0),
        "soil_temperature": 280 + rng.rand(4, 6, NPX, NPX),
        "soil_moisture_layers": 0.3 * rng.rand(4, 6, NPX, NPX),
        "snow_water_equivalent": 0.01 * rng.rand(6, NPX, NPX),
        "deep_soil_temperature": 285 + rng.rand(6, NPX, NPX),
        names.TOTAL_PRECIP: 1e-3 * rng.rand(6, NPX, NPX),
    }
    return st, grid, surface


def test_state_restarts_are_read_by_either_package(tmp_path):
    from fv3net_tpu.runtime import checkpoint as jcheckpoint
    from fv3net_tpu.runtime.derived_state import ModelState as JModelState
    from torch_port_util import jax_state

    st, _, surface = _seeded_state()
    t = datetime.datetime(2016, 8, 1, 6)
    checkpoint.save_state(ModelState(
        dycore=state_from_numpy(st),
        surface={k: torch.tensor(v) for k, v in surface.items()}),
        t, str(tmp_path / "torch"))
    jcheckpoint.save_state(JModelState(
        dycore=jax_state(st, jnp.float64),
        surface={k: jnp.asarray(v) for k, v in surface.items()}),
        t, str(tmp_path / "jax"))
    for src in ("torch", "jax"):
        got, t_got = checkpoint.load_state(str(tmp_path / src))
        want, t_want = jcheckpoint.load_state(str(tmp_path / src))
        assert t_got == t_want == t
        assert list(got.dycore.tracers) == list(want.dycore.tracers)
        assert list(got.surface) == list(want.surface) == list(surface)
        for k, v in checkpoint._state_arrays(got).items():
            w = (getattr(want.dycore, k) if k in ("delp", "pt", "wind",
                                                  "phis")
                 else want.dycore.tracers[k[7:]] if k.startswith("tracer_")
                 else want.surface[k[8:]])
            assert v.dtype == torch.float64
            np.testing.assert_array_equal(v.numpy(), np.asarray(w), k)
    with open(tmp_path / "torch" / "restart.json") as f:
        got_meta = json.load(f)
    with open(tmp_path / "jax" / "restart.json") as f:
        assert got_meta == json.load(f)


def test_fortran_restarts_match_reference(tmp_path):
    """Both packages' save_fortran_restarts of one state write the same
    files and variables (values within float32's rounding: the files are
    float32); each package's load_fortran_restarts reads either
    directory back to the same state."""
    from fv3net_tpu.runtime import checkpoint as jcheckpoint
    from fv3net_tpu.runtime.derived_state import ModelState as JModelState
    from torch_port_util import jax_state

    st, grid, surface = _seeded_state()
    t = datetime.datetime(2016, 8, 1, 6, 30)
    checkpoint.save_fortran_restarts(ModelState(
        dycore=state_from_numpy(st),
        surface={k: torch.tensor(v) for k, v in surface.items()}),
        t, str(tmp_path / "torch"), grid)
    jcheckpoint.save_fortran_restarts(JModelState(
        dycore=jax_state(st, jnp.float64),
        surface={k: jnp.asarray(v) for k, v in surface.items()}),
        t, str(tmp_path / "jax"), grid)
    got = netcdfio.open_restarts(str(tmp_path / "torch"))
    want = netcdfio.open_restarts(str(tmp_path / "jax"))
    assert set(got) == set(want) == {"fv_core.res", "fv_tracer.res",
                                     "fv_srf_wnd.res", "sfc_data"}
    for cat in want:
        assert list(got[cat]) == list(want[cat]), cat
        for k in want[cat]:
            assert got[cat][k].dims == want[cat][k].dims
            assert rel_diff(got[cat][k].values,
                            want[cat][k].values) <= 2e-7, (cat, k)
    with open(tmp_path / "torch" / "coupler.res") as f, \
            open(tmp_path / "jax" / "coupler.res") as g:
        assert f.read() == g.read()
    for src in ("torch", "jax"):
        got_s, t_got = checkpoint.load_fortran_restarts(
            str(tmp_path / src), expected_shape=(6, NPZ, NPX, NPX))
        want_s, t_want = jcheckpoint.load_fortran_restarts(str(tmp_path / src))
        assert t_got == t_want == t
        for k, v in checkpoint._state_arrays(got_s).items():
            w = (getattr(want_s.dycore, k) if k in ("delp", "pt", "wind",
                                                    "phis")
                 else want_s.dycore.tracers[k[7:]] if k.startswith("tracer_")
                 else want_s.surface[k[8:]])
            assert rel_diff(v.numpy(), np.asarray(w)) <= 1e-6, (src, k)
        assert list(got_s.surface) == list(want_s.surface)


def test_dgrid_winds_match_reference():
    from fv3net_tpu.runtime import checkpoint as jcheckpoint

    grid = make_state_numpy(NPX, NPZ)[1]
    rng = np.random.RandomState(6)
    u = rng.randn(6, NPZ, NPX + 1, NPX)
    v = rng.randn(6, NPZ, NPX, NPX + 1)
    got = checkpoint.dgrid_wind_to_cartesian(u, v, grid, torch.float64)
    want = jcheckpoint.dgrid_wind_to_cartesian(u, v, grid, jnp.float64)
    assert rel_diff(got.numpy(), np.asarray(want)) <= 1e-14


def test_netcdf_files_are_read_by_either_package(tmp_path):
    from fv3net_tpu.core import netcdfio as jnetcdfio

    rng = np.random.RandomState(7)
    ds = Dataset({"a": Quantity(rng.rand(2, 3), ("y", "x"), "K"),
                  "b": Quantity(rng.rand(3).astype(np.float32), ("x",))})
    netcdfio.write_netcdf(ds, str(tmp_path / "t.nc"))
    got = jnetcdfio.open_netcdf(str(tmp_path / "t.nc"))
    back = netcdfio.open_netcdf(str(tmp_path / "t.nc"))
    for k in ds:
        np.testing.assert_array_equal(np.asarray(got[k].data),
                                      back[k].values)
        assert got[k].units == back[k].units


# ------------------------------------------------------------ model I/O
def test_dense_model_artifacts_load_in_either_package(tmp_path):
    """A reference DenseModel dumped with fv3net_tpu.fit.dump and loaded
    by the port's fit.io.load predicts what the reference predicts
    (float64, 1e-12); the port's dump loads in the reference; an artifact
    with output limits predicts the reference's clamped outputs; other
    model types raise."""
    from fv3net_tpu import fit as jfit
    from fv3net_tpu.fit.dense import DenseModel as JDenseModel
    from fv3net_tpu.fit.normalize import StandardScaler as JScaler
    from fv3net_tpu.fit.packer import PackingInfo as JInfo

    rng = np.random.RandomState(8)
    sizes = (2 * NPZ, 16, 16, 2 * NPZ)
    names_in = ["air_temperature", "specific_humidity"]
    names_out = ["dQ1", "dQ2"]
    model = JDenseModel(
        names_in, names_out,
        [{"w": jnp.asarray(rng.randn(a, b) / np.sqrt(a)),
          "b": jnp.asarray(0.1 * rng.randn(b))}
         for a, b in zip(sizes[:-1], sizes[1:])],
        JInfo(names_in, [NPZ, NPZ]), JInfo(names_out, [NPZ, NPZ]),
        JScaler(jnp.asarray(rng.rand(2 * NPZ)),
                jnp.asarray(1 + rng.rand(2 * NPZ))),
        JScaler(jnp.asarray(rng.rand(2 * NPZ)),
                jnp.asarray(1e-5 + rng.rand(2 * NPZ))),
    )
    jfit.dump(model, str(tmp_path / "ref"))
    got = io.load(str(tmp_path / "ref"))
    x = {"air_temperature": 250 + 30 * rng.rand(20, NPZ),
         "specific_humidity": 0.01 * rng.rand(20, NPZ)}
    want = model.predict_arrays({k: jnp.asarray(v) for k, v in x.items()})
    out = got.predict_arrays({k: torch.tensor(v) for k, v in x.items()})
    for k in names_out:
        assert rel_diff(out[k].numpy(), np.asarray(want[k])) <= 1e-12, k
    io.dump(got, str(tmp_path / "port"))
    back = jfit.load(str(tmp_path / "port"))
    again = back.predict_arrays({k: jnp.asarray(v) for k, v in x.items()})
    for k in names_out:
        np.testing.assert_array_equal(np.asarray(again[k]),
                                      np.asarray(want[k]))
    meta = json.loads((tmp_path / "port" / "metadata.json").read_text())
    meta["output_limits"] = {"dQ1": {"min": 0.0}}
    (tmp_path / "port" / "metadata.json").write_text(json.dumps(meta))
    limited = io.load(str(tmp_path / "port"))
    jlimited = jfit.load(str(tmp_path / "port"))
    want = jlimited.predict_arrays({k: jnp.asarray(v) for k, v in x.items()})
    out = limited.predict_arrays({k: torch.tensor(v) for k, v in x.items()})
    assert float(np.min(np.asarray(want["dQ1"]))) >= 0.0
    for k in names_out:
        assert rel_diff(out[k].numpy(), np.asarray(want[k])) <= 1e-12, k
    (tmp_path / "port" / "name").write_text("random_forest")
    with pytest.raises(ValueError, match="unknown model type"):
        io.load(str(tmp_path / "port"))
    with pytest.raises(ValueError, match="unknown model type"):
        jfit.load(str(tmp_path / "port"))


# ------------------------------------------------------------ prescriber
def test_prescriber_data_path_matches_reference(tmp_path):
    """ZarrMapper, mapper_getter (index and label keys),
    time_interpolate_func and Prescriber against the reference."""
    from fv3net_tpu.loaders import ZarrMapper as JZarrMapper
    from fv3net_tpu.runtime import interpolate as jinterp
    from fv3net_tpu.runtime.steppers.prescriber import Prescriber as JPres

    from fv3net_torch.loaders.batches import ZarrMapper
    from fv3net_torch.runtime import interpolate
    from fv3net_torch.runtime.steppers.prescriber import Prescriber

    rng = np.random.RandomState(9)
    data = 290 + rng.rand(12, 6, NPX, NPX)
    zarrio.to_zarr(Dataset({"sst": Quantity(data, ("time", "tile", "y",
                                                   "x"))}),
                   str(tmp_path / "s.zarr"))
    m, jm = ZarrMapper(str(tmp_path / "s.zarr")), JZarrMapper(
        str(tmp_path / "s.zarr"))
    assert list(m) == list(jm)
    freq = datetime.timedelta(seconds=900)
    g = interpolate.mapper_getter(m, T0, freq)
    jg = jinterp.mapper_getter(jm, T0, freq)
    p, jp = Prescriber(g, ["sst"], {"sst": "a"}), JPres(jg, ["sst"],
                                                        {"sst": "a"})
    for k in (0, 1, 5, 11, 20):
        t = T0 + k * freq
        got, want = p(t, None)[2]["a"], jp(t, None)[2]["a"]
        np.testing.assert_array_equal(got.values, np.asarray(want.data))
    by_label = {convenience.encode_time(T0 + k * freq): m[str(k)]
                for k in range(3)}
    fi = interpolate.time_interpolate_func(
        interpolate.mapper_getter(by_label), freq, T0)
    jfi = jinterp.time_interpolate_func(
        jinterp.mapper_getter(by_label), freq, T0)
    t = T0 + datetime.timedelta(seconds=1200)
    np.testing.assert_allclose(fi(t)["sst"].values,
                               np.asarray(jfi(t)["sst"].data), rtol=1e-15)


# ------------------------------------------------------------ stepper diags
def test_stepper_diagnostics_match_reference():
    """compute_diagnostics (with dQp), compute_ml_momentum_diagnostics,
    compute_baseline_diagnostics and rename_diagnostics."""
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.runtime.diagnostics import compute as jcompute

    rng = np.random.RandomState(10)
    st = make_state_numpy(NPX, NPZ, seed=3)[0]
    delp = st["delp"]
    d3 = ("tile", "z", "y", "x")
    tend = {k: s * rng.randn(*delp.shape) for k, s in (
        ("dQ1", 1e-4), ("dQ2", 1e-8), ("dQp", 1e-3), ("dQu", 1e-4),
        ("dQv", 1e-4))}
    tq = {k: Quantity(torch.tensor(v), d3) for k, v in tend.items()}
    jq = {k: JQuantity(jnp.asarray(v), d3) for k, v in tend.items()}
    for hydrostatic in (True, False):
        got = compute.compute_diagnostics(torch.tensor(delp), tq, "ml",
                                          hydrostatic)
        want = jcompute.compute_diagnostics(jnp.asarray(delp), jq, "ml",
                                            hydrostatic)
        got.update(compute.compute_ml_momentum_diagnostics(
            torch.tensor(delp), tq))
        want.update(jcompute.compute_ml_momentum_diagnostics(
            jnp.asarray(delp), jq))
        compute.rename_diagnostics(got, "ml")
        jcompute.rename_diagnostics(want, "ml")
        assert set(got) == set(want)
        for k in want:
            assert got[k].units == want[k].units
            assert rel_diff(got[k].data.numpy(),
                            np.asarray(want[k].data)) <= 1e-13, k

    class State(dict):
        pass

    s = State({names.DELP: Quantity(torch.tensor(delp), d3),
               names.SPHUM: Quantity(torch.tensor(st["tracers"]["sphum"]),
                                     d3)})
    js = State({names.DELP: JQuantity(jnp.asarray(delp), d3),
                names.SPHUM: JQuantity(jnp.asarray(st["tracers"]["sphum"]),
                                       d3)})
    got = compute.compute_baseline_diagnostics(s)
    want = jcompute.compute_baseline_diagnostics(js)
    assert set(got) == set(want) == {"water_vapor_path"}
    assert rel_diff(got["water_vapor_path"].data.numpy(),
                    np.asarray(want["water_vapor_path"].data)) <= 1e-14


def test_phase_timer_and_report():
    from fv3net_torch.runtime import timing

    timing.reset_phases()
    with timing.phases.clock("a"):
        pass
    timing.add_counter("bytes", 3.0)
    rep = timing.phase_report()
    assert rep["a"]["hits"] == 1 and rep["bytes"] == 3.0
    with pytest.raises(ValueError):
        timing.phases.start("b")
        timing.phases.start("b")
    timing.reset_phases()
    assert timing.phase_report() == {}


# ------------------------------------------------------------ factories
def test_stepper_factories_build_the_config_steppers(tmp_path):
    """The "steppers" config's radiation_scheme, online_emulator,
    tendency_prescriber, bias_correction and reservoir_corrector keys
    build the port's steppers as the reference's factories build theirs
    (an emulator artifact, a dQ1 store and a reservoir artifact the
    reference dumped stand in for the config's "x")."""
    from fv3net_tpu.runtime import factories as jfactories
    from fv3net_tpu.runtime.config import get_config as jget_config

    from fv3net_torch.runtime import factories

    from fv3net_tpu import fit as jfit
    from fv3net_tpu.fit.reservoir import (
        ReservoirHyperparameters,
        train_reservoir_model,
    )
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    io.dump(dry_emulator_model(NPZ, torch.float64),
            str(tmp_path / "emulator"))
    rng = np.random.RandomState(0)
    store = str(tmp_path / "dq1.zarr")
    zarrio.to_zarr(Dataset({"dQ1": Quantity(
        1e-5 * rng.randn(2, 6, NPZ, 6, 6), ("time", "tile", "z", "y", "x"))}),
        store)
    series = jnp.asarray(rng.rand(20, 2 * NPZ))
    jfit.dump(train_reservoir_model(
        ReservoirHyperparameters(input_variables=["a"], state_size=8,
                                 n_burn=2),
        [JDataset({"inputs": JQuantity(series, ("time", "f")),
                   "outputs": JQuantity(series, ("time", "f"))})]),
        str(tmp_path / "reservoir"))
    steppers = VALID["steppers"]
    user = dict(
        steppers,
        online_emulator=dict(steppers["online_emulator"],
                             url=str(tmp_path / "emulator")),
        tendency_prescriber=dict(steppers["tendency_prescriber"],
                                 dataset=store,
                                 limit_quantiles={"lower": 0.01,
                                                  "upper": 0.99}),
        bias_correction=dict(steppers["bias_correction"], dataset=store),
        reservoir_corrector=dict(steppers["reservoir_corrector"],
                                 model_path=str(tmp_path / "reservoir")))
    cfg, jcfg = config.get_config(user), jget_config(user)
    got = factories.get_radiation_stepper(cfg, 900.0, device="cpu")
    want = jfactories.get_radiation_stepper(jcfg, 900.0)
    assert got.apply_heating == want.apply_heating
    assert (dataclasses.asdict(got.radiation.config)
            == dataclasses.asdict(want.radiation.config))
    emu, target, piggy = factories.get_microphysics_emulator(
        cfg, device="cpu")
    jemu, jtarget, jpiggy = jfactories.get_microphysics_emulator(jcfg)
    assert (target, piggy) == (jtarget, jpiggy) == ("gscond", True)
    assert emu.model.input_variables == jemu.model.input_variables
    assert factories.get_microphysics_emulator(config.get_config({})) == (
        None, "microphysics", False)
    for build in (factories.get_postphysics_stepper,
                  factories.get_radiation_stepper,
                  factories.get_microphysics_emulator,
                  factories.get_tendency_prescriber,
                  factories.get_bias_correction,
                  factories.get_reservoir_steppers):
        assert inspect.signature(build).parameters[
            "device"].default == "cuda"
    t0 = datetime.datetime(2016, 8, 1, 0, 15)
    tp = factories.get_tendency_prescriber(cfg, 900.0, device="cpu")
    jtp = jfactories.get_tendency_prescriber(jcfg, 900.0)
    assert (tp.label, tp.variables) == (jtp.label, jtp.variables)
    (got,), (want,) = tp(t0, None)[0].values(), jtp(t0, None)[0].values()
    assert rel_diff(got.data.numpy(), want.data) <= 1e-14
    bc = factories.get_bias_correction(cfg, 900.0, device="cpu")
    jbc = jfactories.get_bias_correction(jcfg, 900.0)
    assert (bc.label, bc.interval) == (jbc.label, jbc.interval) == (
        "interval_bias_correction", 1800.0)
    inc, pred = factories.get_reservoir_steppers(cfg, 900.0, device="cpu")
    jinc, jpred = jfactories.get_reservoir_steppers(jcfg, 900.0)
    assert (inc.label, pred.label) == (jinc.label, jpred.label)
    assert inc.config == pred.config and dataclasses.asdict(
        inc.config) == dataclasses.asdict(jinc.config)
    assert inc.input_variables == jinc.input_variables == ["b"]  # renamed
    np.testing.assert_array_equal(inc.model.W.numpy(),
                                  np.asarray(jinc.model.W))
