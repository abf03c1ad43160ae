"""fv3net_torch's segmented run held against fv3net_tpu's (float64, on
the CPU): the TimeLoop's per-step path, its fused production path
through ``run_segment`` (end state, RESTART, every zarr store) and its
fused flagship-type path; then checks of the port alone: appended
segments equal one long segment bit for bit, the CLI's layout, the
RRTMG loop chunk against ``build_fused_production_chunk`` called
directly, and the options that raise.

The reference's fused TimeLoop compiles its chunk; each reference run is
shared between tests by module-scoped fixtures."""
import datetime
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_util import (
    assert_states_close,
    dry_emulator_model,
    make_state_numpy,
    rel_diff,
)

from fv3net_torch.core import zarrio
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.runtime import checkpoint, names
from fv3net_torch.runtime.config import get_config
from fv3net_torch.runtime.derived_state import ModelState
from fv3net_torch.runtime.loop import TimeLoop
from fv3net_torch.runtime.segmented_run import api

jax.config.update("jax_enable_x64", True)

NPX, NPZ = 6, 8
# float64, a few steps: roundoff grown through the steps (the production
# chunk tests' bound), relative to each field's scale
RTOL = 1e-8
# fields that are roundoff in both packages (no convection: CPRATsfc
# ~1e-19; the humidity limiter idle: its change ~1e-16 W/m2) are held
# within this absolute bound instead
ATOL = 1e-14


def _jax_model(seed=0, dq_scale=(1e-6, 1e-9), out_scale=1e-4):
    """A reference dense model (1 hidden layer of 16, float64) trained one
    epoch on a seeded batch, its last layer scaled by ``out_scale`` so
    that its outputs keep q positive (the limiter idle: see
    tests/test_torch_production.py)."""
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.fit.dense import DenseHyperparameters, train_dense_model

    rng = np.random.RandomState(seed)
    n = 64

    def q(x):
        return JQuantity(jnp.asarray(x, jnp.float64), ("sample", "z"))

    batch = JDataset({
        "air_temperature": q(260 + 30 * rng.rand(n, NPZ)),
        "specific_humidity": q(0.01 * rng.rand(n, NPZ)),
        "dQ1": q(dq_scale[0] * rng.randn(n, NPZ)),
        "dQ2": q(dq_scale[1] * rng.randn(n, NPZ)),
    })
    hp = DenseHyperparameters(
        input_variables=["air_temperature", "specific_humidity"],
        output_variables=["dQ1", "dQ2"], hidden_layers=1, width=16,
        epochs=1, seed=seed,
    )
    model = train_dense_model(hp, [batch])
    last = model.params[-1]
    model.params[-1] = {"w": out_scale * last["w"], "b": out_scale * last["b"]}
    return model


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A dumped reference dense model, a seeded 3-time SST store and a
    seeded moist restart (float64, ``state.npz``) to start from."""
    from fv3net_tpu import fit as jfit

    d = tmp_path_factory.mktemp("inputs")
    jfit.dump(_jax_model(), str(d / "model"))
    rng = np.random.RandomState(3)
    grid_lat = make_state_numpy(NPX, NPZ)[1].lat
    sst = (300.15 - 30.0 * np.sin(grid_lat) ** 2)[None] + rng.rand(
        3, 6, NPX, NPX)
    zarrio.to_zarr(Dataset({
        v: Quantity(sst, ("time", "tile", "y", "x"))
        for v in (names.TSFC, names.SST)}), str(d / "sst.zarr"))
    st, grid, _, _ = make_state_numpy(NPX, NPZ, seed=5, moist=True)
    sfc = {names.TSFC: 300.15 - 30.0 * np.sin(grid.lat) ** 2}
    sfc[names.SST] = sfc[names.TSFC].copy()
    sfc[names.MASK] = np.zeros_like(sfc[names.TSFC])
    checkpoint.save_state(
        ModelState(dycore=state_from_numpy(st),
                   surface={k: torch.tensor(v) for k, v in sfc.items()}),
        datetime.datetime(2016, 8, 1), str(d / "ic"))
    return d


def _config(inputs, prescribed=names.TSFC, **kw):
    cfg = {
        "namelist": {"npx": NPX, "npz": NPZ},
        "duration_seconds": 1800.0,
        "initial_conditions": str(inputs / "ic"),
        "scikit_learn": {"model": [str(inputs / "model")]},
        "prephysics": [{"dataset": str(inputs / "sst.zarr"),
                        "variables": [prescribed]}],
    }
    for k, v in kw.items():
        if k == "namelist":
            cfg["namelist"] = dict(cfg["namelist"], **v)
        else:
            cfg[k] = v
    return cfg


def _jloop(cfg):
    from fv3net_tpu.runtime.config import get_config as jget_config
    from fv3net_tpu.runtime.loop import TimeLoop as JTimeLoop

    return JTimeLoop(jget_config(cfg), dtype=jnp.float64)


def _tloop(cfg, **kw):
    return TimeLoop(get_config(cfg), dtype=torch.float64, device="cpu", **kw)


def _same_surface(got, want, rtol=RTOL):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert rel_diff(got[k].numpy(), np.asarray(want[k])) <= rtol, k


def _same_diags(got, want, rtol=RTOL):
    want = {k: v for k, v in want.items() if k != "__global_means__"}
    got = {k: v for k, v in got.items() if k != "__global_means__"}
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))
    bad = {}
    for k in want:
        w = np.asarray(want[k].data)
        g = torch.as_tensor(got[k].data).numpy()
        assert g.shape == w.shape, k
        assert got[k].dims == want[k].dims, k
        d = rel_diff(g, w)
        if not (d <= rtol or np.abs(g - w).max() <= ATOL):
            bad[k] = d
    assert not bad, bad


# ------------------------------------------------------------ per step
def test_per_step_path_matches_reference(inputs):
    """Two per-step steps (gray, a dense model loaded from its dumped
    directory, a "set" prescriber of the surface temperature): the state
    and every diagnostic (the monitor's tendencies and path storages, the
    column ML diagnostics, the precipitation bookkeeping)."""
    cfg = _config(inputs)
    jl, tl = _jloop(cfg), _tloop(cfg)
    assert not jl.fusable() and not tl.fusable()
    n = 0
    for (jt, jd), (tt, td) in zip(jl, tl):
        assert jt == tt
        _same_diags(td, jd)
        n += 1
    assert n == 2
    assert_states_close(tl.state.dycore, jl.state.dycore, RTOL)
    _same_surface(tl.state.surface, jl.state.surface)


# ------------------------------------------------------------ fused production
PRODUCTION = dict(
    namelist={"slab_ocean": True, "sea_ice": True},
    duration_seconds=3600.0,
    fused_chunk_steps=2,
    diagnostics=[
        {"name": "state_after_timestep.zarr",
         "variables": [names.TEMP, names.SPHUM, names.EASTWARD_WIND,
                       "surface_pressure"],
         "times": {"kind": "every"}, "chunks": {"time": 2}},
        {"name": "diags.zarr",
         "variables": [names.TOTAL_PRECIP, "ULWRFtoa", "DSWRFsfc",
                       "surface_pressure", "water_vapor_path"],
         "times": {"kind": "interval-average", "frequency": 3600.0}},
    ],
    fortran_diagnostics=[
        {"name": "atmos_dt_atmos.zarr",
         "variables": [{"module_name": "dynamics",
                        "field_name": "surface_pressure",
                        "output_name": "PRESsfc"}]},
    ],
)


@pytest.fixture(scope="module")
def production_runs(inputs, tmp_path_factory):
    """One segment of 2 fused production chunks of 2 steps through each
    package's ``run_segment`` (the reference's TimeLoop in float64)."""
    from fv3net_tpu.runtime.config import get_config as jget_config
    from fv3net_tpu.runtime.loop import TimeLoop as JTimeLoop
    from fv3net_tpu.runtime.segmented_run import api as japi

    cfg = _config(inputs, prescribed=names.SST, **PRODUCTION)
    d = tmp_path_factory.mktemp("production")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "TimeLoop",
                   functools.partial(JTimeLoop, dtype=jnp.float64))
        jl = japi.run_segment(jget_config(cfg), str(d / "jax"))
    tl = api.run_segment(get_config(cfg), str(d / "torch"), device="cpu",
                         dtype=torch.float64)
    return jl, tl, d


def test_fused_production_segment_matches_reference(production_runs):
    jl, tl, _ = production_runs
    assert jl.fusable() and tl.fusable()
    assert tl._production_features()
    assert jl.time == tl.time
    assert_states_close(tl.state.dycore, jl.state.dycore, RTOL)
    _same_surface(tl.state.surface, jl.state.surface)
    assert set(tl.phase_report) >= {"setup", "loop_dispatch", "diag_observe",
                                    "scalar_flush", "restart_write"}


def test_fused_production_restart_read_by_reference(production_runs):
    """The port's RESTART, read by the reference's load_state, is the
    reference's own RESTART (and the port's Fortran files carry the
    reference's variables)."""
    from fv3net_tpu.runtime.checkpoint import load_state as jload_state

    _, _, d = production_runs
    got, t_got = jload_state(str(d / "torch" / "RESTART"))
    want, t_want = jload_state(str(d / "jax" / "RESTART"))
    assert t_got == t_want
    assert_states_close(got.dycore, want.dycore, RTOL)
    _same_surface({k: torch.tensor(np.asarray(v))
                   for k, v in got.surface.items()}, want.surface)
    files = sorted(os.listdir(d / "jax" / "RESTART"))
    assert sorted(os.listdir(d / "torch" / "RESTART")) == files


def test_fused_production_stores_match_reference(production_runs):
    _, _, d = production_runs
    stores = ("state_after_timestep.zarr", "diags.zarr",
              "atmos_dt_atmos.zarr")
    rows = {"state_after_timestep.zarr": 2, "diags.zarr": 1,
            "atmos_dt_atmos.zarr": 2}
    for store in stores:
        got = zarrio.open_zarr(str(d / "torch" / store))
        want = zarrio.open_zarr(str(d / "jax" / store))
        assert set(got) == set(want), store
        np.testing.assert_array_equal(got.coords["time"],
                                      want.coords["time"])
        for k in want:
            assert got[k].shape == want[k].shape, (store, k)
            assert got[k].shape[0] == rows[store], (store, k)
            # float32 rows of float64 fields within RTOL of each other
            assert rel_diff(got[k].values, want[k].values) <= max(
                RTOL, 1.2e-7), (store, k)


# ------------------------------------------------------------ fused flagship
def test_fused_flagship_path_matches_reference(inputs):
    """The fused chunk without production features (no ML, prescriber or
    prognostic surface): one chunk of 2 steps, its state and boundary
    diagnostics with their global means."""
    cfg = _config(inputs, fused_chunk_steps=2, scikit_learn=None,
                  prephysics=None)
    jl, tl = _jloop(cfg), _tloop(cfg)
    assert jl.fusable() and tl.fusable()
    assert not tl._production_features()
    (jt, jd), = list(jl)
    (tt, td), = list(tl)
    assert jt == tt
    _same_diags(td, jd)
    jm, tm = jd["__global_means__"], td["__global_means__"]
    assert tm.names == jm.names
    assert rel_diff(tm.data.numpy(), np.asarray(jm.data)) <= RTOL
    assert_states_close(tl.state.dycore, jl.state.dycore, RTOL)


# ------------------------------------------------------------ port only
def test_appended_segments_equal_one_long_segment(inputs, tmp_path):
    """Two appended segments of 2 chunks end bit for bit where one segment
    of 4 chunks ends (restart in between), and segment 2 starts where
    segment 1 ends."""
    cfg = _config(inputs, prescribed=names.SST, **dict(
        PRODUCTION, diagnostics=[], fortran_diagnostics=[]))
    url = str(tmp_path / "run")
    api.create(url, cfg)
    seg1 = api.append_segment(url, device="cpu", dtype=torch.float64)
    seg2 = api.append_segment(url, device="cpu", dtype=torch.float64)
    assert os.path.basename(seg2) == "20160801.010000"
    s1, t1 = checkpoint.load_state(os.path.join(seg1, "RESTART"))
    assert t1 == checkpoint.restart_time(os.path.join(seg1, "RESTART"))
    long = api.run_segment(get_config(dict(cfg, duration_seconds=7200.0)),
                           str(tmp_path / "long"), device="cpu",
                           dtype=torch.float64)
    s2, t2 = checkpoint.load_state(os.path.join(seg2, "RESTART"))
    assert t2 == long.time
    a = checkpoint._state_arrays(s2)
    b = checkpoint._state_arrays(long.state)
    assert set(a) == set(b)
    for k in b:
        assert torch.equal(a[k], b[k]), k


def test_cli_writes_the_reference_layout(inputs, tmp_path):
    """create / append / run-native with --device cpu lay a run out as the
    reference's CLI does."""
    from fv3net_torch.runtime.segmented_run.cli import main
    from fv3net_tpu.runtime.segmented_run.cli import main as jmain

    cfg = _config(inputs, duration_seconds=900.0, diagnostics=[
        {"name": "diags.zarr", "variables": ["ULWRFtoa"],
         "times": {"kind": "every"}}])
    cfg_path = str(tmp_path / "config.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    def layout(root):
        return sorted(os.path.relpath(os.path.join(p, n), root)
                      for p, dirs, files in os.walk(root)
                      for n in dirs + files if "RESTART/" not in
                      os.path.relpath(os.path.join(p, n), root)
                      and not n.startswith("."))

    assert main(["create", str(tmp_path / "a"), cfg_path]) == 0
    assert main(["append", str(tmp_path / "a"), "--segments", "2",
                 "--device", "cpu"]) == 0
    assert main(["run-native", cfg_path, str(tmp_path / "b"),
                 "--device", "cpu"]) == 0
    assert jmain(["run-native", cfg_path, str(tmp_path / "c")]) == 0
    b, c = layout(str(tmp_path / "b")), layout(str(tmp_path / "c"))
    assert b == c
    a = layout(str(tmp_path / "a"))
    assert len([p for p in a if p.endswith("/RESTART")]) == 2


def test_rrtmg_loop_chunk_equals_direct_chunk(inputs):
    """An RRTMG fused config (1 chunk of 2 steps, radiation every second
    step): the loop's chunk equals build_fused_production_chunk called
    directly on the same state, surface, cos-zenith and prescribed data,
    bit for bit."""
    cfg = _config(inputs, prescribed=names.SST, namelist={
        "radiation": "rrtmg", "slab_ocean": True, "sea_ice": True},
        duration_seconds=1800.0, fused_chunk_steps=2,
        radiation_interval_steps=2)
    tl = _tloop(cfg)
    dycore, surface, cosz, prescribed = tl.chunk_inputs(2)
    surface = dict(surface, **{names.TOTAL_PRECIP: torch.zeros_like(
        surface[names.TSFC])})
    want, want_surface, _ = tl.build_production_chunk(2)(
        dycore, surface, cosz, prescribed)
    (_, diags), = list(tl)
    got = checkpoint._state_arrays(tl.state)
    ref = checkpoint._state_arrays(ModelState(want, want_surface))
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert torch.isfinite(diags["ULWRFtoa"].data).all()


def test_partial_segment_and_profile(inputs, tmp_path, caplog):
    """A failure after the first chunk is a warning: the rows written so
    far and the last completed state's RESTART are kept (the reference's
    partial-segment recovery); ``profile=True`` writes a Chrome trace to
    ``<segment>/profile``."""
    import logging

    cfg = get_config(_config(inputs, duration_seconds=3600.0,
                             fused_chunk_steps=2, scikit_learn=None,
                             prephysics=None, diagnostics=[
                                 {"name": "diags.zarr",
                                  "variables": ["surface_pressure"],
                                  "times": {"kind": "every"}}]))
    real = api.DiagnosticsManager.observe
    calls = []

    def flaky(self, time, diags):
        real(self, time, diags)
        calls.append(time)
        if len(calls) == 2:
            raise RuntimeError("injected fault")

    out = str(tmp_path / "seg")
    with pytest.MonkeyPatch.context() as mp, \
            caplog.at_level(logging.WARNING):
        mp.setattr(api.DiagnosticsManager, "observe", flaky)
        loop = api.run_segment(cfg, out, profile=True, device="cpu",
                               dtype=torch.float64)
    assert any("partial" in r.message for r in caplog.records)
    state, t = checkpoint.load_state(os.path.join(out, "RESTART"))
    assert t == loop.time == calls[-1]
    assert zarrio.open_zarr(os.path.join(out, "diags.zarr"))[
        "surface_pressure"].shape[0] == 2
    with open(os.path.join(out, "profile", "trace.json")) as f:
        assert "model_step_0" in f.read()


@pytest.mark.parametrize("namelist,top", [
    ({"layout": [2, 1]}, {}),
    ({"hydrostatic": False}, {}),
    ({"microphysics": "gfdl"}, {}),
    ({"prognostic_ozone": True}, {}),
    ({"radiation": "synthband"}, {}),
    ({"surface_data": "topography/c48"}, {}),
    ({}, {"nudging": {"restarts_path": "x",
                      "timescale_hours": {"air_temperature": 3}},
          "scikit_learn": None}),
    ({}, {"radiation_scheme": {"kind": "python"}}),
    ({}, {"tendency_prescriber": {"dataset": "x", "variables": ["dQ1"]}}),
    ({}, {"bias_correction": {"dataset": "x", "variables": ["dQ1"]}}),
    ({}, {"reservoir_corrector": {"model_path": "x"}}),
    ({}, {"online_emulator": {"url": "x"}}),
    ({}, {"prephysics": [{"kind": "tendency_prescriber", "dataset": "x",
                          "variables": ["dQ1"]}]}),
])
def test_unported_options_raise(inputs, namelist, top, tmp_path):
    """Each option the port does not run raises when the loop is built.
    The options this test once held to a raise build a loop: the three
    namelist options (the nonhydrostatic core, GFDL microphysics,
    prognostic ozone) set up their fields (tests/test_torch_namelist_run.py
    holds them against the reference); the synthband radiation, the
    Python radiation stepper and the online emulator (here an emulator
    artifact stands in for the config's url) build their parts
    (tests/test_torch_synthband.py, test_torch_gfs_radiation.py and
    test_torch_emulation.py hold them against the reference)."""
    if "online_emulator" in top:
        from fv3net_torch.fit import io

        io.dump(dry_emulator_model(NPZ, torch.float64),
                str(tmp_path / "emulator"))
        top = dict(top, online_emulator={"url": str(tmp_path / "emulator")})
    cfg = _config(inputs, namelist=namelist, **top)
    ported = {"hydrostatic": "w", "microphysics": "graupel",
              "prognostic_ozone": "o3mr"}
    if namelist.get("radiation") == "synthband":
        loop = _tloop(cfg)
        assert loop._phys_cfg.radiation_scheme == "synthband"
        assert loop._radiation_fn is not None  # the per-step path's
        return
    if "radiation_scheme" in top:
        loop = _tloop(cfg)
        assert loop._radiation_stepper is not None and not loop.fusable()
        return
    if "online_emulator" in top:
        loop = _tloop(cfg)
        assert loop._microphysics_emulator is not None
        return
    key = next((k for k in namelist if k in ported), None)
    if key is None:
        with pytest.raises(NotImplementedError):
            _tloop(cfg)
        return
    d = _tloop(cfg).state.dycore
    field = ported[key]
    assert (d.w if field == "w" else d.tracers[field]) is not None
