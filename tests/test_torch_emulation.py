"""fv3net_torch's emulation hooks held against fv3net_tpu's (float64, on
the CPU): the transforms, masks and schedules, ``MicrophysicsEmulator``
with a dense model carried over in memory and through its artifact in
either direction, ``StorageHook``'s stores read by the other package,
``get_hooks`` from a yaml, ``physics_step`` with each emulator mode,
the production chunk with an emulator and a ``TimeLoop`` with
``online_emulator`` through ``run_segment``.

The reference's step, chunk and segment are compiled once each; the
reference runs are shared between tests by module-scoped fixtures."""
import datetime
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_util import (
    EMULATOR_FIELDS,
    assert_states_close,
    dry_emulator_model,
    jax_state,
    make_state_numpy,
    rel_diff,
    seeded_emulator_model,
)

from fv3net_torch.core import zarrio
from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.emulation import hooks, transforms
from fv3net_torch.fit import io
from fv3net_torch.fit.dense import params_from_jax
from fv3net_torch.physics import PhysicsConfig, physics_step
from fv3net_torch.runtime import names

jax.config.update("jax_enable_x64", True)

NPX, NPZ = 6, 8
# float64, one physics step: the port's and the reference's step in
# another order of the same operations (the physics tests' bound)
STEP_RTOL = 1e-12
# the step's diagnostics: tendencies divide state differences by dt,
# which lifts the states' 1e-12 a hundredfold where a field's change is
# small against its scale; a tendency that is zero in one package and
# roundoff in the other (the pass-through T of the dry model, ~1e-15
# K/s; CPRATsfc ~1e-19) is held absolutely
DIAG_RTOL = 1e-10
DIAG_ATOL = 1e-12
# float64, several steps: roundoff grown through the steps (the
# production chunk tests' bound)
CHUNK_RTOL = 1e-8


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _close_diags(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    bad = {}
    for k in want:
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        w = np.asarray(want[k])
        if not (rel_diff(g, w) <= DIAG_RTOL
                or np.abs(g - w).max() <= DIAG_ATOL):
            bad[k] = rel_diff(g, w)
    assert not bad, bad


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The two emulator models as port DenseModels (float64) and their
    artifact directories: the exact dry map q -> 0.99 q (T and cloud
    water passed through) and a seeded He-normal 1 x 16 model."""
    d = tmp_path_factory.mktemp("emulators")
    out = {}
    for name, build in (("dry", dry_emulator_model),
                        ("seeded", seeded_emulator_model)):
        model = build(NPZ, torch.float64)
        io.dump(model, str(d / name))
        out[name] = (model, str(d / name))
    return out


# ------------------------------------------------------------ transforms
def test_transforms_masks_and_schedules_match_reference():
    from fv3net_tpu.emulation import hooks as jhooks
    from fv3net_tpu.emulation import transforms as jtr

    rng = np.random.RandomState(0)
    x = {"a": rng.rand(3, 5) - 0.2, "b": rng.rand(3, 5)}
    emu = {"a": rng.rand(3, 5) - 0.5, "b": rng.rand(3, 5) + 0.5}

    def both(port, ref, state, *extra):
        got = port(*[{k: _t(v) for k, v in s.items()} for s in state],
                   *extra)
        want = ref(*[{k: jnp.asarray(v) for k, v in s.items()}
                     for s in state], *extra)
        assert set(got) == set(want)
        for k in want:  # exp and log may part in the last bit
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-15, atol=0)

    for tp, tj in [
        (transforms.LogTransform("b"), jtr.LogTransform("b")),
        (transforms.LimitValueTransform("a", 0.0, 0.5),
         jtr.LimitValueTransform("a", 0.0, 0.5)),
        (transforms.Difference("d", "b", "a"),
         jtr.Difference("d", "b", "a")),
        (transforms.ComposedTransform([transforms.LogTransform("b"),
                                       transforms.Difference("d", "b", "a")]),
         jtr.ComposedTransform([jtr.LogTransform("b"),
                                jtr.Difference("d", "b", "a")])),
    ]:
        both(tp.forward, tj.forward, [x])
        both(lambda y: tp.backward(tp.forward(y)),
             lambda y: tj.backward(tj.forward(y)), [x])
    t0 = datetime.datetime(2016, 8, 1)
    sched = hooks.IntervalSchedule(datetime.timedelta(hours=2), t0)
    jsched = jhooks.IntervalSchedule(datetime.timedelta(hours=2), t0)
    for k in range(12):
        t = t0 + datetime.timedelta(minutes=15 * k)
        assert sched(t) == jsched(t)
    for tm, jm in [
        (hooks.RangeMask("a", min=0.0), jhooks.RangeMask("a", min=0.0)),
        (hooks.RangeMask("b", max=0.7), jhooks.RangeMask("b", max=0.7)),
        (hooks.LevelMask("a", start=1, stop=4),
         jhooks.LevelMask("a", start=1, stop=4)),
        (hooks.LevelMask("b", stop=2, fill_value=-1.0),
         jhooks.LevelMask("b", stop=2, fill_value=-1.0)),
        (hooks.compose_masks([hooks.RangeMask("a", min=0.0),
                              hooks.LevelMask("a", start=2)]),
         jhooks.compose_masks([jhooks.RangeMask("a", min=0.0),
                               jhooks.LevelMask("a", start=2)])),
    ]:
        both(tm, jm, [x, emu])
    for minutes in (30, 75):
        tmask = hooks.TimeMask(sched)
        jmask = jhooks.TimeMask(jsched)
        tmask.set_time(t0 + datetime.timedelta(minutes=minutes))
        jmask.set_time(t0 + datetime.timedelta(minutes=minutes))
        both(tmask, jmask, [x, emu])


# ------------------------------------------------------------ the emulator
def test_microphysics_emulator_matches_reference(models, tmp_path):
    """The seeded model applied under a RangeMask to [6, ny, nx, nz]
    columns: the reference's model, the port's carried over by
    ``params_from_jax``, the port's read from the reference's artifact,
    and the reference's read from the port's artifact."""
    from fv3net_tpu import fit as jfit
    from fv3net_tpu.emulation import MicrophysicsEmulator as JEmulator
    from fv3net_tpu.emulation import RangeMask as JRangeMask

    model, path = models["seeded"]
    jmodel = jfit.load(path)  # the port's artifact, read by the reference
    jfit.dump(jmodel, str(tmp_path / "ref"))
    rng = np.random.RandomState(1)
    state = {
        "air_temperature": 250 + 40 * rng.rand(6, 3, 3, NPZ),
        "specific_humidity": 0.01 * rng.rand(6, 3, 3, NPZ),
        "cloud_water_mixing_ratio": 1e-4 * rng.rand(6, 3, 3, NPZ),
        "pressure": 1e5 * rng.rand(6, 3, 3, NPZ),
    }
    want = JEmulator(jmodel, JRangeMask("specific_humidity", min=0.0))(
        {k: jnp.asarray(v) for k, v in state.items()})
    for m in (params_from_jax(jmodel), io.load(str(tmp_path / "ref")),
              model):
        got = hooks.MicrophysicsEmulator(
            m, hooks.RangeMask("specific_humidity", min=0.0))(
            {k: _t(v) for k, v in state.items()})
        assert set(got) == set(want)
        for k in want:
            assert rel_diff(got[k].numpy(), np.asarray(want[k])) <= 1e-12, k
    assert (got["specific_humidity"] >= 0).all()
    dry = hooks.MicrophysicsEmulator(models["dry"][0])(
        {k: _t(v) for k, v in state.items()})
    q = state["specific_humidity"]
    assert rel_diff(dry["specific_humidity"].numpy(), 0.99 * q) <= 1e-13


def test_storage_hook_stores_read_by_either_package(tmp_path):
    """Each package's StorageHook store, resumed by a second hook, read
    by the other package's zarrio."""
    from fv3net_tpu.core import zarrio as jzarrio
    from fv3net_tpu.emulation import StorageHook as JStorageHook

    rng = np.random.RandomState(2)
    t0 = datetime.datetime(2016, 8, 1)
    states = [{"air_temperature": rng.rand(6, 2, 2, NPZ),
               "specific_humidity": rng.rand(6, 2, 2, NPZ)}
              for _ in range(4)]
    times = [t0 + datetime.timedelta(seconds=450 * k) for k in range(4)]
    for port, path in ((True, tmp_path / "port.zarr"),
                       (False, tmp_path / "ref.zarr")):
        for half in (slice(0, 2), slice(2, 4)):  # a resumed segment
            cls = hooks.StorageHook if port else JStorageHook
            hook = cls(str(path), 900.0, initial_time=t0)
            for s, t in zip(states[half], times[half]):
                hook({k: (_t(v) if port else jnp.asarray(v))
                      for k, v in s.items()}, t)
    for path in ("port.zarr", "ref.zarr"):
        mine = zarrio.open_zarr(str(tmp_path / path))
        theirs = jzarrio.open_zarr(str(tmp_path / path))
        assert sorted(mine) == sorted(theirs) == sorted(states[0])
        for k in states[0]:
            want = np.stack([states[0][k], states[2][k]]).astype(np.float32)
            np.testing.assert_array_equal(mine[k].values, want)
            np.testing.assert_array_equal(np.asarray(theirs[k].values), want)


def test_get_hooks_from_yaml_matches_reference(models, tmp_path,
                                               monkeypatch):
    from fv3net_tpu.emulation import get_hooks as jget_hooks

    # the models go to the card unless the caller asks for the CPU
    assert inspect.signature(hooks.get_hooks).parameters[
        "device"].default == "cuda"
    monkeypatch.chdir(tmp_path)
    gscond, micro, store = hooks.get_hooks(device="cpu")  # no fv3config.yml
    state = {"air_temperature": _t(np.ones((2, NPZ)))}
    assert gscond(state) is state and micro(state) is state
    assert store(state, datetime.datetime(2016, 8, 1)) is None
    cfg = {"zhao_carr_emulation": {
        "gscond": {"url": models["seeded"][1]},
        "model": {"path": models["dry"][1]},
        "storage": {"path": str(tmp_path / "cap.zarr"),
                    "output_freq_sec": 900.0},
    }}
    (tmp_path / "fv3config.yml").write_text(yaml.safe_dump(cfg))
    got = hooks.get_hooks(device="cpu", dtype=torch.float64)
    want = jget_hooks()
    rng = np.random.RandomState(3)
    state = {k: rng.rand(4, NPZ) for k in EMULATOR_FIELDS}
    for g, w in zip(got[:2], want[:2]):
        a = g({k: _t(v) for k, v in state.items()})
        b = w({k: jnp.asarray(v) for k, v in state.items()})
        for k in state:
            assert rel_diff(a[k].numpy(), np.asarray(b[k])) <= 1e-12, k
    got[2]({k: _t(v) for k, v in state.items()},
           datetime.datetime(2016, 8, 1))
    assert sorted(zarrio.open_zarr(str(tmp_path / "cap.zarr"))) == sorted(
        state)


# ------------------------------------------------------------ the step
MODES = {
    "microphysics": dict(model="dry", slot="microphysics_emulator"),
    "gscond": dict(model="seeded", slot="gscond_emulator"),
    "microphysics_piggy_back": dict(model="seeded",
                                    slot="microphysics_emulator",
                                    emulator_piggy_back=True),
    "gscond_piggy_back": dict(model="seeded", slot="gscond_emulator",
                              emulator_piggy_back=True),
}
PIGGY_DIAGS = {
    "microphysics_piggy_back": [
        f"{kind}_due_to_zhao_carr_{src}"
        for kind in ("tendency_of_air_temperature",
                     "tendency_of_specific_humidity",
                     "tendency_of_cloud_water", "surface_precipitation")
        for src in ("emulator", "physics")],
    "gscond_piggy_back": [
        f"tendency_of_{f}_due_to_gscond_{src}"
        for f in ("air_temperature", "specific_humidity", "cloud_water")
        for src in ("emulator", "physics")],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_physics_step_with_emulator_matches_reference(models, mode):
    """One float64 physics step of a moist C4 state with each emulator
    mode against the reference's jitted step: the state within 1e-12 of
    each field's scale, every diagnostic within DIAG_RTOL (the
    piggy-backed ones by name)."""
    from fv3net_tpu import fit as jfit
    from fv3net_tpu.emulation import MicrophysicsEmulator as JEmulator
    from fv3net_tpu.emulation import RangeMask as JRangeMask
    from fv3net_tpu.physics import PhysicsConfig as JPhysicsConfig
    from fv3net_tpu.physics import physics_step as jphysics_step

    spec = dict(MODES[mode])
    model, path = models[spec.pop("model")]
    slot = spec.pop("slot")
    st, grid, _, _ = make_state_numpy(4, NPZ, seed=2, moist=True)
    sst = 300.15 - 30 * np.sin(grid.lat) ** 2
    cosz = 0.5 * np.clip(np.cos(grid.lat) * np.cos(grid.lon), 0, 1)
    jemu = JEmulator(jfit.load(path), JRangeMask("specific_humidity",
                                                 min=0.0))
    want, dj = jax.jit(lambda s, *a: jphysics_step(
        s, *a, 900.0, JPhysicsConfig(), **{slot: jemu}, **spec))(
        jax_state(st, jnp.float64), jnp.asarray(sst), jnp.asarray(cosz),
        jnp.asarray(grid.lat))
    temu = hooks.MicrophysicsEmulator(model, hooks.RangeMask(
        "specific_humidity", min=0.0))
    got, dt_ = physics_step(state_from_numpy(st), _t(sst), _t(cosz),
                            _t(grid.lat), 900.0, PhysicsConfig(),
                            **{slot: temu}, **spec)
    assert_states_close(got, want, STEP_RTOL)
    _close_diags(dt_, dj)
    for name in PIGGY_DIAGS.get(mode, []):
        assert name in dt_, name
    if mode == "microphysics":  # the implied precipitation of the dry map
        assert (dt_["PRATEsfc"] > 0).all()
    if mode == "gscond_piggy_back":
        # the native stage advances the state: the emulator's source
        # differs from the physics' one, only the latter is applied
        e = dt_["tendency_of_specific_humidity_due_to_gscond_emulator"]
        p = dt_["tendency_of_specific_humidity_due_to_gscond_physics"]
        assert not torch.allclose(e, p)


def test_gfdl_mode_refuses_the_emulator_as_reference():
    st, grid, _, _ = make_state_numpy(4, NPZ, seed=2, moist=True)
    for k in ("ice_wat", "rainwat", "snowwat", "graupel"):
        st["tracers"][k] = np.zeros_like(st["delp"])
    sst = 300.15 - 30 * np.sin(grid.lat) ** 2
    with pytest.raises(ValueError, match="Zhao-Carr"):
        physics_step(state_from_numpy(st), _t(sst), _t(0 * sst),
                     _t(grid.lat), 900.0,
                     PhysicsConfig(microphysics_scheme="gfdl"),
                     microphysics_emulator=lambda s: s)


# ------------------------------------------------------------ the run
@pytest.fixture(scope="module")
def emulated_runs(models, tmp_path_factory):
    """One segment of 2 fused production chunks of 2 steps (gray, slab
    ocean and sea ice, C6) with ``online_emulator`` (the dry model,
    target microphysics) through each package's ``run_segment`` (the
    reference's loop in float64), and its config."""
    from fv3net_tpu.runtime.config import get_config as jget_config
    from fv3net_tpu.runtime.loop import TimeLoop as JTimeLoop
    from fv3net_tpu.runtime.segmented_run import api as japi

    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.segmented_run import api

    cfg = {
        "namelist": {"npx": NPX, "npz": NPZ, "slab_ocean": True,
                     "sea_ice": True},
        "duration_seconds": 3600.0,
        "fused_chunk_steps": 2,
        "online_emulator": {"url": models["dry"][1],
                            "target": "microphysics"},
        "diagnostics": [{"name": "diags.zarr",
                         "variables": ["air_temperature",
                                       "total_precipitation"],
                         "times": {"kind": "every"}}],
    }
    d = tmp_path_factory.mktemp("emulated")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "TimeLoop",
                   functools.partial(JTimeLoop, dtype=jnp.float64))
        jl = japi.run_segment(jget_config(cfg), str(d / "jax"))
    tl = api.run_segment(get_config(cfg), str(d / "torch"), device="cpu",
                         dtype=torch.float64)
    return jl, tl, d, cfg


def test_emulated_run_segment_matches_reference(emulated_runs):
    """The end state and surface, and the zarr diagnostics: the
    production chunk with the emulator in each package (the chunk of
    test_production_chunk_with_emulator_equals_the_loops)."""
    jl, tl, d, _ = emulated_runs
    assert jl.fusable() and tl.fusable() and tl._production_features()
    assert tl._microphysics_emulator is not None
    assert jl.time == tl.time
    # the run starts at rest without cloud water and the dry map passes
    # it through: the reference's model leaves ~1e-20 of roundoff there,
    # the port's none, so cloud water is held absolutely
    assert_states_close(tl.state.dycore, jl.state.dycore, CHUNK_RTOL,
                        fields=("delp", "pt", "wind", "sphum"))
    assert np.abs(tl.state.dycore.tracers["cloud_water"].numpy() - np.asarray(
        jl.state.dycore.tracers["cloud_water"])).max() <= 1e-18
    for k in jl.state.surface:
        assert rel_diff(tl.state.surface[k].numpy(),
                        np.asarray(jl.state.surface[k])) <= CHUNK_RTOL, k
    mine = zarrio.open_zarr(str(d / "torch" / "diags.zarr"))
    theirs = zarrio.open_zarr(str(d / "jax" / "diags.zarr"))
    for k in ("air_temperature", "total_precipitation"):
        assert rel_diff(mine[k].values, theirs[k].values) <= CHUNK_RTOL, k
    # the dry map dries every column: precipitation everywhere
    assert (mine["total_precipitation"].values > 0).all()


def test_online_emulator_targets_and_fusability(models, tmp_path):
    """``target: gscond`` moves the emulator to the gscond slot and the
    loop stays fusable, as the reference's; ``piggy_back`` reaches the
    chunk."""
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop

    base = {"namelist": {"npx": 4, "npz": NPZ}, "duration_seconds": 1800.0,
            "fused_chunk_steps": 2}
    loop = TimeLoop(get_config(dict(base, online_emulator={
        "url": models["seeded"][1], "target": "gscond",
        "piggy_back": True})), dtype=torch.float64, device="cpu")
    assert loop._gscond_emulator is not None
    assert loop._microphysics_emulator is None
    assert loop._emulator_piggy_back and loop.fusable()
    (_, diags), = list(loop)
    assert "tendency_of_specific_humidity_due_to_gscond_emulator" in diags
    off = TimeLoop(get_config(dict(base, online_emulator={
        "url": models["seeded"][1], "enabled": False})),
        dtype=torch.float64, device="cpu")
    assert off._microphysics_emulator is None and off._gscond_emulator is None


def test_production_chunk_with_emulator_equals_the_loops(emulated_runs):
    """``build_fused_production_chunk`` with the emulator, called directly
    on the loop's first chunk inputs, equals that chunk of the loop bit
    for bit (the loop's chunks are held against the reference's by
    test_emulated_run_segment_matches_reference)."""
    from fv3net_torch.runtime import checkpoint
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.derived_state import ModelState
    from fv3net_torch.runtime.loop import TimeLoop

    cfg = dict(emulated_runs[3], duration_seconds=1800.0, diagnostics=[])
    tl = TimeLoop(get_config(cfg), dtype=torch.float64, device="cpu")
    dycore, surface, cosz, prescribed = tl.chunk_inputs(2)
    surface = dict(surface, **{names.TOTAL_PRECIP: torch.zeros_like(
        surface[names.TSFC])})
    want, want_surface, want_diags = tl.build_production_chunk(2)(
        dycore, surface, cosz, prescribed)
    (_, diags), = list(tl)
    got = checkpoint._state_arrays(tl.state)
    ref = checkpoint._state_arrays(ModelState(want, want_surface))
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert torch.equal(diags[names.TOTAL_PRECIP].data,
                       want_diags[names.TOTAL_PRECIP])
    assert (want_diags[names.TOTAL_PRECIP] > 0).all()
