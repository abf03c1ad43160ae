"""The time loop's options of the port's later slice held against
``fv3net_tpu`` (float64, on the CPU): the physics switches of
``PhysicsConfig`` through ``physics_step``; the catalog's
``surface_data`` in a short gray run with Noah land over a slab ocean
and an ``out_of_sample`` scikit-learn forest and SVM as its corrector
(the reference's per-step run against the port's fused chunk, in a
module-scoped fixture); the TensorBoard event files both ways; the
mask kinds of ``runtime/masking.py``; the log parsers and ``log_times``;
and the host copies (``catalog.py``, ``runtime/logs.py``,
``runtime/fv3logs.py``, ``runtime/diagnostics/tensorboard.py``'s
encoders and the rest of the module but the sink's pull) equal to
their originals' source."""
import datetime
import functools
import glob
import inspect
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    assert_states_close,
    event_summary,
    jax_state,
    make_state_numpy,
)

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.physics import PhysicsConfig, physics_step
from fv3net_torch.runtime import names

jax.config.update("jax_enable_x64", True)

# float64, one physics step or a few model steps: roundoff only,
# relative to each field's scale
RTOL = 1e-10
RUN_RTOL = 1e-8


# ----------------------------------------------------- physics switches
def _step_inputs(npx=6, npz=12):
    st, grid, _, _ = make_state_numpy(npx, npz, seed=2, moist=True)
    sst = 300.15 - 30.0 * np.sin(grid.lat) ** 2
    cosz = np.cos(grid.lat) * np.cos(grid.lon)
    return st, sst, cosz, grid.lat


@pytest.mark.parametrize("switches", [
    {"use_convection": False},
    {"use_shallow_convection": False},
    {"top_sponge_days": 0.5, "top_sponge_pa": 30000.0,
     "top_sponge_tref": 220.0},
    {"use_shallow_convection": False, "convection_scheme": "mass_flux",
     "top_sponge_days": 2.0},
], ids=["no_convection", "no_shallow", "top_sponge", "mass_flux_sponge"])
def test_physics_switches_match_reference(switches):
    """Each switch (and the sponge with deep mass flux and no shallow
    stage) through ``physics_step`` against the reference's jitted step;
    each moves the step away from the defaults'."""
    from fv3net_tpu.physics import PhysicsConfig as JPhysicsConfig
    from fv3net_tpu.physics import physics_step as jphysics_step

    st, sst, cosz, lat = _step_inputs()
    cfg = JPhysicsConfig(**switches)
    want, dj = jax.jit(lambda s, *a: jphysics_step(s, *a, 900.0, cfg))(
        jax_state(st, jnp.float64), jnp.asarray(sst), jnp.asarray(cosz),
        jnp.asarray(lat))
    args = (state_from_numpy(st), torch.tensor(sst), torch.tensor(cosz),
            torch.tensor(lat), 900.0)
    got, dt_ = physics_step(*args, PhysicsConfig(**switches))
    assert_states_close(got, want, RTOL)
    assert dt_.keys() == dj.keys()
    for k in dj:
        w = np.asarray(dj[k])
        g = dt_[k].numpy()
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max() + 1e-18, k
    default, _ = physics_step(*args)
    assert not torch.equal(default.pt, got.pt)
    if not switches.get("use_convection", True):
        assert float(dt_["CPRATsfc"].abs().max()) == 0.0


# ---------------------------------------------------------- surface_data
NPX, NPZ = 12, 8
RUN_STEPS = 2
SKLEARN_IN = [names.TEMP, names.SPHUM]


def _run_config():
    return {
        "namelist": {"npx": NPX, "npz": NPZ,
                     "surface_data": f"topography/c{NPX}",
                     "land_model": "noah", "slab_ocean": True},
        "duration_seconds": RUN_STEPS * 900.0,
        "fused_chunk_steps": RUN_STEPS,
        "diagnostics": [],
    }


def _sklearn_model(loop, path):
    """An ``out_of_sample`` model of a scikit-learn forest and one-class
    SVM, fitted and pickled by the reference on the columns of the loop's
    first state (made-up dQ1/dQ2 of T), written to ``path``."""
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit import novelty as jnov
    from fv3net_tpu.fit.random_forest import (
        RandomForestHyperparameters, train_random_forest)

    from fv3net_torch.fit.packer import stack_columns

    first = loop._derived()
    cols = {k: stack_columns(first[k].data).numpy() for k in SKLEARN_IN}
    rng = np.random.RandomState(10)
    T = cols[names.TEMP]
    cols["dQ1"] = 2e-5 * np.sin(T / 3.0) + 1e-6 * rng.randn(*T.shape)
    cols["dQ2"] = 1e-9 * np.cos(T / 3.0)
    # the detector's samples: the first state's columns and a copy with
    # T moved by 1 K of noise; the ramp from the first state's most novel
    # column to the noisy copy's
    noisy = dict(cols, **{names.TEMP: T + rng.randn(*T.shape)})

    def ds(c):
        return JDataset({k: JQuantity(jnp.asarray(v), ("sample", "z"))
                         for k, v in c.items()})

    forest = train_random_forest(RandomForestHyperparameters(
        input_variables=SKLEARN_IN, output_variables=["dQ1", "dQ2"],
        n_estimators=3, n_jobs=1, random_state=0), [ds(cols)])
    det = jnov.OCSVMNoveltyDetector(SKLEARN_IN)
    det.fit(ds({k: np.concatenate([cols[k], noisy[k]])
                for k in SKLEARN_IN}))

    def worst(c):
        return float(np.asarray(det.predict(ds(c))["centered_score"].data)
                     .max())

    taper = {"name": "taper_ramp", "ramp_min": worst(cols),
             "ramp_max": worst(noisy)}
    jio.dump(jnov.OutOfSampleModel(forest, det, taper_config=taper), path)
    return jnov.OutOfSampleModel(forest, det, taper_config=taper), ds(cols)


@pytest.fixture(scope="module")
def surface_runs(tmp_path_factory):
    """A short gray run over the catalog's continents with Noah land and
    an ``out_of_sample`` scikit-learn model (:func:`_sklearn_model`)
    through each package's ``run_segment``: the reference's TimeLoop in
    float64 steps the host-bound forest one step at a time (its fused
    probe fails), the port's fuses the chunk and records its model's
    predictions."""
    from fv3net_tpu.ops import zenith as jzenith
    from fv3net_tpu.runtime.config import get_config as jget_config
    from fv3net_tpu.runtime.loop import TimeLoop as JTimeLoop
    from fv3net_tpu.runtime.segmented_run import api as japi

    from fv3net_torch.fit.novelty import OutOfSampleModel
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.segmented_run import api

    d = tmp_path_factory.mktemp("surface")
    cfg = _run_config()
    loop = TimeLoop(get_config(cfg), dtype=torch.float64, device="cpu")
    ref_model, first = _sklearn_model(loop, str(d / "model"))
    cfg["scikit_learn"] = {"model": [str(d / "model")]}
    # a fused chunk takes the cos-zenith of its midpoint for each of its
    # steps (both packages): the reference's per-step loop is given that
    # one for its steps
    days = jzenith.days_from_2000(loop.time + datetime.timedelta(
        seconds=RUN_STEPS * 900.0 / 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "TimeLoop",
                   functools.partial(JTimeLoop, dtype=jnp.float64))
        mp.setattr(JTimeLoop, "_cos_zenith", lambda self: (
            jzenith.cos_zenith_angle(days, self._lon_deg, self._lat_deg)))
        jl = japi.run_segment(jget_config(cfg), str(d / "jax"))
    calls, orig = [], OutOfSampleModel.predict

    def record(self, X):
        out = orig(self, X)
        calls.append((self, X, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OutOfSampleModel, "predict", record)
        tl = api.run_segment(get_config(cfg), str(d / "torch"),
                             device="cpu", dtype=torch.float64)
    return {"jax": jl, "torch": tl, "calls": calls, "path": str(d / "model"),
            "loop": loop, "ref_model": ref_model, "first": first}


def test_surface_data_run_matches_reference(surface_runs):
    """The catalog's mask, SST, sgh and surface geopotential are set as
    the reference sets them, its mountains make the land and GWD act, and
    the end state and surface match the reference's."""
    from fv3net_tpu import catalog as jcatalog

    from fv3net_torch import catalog

    jl, tl = surface_runs["jax"], surface_runs["torch"]
    name = f"topography/c{NPX}"
    got, want = catalog.get(name), jcatalog.get(name)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].data, np.asarray(want[k].data))
    assert jl.time == tl.time
    assert float(tl.state.dycore.phis.abs().max()) > 1e4  # mountains
    assert float(tl.state.surface[names.MASK].sum()) > 0
    assert_states_close(tl.state.dycore, jl.state.dycore, RUN_RTOL)
    assert set(tl.state.surface) == set(jl.state.surface)
    for k, w in jl.state.surface.items():
        w = np.asarray(w)
        g = tl.state.surface[k].numpy()
        assert np.abs(g - w).max() <= RUN_RTOL * np.abs(w).max() + 1e-14, k



def test_out_of_sample_forest_fused_run_matches_reference_per_step(
        surface_runs):
    """The run of :func:`surface_runs` with its scikit-learn model: the
    reference's loop stepped it one step at a time, the port's fused it
    (the end states are held in the test above); inside the chunk the
    port's last prediction equals the model called directly on the same
    inputs and the forest's outputs under the taper (some columns below
    1, some above 0); on the first state the port's prediction from the
    reference's pickles is the reference's."""
    from fv3net_torch.fit import io
    from fv3net_torch.runtime.steppers.machine_learning import predict

    jl, tl, calls = (surface_runs[k] for k in ("jax", "torch", "calls"))
    assert not jl.fusable() and tl.fusable()
    assert len(calls) == RUN_STEPS
    model, X, out = calls[-1]
    direct = model.predict(X)
    base = model.base_model.predict(X)
    t = direct["taper_values"].data
    assert bool((t > 0).any() and (t < 1).any())
    for k in ("dQ1", "dQ2"):
        assert torch.equal(out[k].data, direct[k].data), k
        assert torch.equal(out[k].data, base[k].data * t[:, None]), k
    want = surface_runs["ref_model"].predict(surface_runs["first"])
    got = predict(io.load(surface_runs["path"]),
                  surface_runs["loop"]._derived())
    for k in ("dQ1", "dQ2", "taper_values"):
        w = np.asarray(want[k].data)
        np.testing.assert_allclose(got[k].data.numpy(), w, rtol=0,
                                   atol=1e-12 * np.abs(w).max())

# ---------------------------------------------------------- event files
def test_event_files_read_back_both_ways(tmp_path):
    """The port's event file reads back through the reference's
    ``read_events`` and the reference's through the port's; the encoders
    give the reference's bytes."""
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.runtime.config import TimeConfig as JTimeConfig
    from fv3net_tpu.runtime.diagnostics import tensorboard as jtb
    from fv3net_tpu.runtime.diagnostics.times import (
        time_container_from_config as jtimes)

    from fv3net_torch.runtime.config import TimeConfig
    from fv3net_torch.runtime.diagnostics import tensorboard as ttb
    from fv3net_torch.runtime.diagnostics.times import (
        time_container_from_config)

    t0 = datetime.datetime(2016, 8, 1)
    rng = np.random.RandomState(1)
    field = rng.rand(6, 5, 5)
    port = ttb.TensorBoardSink(str(tmp_path / "t"), ["x"],
                               time_container_from_config(TimeConfig(), t0))
    ref = jtb.TensorBoardSink(str(tmp_path / "j"), ["x"],
                              jtimes(JTimeConfig(), t0))
    for step in range(2):
        t = t0 + datetime.timedelta(seconds=900 * step)
        port.observe(t, {"x": Quantity(torch.tensor(field + step),
                                       ("tile", "y", "x"))})
        ref.observe(t, {"x": JQuantity(jnp.asarray(field + step),
                                       ("tile", "y", "x"))})
    port.close()
    ref.close()
    (got,) = glob.glob(str(tmp_path / "t" / "events.*"))
    (want,) = glob.glob(str(tmp_path / "j" / "events.*"))
    read_got, read_want = jtb.read_events(got), ttb.read_events(want)
    assert len(read_got) == len(read_want) == 3  # the version + 2 steps
    for a, b in zip(read_got[1:], read_want[1:]):
        # the same tags, steps, scalars and PNG bytes
        assert event_summary(a) == event_summary(b)
        assert [image is not None for _, _, image in
                event_summary(a)[1]] == [False, True]
    assert ttb.encode_event(1.5, step=3, summary_values=[
        ttb.encode_summary_value("m", simple_value=0.25)]) == \
        jtb.encode_event(1.5, step=3, summary_values=[
            jtb.encode_summary_value("m", simple_value=0.25)])
    for data in (b"", b"123456789", bytes(range(256))):
        assert ttb._masked_crc(data) == jtb._masked_crc(data)
    # the copy: every function and class of the module is the original's
    # but the sink's observe (its one pull from the device)
    for name, obj in vars(jtb).items():
        if (inspect.isfunction(obj) or inspect.isclass(obj)) and \
                obj.__module__ == jtb.__name__:
            if name == "TensorBoardSink":
                for attr in ("__init__", "close"):
                    assert inspect.getsource(getattr(ttb.TensorBoardSink,
                                                     attr)) == \
                        inspect.getsource(getattr(obj, attr))
            else:
                assert inspect.getsource(getattr(ttb, name)) == \
                    inspect.getsource(obj), name


# ---------------------------------------------------------------- masks
@pytest.mark.parametrize("kind", ["default", "2021_09_16", "no_cloud",
                                  "no_cloud_no_qv", "no_sphum_bl",
                                  "no_sphum_bl_no_cloud"])
def test_mask_kinds_match_reference(kind):
    """``where_masked`` with each registered kind (and the default with
    ``ignore_humidity_below``) on tensors against the reference's."""
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.runtime import masking as jmasking

    from fv3net_torch.runtime import masking

    rng = np.random.RandomState(4)
    keys = [names.SPHUM, names.CLOUD, names.TEMP,
            names.EASTWARD_WIND_AFTER_PHYSICS]
    dims = ("tile", "z", "y", "x")
    left = {k: rng.rand(6, 24, 2, 2) for k in keys}
    right = {k: rng.rand(6, 24, 2, 2) for k in keys}
    kw = {"ignore_humidity_below": 7} if kind == "default" else {}
    want = jmasking.where_masked(
        {k: JQuantity(jnp.asarray(v), dims) for k, v in left.items()},
        {k: JQuantity(jnp.asarray(v), dims) for k, v in right.items()},
        jmasking.get_mask(kind, **kw))
    got = masking.where_masked(
        {k: Quantity(torch.tensor(v), dims) for k, v in left.items()},
        {k: Quantity(torch.tensor(v), dims) for k, v in right.items()},
        masking.get_mask(kind, **kw))
    for k in keys:
        np.testing.assert_array_equal(got[k].data.numpy(),
                                      np.asarray(want[k].data), k)
    with pytest.raises(ValueError, match="unknown mask kind"):
        masking.get_mask("nope")


# ----------------------------------------------------------- the logs
FORTRAN_LOG = """
 some unrelated fortran chatter
            2016           8           1           0          15           0
 ZS      6849.180      -412.0000       231.8707
 PS max =    1052.038      min =    439.9279
 Total surface pressure (mb) =    985.9462
 Total Water Vapor (kg/m**2) =   27.51812
 Total cloud water=  3.4418099E-02
 UA max =    138.3022      min =   -52.00678
 sphum max =   2.3002494E-02  min =   9.9999342E-10
            2016           8           1           0          30           0
 PS max =    1051.000      min =    440.1000
 Total surface pressure (mb) =    985.9000
"""
JSON_LOG = "\n".join([
    json.dumps({"time": "2016-08-01T00:15:00", "mean_T": 250.5,
                "mean_q": 0.01}),
    "not json",
    json.dumps({"time": "2016-08-01T00:30:00", "mean_T": 251.0}),
])


def test_log_parsers_and_log_times_match_reference(caplog):
    """``fv3logs.loads`` / ``concatenate`` and ``logs.loads`` on the same
    text, and ``timing.log_times``' table, against the reference's; the
    host copies equal their originals' source."""
    from fv3net_tpu import catalog as jcatalog
    from fv3net_tpu.runtime import fv3logs as jfv3logs
    from fv3net_tpu.runtime import logs as jlogs
    from fv3net_tpu.runtime import timing as jtiming

    from fv3net_torch import catalog
    from fv3net_torch.runtime import fv3logs, logs, timing

    for mod, ref in ((fv3logs, jfv3logs), (logs, jlogs)):
        assert inspect.getsource(mod) == inspect.getsource(ref).replace(
            "fv3net_tpu", "fv3net_torch")
    assert inspect.getsource(catalog).split('"""', 2)[2] == inspect.getsource(
        jcatalog).replace("fv3net_tpu", "fv3net_torch").split('"""', 2)[2]
    assert inspect.getsource(timing.log_times) == inspect.getsource(
        jtiming.log_times)
    got, want = fv3logs.loads(FORTRAN_LOG), jfv3logs.loads(FORTRAN_LOG)
    assert (got.dates, got.totals, got.ranges) == (
        want.dates, want.totals, want.ranges)
    both = fv3logs.concatenate([got, got])
    jboth = jfv3logs.concatenate([want, want])
    assert (both.dates, both.totals, both.ranges) == (
        jboth.dates, jboth.totals, jboth.ranges)
    got, want = logs.loads(JSON_LOG), jlogs.loads(JSON_LOG)
    # a series missing a step holds NaN there: compare the reprs
    assert repr((got.times, got.scalars)) == repr((want.times, want.scalars))
    tt, jt = timing.Timer(), jtiming.Timer()
    for t in (tt, jt):
        t._times.update({"dynamics": 2.0, "physics": 1.0})
        t._hits.update({"dynamics": 4, "physics": 3})
    with caplog.at_level(logging.INFO, logger="profiles"):
        assert timing.log_times(tt) == jtiming.log_times(jt)
    lines = [r.getMessage() for r in caplog.records if r.name == "profiles"]
    assert len(lines) == 2 and lines[0] == lines[1]
