"""fv3net_torch's nudging, tendency prescriber, bias correction and
stepper combinators held against fv3net_tpu's on shared seeded inputs
(float64, CPU, C6 with 8 levels): the quantile limiter, TendencyPrescriber,
CombinedStepper, IntervalStepper and PureNudger call against call within
1e-13 of scale; the factories building from one config what the
reference's build; the per-step loop's order of the steppers on one step;
the fused chunk with a "tend" prephysics stepper against the per-step
path; one step on a 2-rank gloo layout against one process.

The reference's TimeLoop is not run (it compiles for ~20 s): its
steppers are called directly, and the port's loop is held against the
port's own direct calls."""
import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_state, make_state_numpy, nudging_worker, rel_diff

from fv3net_torch.core import zarrio
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.dycore.core import GridArrays
from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.grid.geometry import make_grid
from fv3net_torch.ops.limit import DatasetQuantileLimiter
from fv3net_torch.runtime import factories, names
from fv3net_torch.runtime.config import get_config
from fv3net_torch.runtime.derived_state import DerivedState, ModelState
from fv3net_torch.runtime.loop import TimeLoop
from fv3net_torch.runtime.steppers.combine import (
    CombinedStepper,
    IntervalStepper,
)
from fv3net_torch.runtime.steppers.nudging import PureNudger
from fv3net_torch.runtime.steppers.tendency_prescriber import (
    TendencyPrescriber,
)

jax.config.update("jax_enable_x64", True)

NPX, NPZ = 6, 8
RTOL = 1e-13  # float64 stepper calls, each against the reference's
T0 = datetime.datetime(2016, 8, 1)
DT = datetime.timedelta(seconds=900)
DIMS = ("tile", "z", "y", "x")
NUDGED = (names.TEMP, names.SPHUM, names.EASTWARD_WIND,
          names.NORTHWARD_WIND, names.DELP)


def _pair(seed=7):
    """The reference's and the port's DerivedState of one seeded moist
    float64 state."""
    from fv3net_tpu.dycore.core import GridArrays as JGridArrays
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid
    from fv3net_tpu.runtime.derived_state import DerivedState as JDerived
    from fv3net_tpu.runtime.derived_state import ModelState as JModelState

    st, grid, _, _ = make_state_numpy(NPX, NPZ, seed=seed, moist=True)
    sst = 300.15 - 30.0 * np.sin(grid.lat) ** 2
    jd = JDerived(JModelState(dycore=jax_state(st, jnp.float64),
                              surface={names.TSFC: jnp.asarray(sst)}),
                  JGridArrays.from_grid(jmake_grid(NPX), dtype=jnp.float64))
    td = DerivedState(ModelState(dycore=state_from_numpy(st), surface={
        names.TSFC: torch.tensor(sst)}),
        GridArrays.from_grid(make_grid(NPX), torch.float64))
    return jd, td


def _tendency_data(n_times=3, seed=0, npx=NPX, npz=NPZ):
    """Seeded dQ1/dQ2 [time, tile, z, y, x] whose tails hold outliers
    beyond the 1% and 99% quantiles."""
    rng = np.random.RandomState(seed)
    shape = (n_times, 6, npz, npx, npx)
    dq1 = 1e-5 * rng.randn(*shape)
    dq2 = 1e-8 * rng.randn(*shape)
    for x, big in ((dq1, 1e-2), (dq2, 1e-5)):
        flat = x.reshape(n_times, -1)
        idx = rng.choice(flat.shape[1], 20, replace=False)
        flat[:, idx[:10]] = big
        flat[:, idx[10:]] = -big
    return {"dQ1": dq1, "dQ2": dq2}


def _nudge_data(td, n_times=3, seed=1):
    """Reference states [time, ...] of the nudged fields: the port's
    state plus seeded perturbations (2 K, 10% q, 3 m/s, 0.5% delp)."""
    rng = np.random.RandomState(seed)
    scale = {names.TEMP: 2.0, names.EASTWARD_WIND: 3.0,
             names.NORTHWARD_WIND: 3.0}
    out = {}
    for k in NUDGED:
        x = td[k].data.numpy()
        noise = rng.uniform(-1.0, 1.0, (n_times, *x.shape))
        if k == names.SPHUM:
            out[k] = x * (1.0 + 0.1 * noise)
        elif k == names.DELP:
            out[k] = x * (1.0 + 0.005 * noise)
        else:
            out[k] = x + scale[k] * noise
    return out


def _store(path, data):
    zarrio.to_zarr(Dataset({
        k: Quantity(v, ("time",) + DIMS) for k, v in data.items()}),
        str(path))
    return str(path)


def _getters(data):
    """(reference getter, port getter) of time -> the Dataset of the
    step's index in ``data`` (the index-keyed mapper getter's rule)."""
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    def index(time):
        return int(round((time - T0).total_seconds() / 900.0))

    def jget(time):
        i = index(time)
        return JDataset({k: JQuantity(v[i], DIMS) for k, v in data.items()})

    def tget(time):
        i = index(time)
        return Dataset({k: Quantity(v[i], DIMS) for k, v in data.items()})

    return jget, tget


def _same_outputs(got, want, rtol=RTOL):
    for g, w in zip(got, want):
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k in w:
            assert g[k].dims == w[k].dims, k
            assert rel_diff(torch.as_tensor(g[k].data).numpy(),
                            np.asarray(w[k].data)) <= rtol, k


# ------------------------------------------------------------ limiter
@pytest.mark.parametrize("feature_dims", [None, ("z",)])
def test_quantile_limiter_matches_reference(feature_dims):
    """Bounds within 1e-14 of the reference's (np.quantile against
    jnp.quantile, linear interpolation), the clipped data equal."""
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.ops.limit import DatasetQuantileLimiter as JLimiter

    data = {k: v[0] for k, v in _tendency_data(n_times=1).items()}
    dims = DIMS
    if feature_dims:  # per-level bounds of [sample, z] columns
        data = {k: np.moveaxis(v, 1, -1).reshape(-1, NPZ)
                for k, v in data.items()}
        dims = ("sample", "z")
    jds = JDataset({k: JQuantity(jnp.asarray(v), dims)
                    for k, v in data.items()})
    tds = Dataset({k: Quantity(v, dims) for k, v in data.items()})
    jl = JLimiter(0.99, 0.01, limit_only=["dQ1"]).fit(jds, feature_dims)
    tl = DatasetQuantileLimiter(0.99, 0.01, limit_only=["dQ1"]).fit(
        tds, feature_dims)
    lo, hi = tl.bounds["dQ1"]
    assert rel_diff(lo, jl._lower["dQ1"]) <= 1e-14
    assert rel_diff(hi, jl._upper["dQ1"]) <= 1e-14
    got, want = tl.transform(tds), jl.transform(jds)
    assert torch.is_tensor(got["dQ1"].data)
    assert rel_diff(got["dQ1"].data.numpy(), want["dQ1"].data) <= 1e-14
    assert got["dQ2"].data is tds["dQ2"].data  # not limited
    if feature_dims is None:
        np.testing.assert_array_equal(
            [lo, hi], np.quantile(data["dQ1"], [0.01, 0.99]))


def test_quantile_limiter_beyond_torch_quantile_size():
    """More than 2**24 values (torch.quantile's limit) fit on the host."""
    x = np.random.RandomState(0).rand(2 ** 24 + 8).astype(np.float32)
    ds = Dataset({"a": Quantity(x, ("sample",))})
    lim = DatasetQuantileLimiter(0.9, 0.1).fit(ds)
    out = lim.transform(ds)["a"].data
    lo, hi = np.quantile(x, 0.1), np.quantile(x, 0.9)
    assert out.dtype == torch.float32
    assert out.min().item() == lo and out.max().item() == hi
    with pytest.raises(ValueError, match="fit before"):
        DatasetQuantileLimiter(0.9, 0.1).transform(ds)


# ------------------------------------------------------------ steppers
@pytest.mark.parametrize("limit", [None, {"upper": 0.99, "lower": 0.01}])
def test_tendency_prescriber_matches_reference(limit):
    """Two calls (the limiter fitted on the first's data) against the
    reference's TendencyPrescriber."""
    from fv3net_tpu.runtime.steppers.tendency_prescriber import (
        TendencyPrescriber as JTendencyPrescriber,
    )

    data = _tendency_data()
    jget, tget = _getters(data)
    js = JTendencyPrescriber(jget, ["dQ1", "dQ2"], limit_quantiles=limit)
    ts = TendencyPrescriber(tget, ["dQ1", "dQ2"], limit_quantiles=limit,
                            device="cpu")
    for i in (1, 2):
        got, want = ts(T0 + i * DT, None), js(T0 + i * DT, None)
        _same_outputs(got, want)
    if limit is not None:
        lo, hi = ts.limiter.bounds["dQ1"]
        np.testing.assert_array_equal(
            [lo, hi], np.quantile(data["dQ1"][1], [0.01, 0.99]))
        assert got[0]["dQ1"].data.max().item() <= hi
        assert (data["dQ1"][2] > hi).any()  # the outliers were clipped


def test_combined_and_interval_steppers_match_reference():
    """CombinedStepper merges and rejects conflicting tendencies;
    IntervalStepper fires from its first call every interval; both as
    the reference's on the same calls."""
    from fv3net_tpu.runtime.steppers.combine import (
        CombinedStepper as JCombined,
    )
    from fv3net_tpu.runtime.steppers.combine import (
        IntervalStepper as JInterval,
    )
    from fv3net_tpu.runtime.steppers.tendency_prescriber import (
        TendencyPrescriber as JTendencyPrescriber,
    )

    data = _tendency_data(n_times=6)
    jget, tget = _getters(data)

    def pair(variables):
        return (JTendencyPrescriber(jget, variables),
                TendencyPrescriber(tget, variables, device="cpu"))

    (j1, t1), (j2, t2) = pair(["dQ1"]), pair(["dQ2"])
    jc, tc = JCombined([j1, j2]), CombinedStepper([t1, t2])
    _same_outputs(tc(T0 + DT, None), jc(T0 + DT, None))
    (j1, t1), (j3, t3) = pair(["dQ1"]), pair(["dQ1", "dQ2"])
    with pytest.raises(ValueError, match="multiple steppers"):
        CombinedStepper([t1, t3])(T0, None)
    with pytest.raises(ValueError, match="multiple steppers"):
        JCombined([j1, j3])(T0, None)
    ji = JInterval(1800.0, pair(["dQ1"])[0])
    ti = IntervalStepper(1800.0, pair(["dQ1"])[1])
    assert ti.label == ji.label == "interval_tendency_prescriber"
    fired = []
    for i in range(1, 6):
        got, want = ti(T0 + i * DT, None), ji(T0 + i * DT, None)
        _same_outputs(got, want)
        fired.append(bool(got[0]))
    assert fired == [True, False, True, False, True]


def test_nudger_matches_reference():
    """(reference - state) / tau for T, q, both winds and delp, their
    tendency names and the ``*_reference`` diagnostics, against the
    reference's PureNudger on the same state and reference."""
    from fv3net_tpu.runtime.steppers.nudging import PureNudger as JNudger

    jd, td = _pair()
    data = _nudge_data(td)
    jget, tget = _getters(data)
    taus = {k: 3 * 3600.0 for k in NUDGED}
    taus["cloud_water_mixing_ratio"] = 3600.0  # a name without a dQ
    data[names.CLOUD] = np.stack([td[names.CLOUD].data.numpy() * 1.1] * 3)
    want = JNudger(jget, taus)(T0 + DT, jd)
    got = PureNudger(tget, taus)(T0 + DT, td)
    assert set(got[0]) == {"dQ1", "dQ2", "dQu", "dQv", "dQp",
                           "cloud_water_mixing_ratio_tendency_due_to_nudging"}
    assert set(got[1]) == {f"{k}_reference" for k in taus}
    _same_outputs(got, want)
    dq1 = (data[names.TEMP][1] - td[names.TEMP].data.numpy()) / taus[
        names.TEMP]
    assert rel_diff(got[0]["dQ1"].data.numpy(), dq1) <= RTOL


def test_nudged_delp_is_set_holding_temperature():
    """add_tendency of the nudger's dQp: delp moves by dt * dQp and the
    temperature and humidity stay (the port's delp setter; the
    reference's DerivedState has no delp setter and raises)."""
    from fv3net_torch.runtime.steppers.machine_learning import add_tendency

    _, td = _pair()
    T, q = td[names.TEMP].data.clone(), td[names.SPHUM].data.clone()
    delp = td[names.DELP].data.clone()
    dqp = 1e-3 * delp
    add_tendency(td, {"dQp": Quantity(dqp, DIMS)}, 900.0)
    assert rel_diff(td[names.DELP].data.numpy(),
                    (delp + 900.0 * dqp).numpy()) <= 1e-15
    assert rel_diff(td[names.TEMP].data.numpy(), T.numpy()) <= 1e-14
    assert torch.equal(td[names.SPHUM].data, q)


def test_nudger_applies_in_name_order_whatever_the_config_order():
    """The same timescales in two orders give the same tendencies in the
    variables' name order, and add_tendency of them the same state bit
    for bit: the order a yaml round trip gives the config's mapping
    (``append_segment``) or not (``run_segment``) does not matter."""
    from fv3net_torch.runtime.steppers.machine_learning import add_tendency

    states = []
    for order in (NUDGED, tuple(reversed(NUDGED))):
        _, td = _pair()
        _, tget = _getters(_nudge_data(td))
        nudger = PureNudger(tget, {k: 3 * 3600.0 for k in order})
        assert list(nudger.timescales) == sorted(NUDGED)
        tend = nudger(T0 + DT, td)[0]
        assert list(tend) == ["dQ1", "dQu", "dQv", "dQp", "dQ2"]
        add_tendency(td, tend, 900.0)
        states.append({k: td[k].data for k in NUDGED})
    for k in NUDGED:
        assert torch.equal(states[0][k], states[1][k]), k


# ------------------------------------------------------------ factories
@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The nudging and tendency stores (C6, 8 levels, 3 times) and a
    hybrid column reservoir model (T and q in, T out) dumped by the
    reference."""
    from fv3net_tpu import fit as jfit
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.fit.reservoir import (
        ReservoirHyperparameters,
        train_hybrid_reservoir_model,
    )

    d = tmp_path_factory.mktemp("nudging")
    loop = TimeLoop(get_config({"namelist": {"npx": NPX, "npz": NPZ}}),
                    dtype=torch.float64, device="cpu")
    _store(d / "nudge.zarr", _nudge_data(loop._derived(), n_times=4))
    _store(d / "tendencies.zarr", _tendency_data(n_times=4))
    rng = np.random.RandomState(2)
    T = 250.0 + rng.randn(40, NPZ)
    q = 1e-3 * rng.rand(40, NPZ)
    u = np.concatenate([T, q], axis=1)
    hp = ReservoirHyperparameters(
        input_variables=[names.TEMP, names.SPHUM],
        output_variables=[names.TEMP], state_size=16, n_burn=2,
        l2_regularization=1.0)
    model = train_hybrid_reservoir_model(hp, [JDataset({
        "inputs": JQuantity(jnp.asarray(u[:-1]), ("time", "f")),
        "outputs": JQuantity(jnp.asarray(T[1:]), ("time", "f"))})])
    model.input_variables = [names.TEMP, names.SPHUM]
    model.output_variables = [names.TEMP]
    jfit.dump(model, str(d / "reservoir"))
    return d


def _all_steppers_config(d, **kw):
    cfg = {
        "namelist": {"npx": NPX, "npz": NPZ},
        "duration_seconds": 900.0,
        "nudging": {"restarts_path": str(d / "nudge.zarr"),
                    "timescale_hours": {k: 3.0 for k in NUDGED}},
        "prephysics": [{"kind": "tendency_prescriber",
                        "dataset": str(d / "tendencies.zarr"),
                        "variables": ["dQ1", "dQ2"],
                        "limit_quantiles": {"upper": 0.99, "lower": 0.01}}],
        "tendency_prescriber": {"dataset": str(d / "tendencies.zarr"),
                                "variables": ["dQ2"]},
        "bias_correction": {"dataset": str(d / "tendencies.zarr"),
                            "variables": ["dQ1"],
                            "apply_interval_seconds": 1800.0},
        "reservoir_corrector": {"model_path": str(d / "reservoir"),
                                "synchronize_steps": 1,
                                "reservoir_timestep_seconds": 900.0},
    }
    cfg.update(kw)
    return cfg


def test_factories_build_what_the_reference_builds(stores):
    """From one config, each factory builds the stepper the reference's
    builds: the nudger (label, timescales), the tendency prescribers
    (variables, quantiles), bias correction in an IntervalStepper, the
    reservoir pair over one model; the ML stepper wins over nudging."""
    from fv3net_tpu.runtime import factories as jfactories
    from fv3net_tpu.runtime.config import get_config as jget_config

    user = _all_steppers_config(stores)
    cfg, jcfg = get_config(user), jget_config(user)
    got = factories.get_postphysics_stepper(cfg, 900.0, device="cpu")
    want = jfactories.get_postphysics_stepper(jcfg, 900.0)
    assert type(got).__name__ == type(want).__name__ == "PureNudger"
    assert got.label == want.label == "nudging"
    assert got.timescales == want.timescales
    (tp,), (jtp,) = (factories.get_prephysics_steppers(cfg, 900.0,
                                                       device="cpu"),
                     jfactories.get_prephysics_steppers(jcfg, 900.0))
    assert isinstance(tp, TendencyPrescriber)
    assert (tp.variables, tp._limit_quantiles) == (jtp.variables,
                                                   jtp._limit_quantiles)
    got_tp = factories.get_tendency_prescriber(cfg, 900.0, device="cpu")
    want_tp = jfactories.get_tendency_prescriber(jcfg, 900.0)
    assert (got_tp.label, got_tp.variables) == (want_tp.label,
                                                want_tp.variables)
    _same_outputs(got_tp(T0 + DT, None), want_tp(T0 + DT, None))
    bc = factories.get_bias_correction(cfg, 900.0, device="cpu")
    jbc = jfactories.get_bias_correction(jcfg, 900.0)
    assert bc.label == jbc.label == "interval_bias_correction"
    assert bc.stepper.label == "bias_correction" and bc.interval == 1800.0
    inc, pred = factories.get_reservoir_steppers(cfg, 900.0, device="cpu")
    jinc, jpred = jfactories.get_reservoir_steppers(jcfg, 900.0)
    assert (inc.label, pred.label) == (jinc.label, jpred.label)
    assert inc.model is pred.model and inc.config == pred.config
    assert (inc.config.synchronize_steps, inc.input_variables) == (
        jinc.config.synchronize_steps, jinc.input_variables)
    assert type(inc.model).__name__ == "HybridReservoirComputingModel"
    assert inc.model.W.dtype == torch.float32  # the reference's float32
    for build in (factories.get_prephysics_steppers,
                  factories.get_tendency_prescriber,
                  factories.get_bias_correction,
                  factories.get_reservoir_steppers):
        import inspect

        assert inspect.signature(build).parameters[
            "device"].default == "cuda"
    empty = get_config({"namelist": {"npx": NPX, "npz": NPZ}})
    assert factories.get_tendency_prescriber(empty, 900.0) is None
    assert factories.get_bias_correction(empty, 900.0) is None
    assert factories.get_reservoir_steppers(empty, 900.0) == (None, None)
    assert factories.get_postphysics_stepper(empty, 900.0) is None


@pytest.mark.parametrize("key,fusable", [
    ("nudging", False), ("prephysics", True), ("tendency_prescriber", False),
    ("bias_correction", False), ("reservoir_corrector", False)])
def test_fusable_follows_the_reference_rule(stores, key, fusable):
    """Only the prephysics tendency prescriber fuses; the nudger, the
    top-level prescriber, bias correction and the reservoir keep the
    per-step path."""
    full = _all_steppers_config(stores, fused_chunk_steps=2,
                                duration_seconds=1800.0)
    cfg = {k: v for k, v in full.items()
           if k in ("namelist", "duration_seconds", "fused_chunk_steps", key)}
    loop = TimeLoop(get_config(cfg), dtype=torch.float64, device="cpu")
    assert loop.fusable() is fusable


def test_per_step_order_of_the_steppers(stores):
    """One step with every stepper: the reservoir incrementer, the
    prephysics prescriber, the dynamics, the physics, the top-level
    prescriber, the nudger, bias correction and the reservoir predictor
    run in the reference's order; the nudger's tendencies and references
    and every prescriber's tendencies are among the diagnostics."""
    loop = TimeLoop(get_config(_all_steppers_config(stores)),
                    dtype=torch.float64, device="cpu")
    order = []
    apply, dyn, phys = (loop._apply_stepper, loop._step_dynamics,
                        loop._step_physics)

    def record(name, fn):
        def call(*a, **k):
            order.append(name(*a) if callable(name) else name)
            return fn(*a, **k)
        return call

    loop._apply_stepper = record(lambda s, *a: s.label, apply)
    loop._step_dynamics = record("dynamics", dyn)
    loop._step_physics = record("physics", phys)
    (_, diags), = list(loop)
    assert order == ["reservoir_incrementer", "tendency_prescriber",
                     "dynamics", "physics", "tendency_prescriber",
                     "nudging", "interval_bias_correction",
                     "reservoir_predictor"]
    for k in ("dQ1_nudging", "dQp_nudging", "air_temperature_reference",
              "dQ2_tendency_prescriber", "dQ1_bias_correction",
              "tendency_of_air_temperature_due_to_tendency_prescriber"):
        assert k in diags or k.replace("_bias_correction",
                                       "_interval_bias_correction") in diags
    for k, v in loop.state.surface.items():
        assert torch.isfinite(v).all(), k


def test_fused_tend_chunk_matches_per_step(stores):
    """The prephysics tendency prescriber (limited) with the slab ocean:
    two fused chunks of 2 steps ("tend"; the prefetch and the fitted
    limiter carried over a chunk boundary) against 4 per-step steps of
    the same config, each per-step step given its chunk's cos-zenith (a
    chunk takes its midpoint's), within 1e-10 of each field's scale.
    (The reference's own fused "tend" path raises.)"""
    d = stores
    base = _all_steppers_config(d, duration_seconds=3600.0)
    cfg = {k: base[k] for k in ("namelist", "duration_seconds",
                                "prephysics")}
    cfg["namelist"] = dict(cfg["namelist"], slab_ocean=True)
    fused = TimeLoop(get_config(dict(cfg, fused_chunk_steps=2)),
                     dtype=torch.float64, device="cpu")
    assert fused.fusable()
    start = fused.time
    cosz = []
    for c in range(2):
        fused.time = start + 2 * c * DT
        cosz.append(fused.chunk_cos_zenith(2))
    fused.time = start
    per_step = TimeLoop(get_config(cfg), dtype=torch.float64, device="cpu")
    assert not per_step.fusable()
    # the loop's time is the step's end when its physics runs
    per_step._cos_zenith = lambda time: cosz[((time - start) // DT - 1) // 2]
    assert sum(1 for _ in fused) == 2
    assert sum(1 for _ in per_step) == 4
    assert fused.time == per_step.time
    a, b = fused._derived(), per_step._derived()
    for k in NUDGED + ("surface_pressure",):
        assert rel_diff(a[k].data.numpy(), b[k].data.numpy()) <= 1e-10, k
    for k in ("ocean_surface_temperature", names.TSFC):
        assert rel_diff(fused.state.surface[k].numpy(),
                        per_step.state.surface[k].numpy()) <= 1e-10, k
    tp = fused._prephysics_steppers[0]
    assert tp.limiter is not None


def test_nudged_two_ranks_against_one_process(tmp_path):
    """Two per-step steps with the nudger and a limited prephysics
    tendency prescriber on a (2, 1) gloo layout: each rank's block of the
    state equals the one-process run's within 1e-12 of scale (1e-14
    absolutely for fields of roundoff size)."""
    from fv3net_torch.parallel import sharded

    from torch_port_util import STEPPER_LAYOUT

    loop = TimeLoop(get_config({"namelist": {"npx": 8, "npz": 8}}),
                    dtype=torch.float64, device="cpu")
    _store(tmp_path / "nudge.zarr", _nudge_data(loop._derived(),
                                                n_times=3))
    _store(tmp_path / "tendencies.zarr", _tendency_data(n_times=3, npx=8))
    threads = max(1, torch.get_num_threads() // 2)
    results = sharded.launch(nudging_worker, 2, (str(tmp_path), threads))
    assert STEPPER_LAYOUT == (2, 1)
    whole = results[0]["single"]
    for res in results:
        ys, xs = res["block"]
        for k, v in res["state"].items():
            want = whole[k][..., ys, xs]
            assert (rel_diff(v, want) <= 1e-12
                    or np.abs(v - want).max() <= 1e-14), k
    # the nudging moved the state toward the reference
    assert os.path.exists(tmp_path / "nudge.zarr")
