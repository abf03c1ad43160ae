"""fv3net_torch's reservoir models, trainers and runtime steppers held
against fv3net_tpu's on shared seeded inputs (CPU): the reservoir
matrices and the subdomain divider bit for bit; increment, predict and
the three trainers in float32 (as the reference computes them) and in
float64 (the reference's float32 casts read as float64 in the test, the
port's ``STATE_DTYPE`` set to float64); artifacts both ways; the stepper
pair's order, time averaging, warm start and diagnostic-only mode; the
corrector in the port's TimeLoop against direct calls; the subdomain
model under a 2-rank layout against one process.

The float32 trainers are held to three times the reference's own
float32 error against its float64 run, plus 1e-6 of scale: their
readout solves a ridge system of as many features as the reservoir has
states from fewer samples, whose float32 solution carries the
conditioning's roundoff, so that the two packages' summation orders part
by what float32 itself errs, not by float32's epsilon."""
import dataclasses
import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    column_reservoir_worker,
    rel_diff,
    reservoir_worker,
    serial_solves,
)

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import io
from fv3net_torch.fit import reservoir as tres
from fv3net_torch.fit.domain import CubeXYDivider
from fv3net_torch.runtime.steppers import reservoir as tsteppers

jax.config.update("jax_enable_x64", True)

NZ = 4  # levels of the column series (2 NZ input features)
T0 = datetime.datetime(2016, 8, 1)
DT = datetime.timedelta(seconds=900)
F64_RTOL = 1e-10  # float64 against float64: summation order only
F32_STEP_RTOL = 1e-5  # float32 increments and readouts (500-term sums)


class _Float64(object):
    """A module (numpy or jax.numpy) with its ``float32`` read as
    float64: the reference's reservoir module under it builds its
    matrices, state and series in float64."""

    def __init__(self, module, f64):
        self._module = module
        self.float32 = f64

    def __getattr__(self, name):
        return getattr(self._module, name)


@pytest.fixture
def float64_everywhere(monkeypatch):
    """The reference's reservoir casts read as float64, and the port's
    STATE_DTYPE float64, for one test."""
    from fv3net_tpu.fit import reservoir as jres

    monkeypatch.setattr(jres, "np", _Float64(np, np.float64))
    monkeypatch.setattr(jres, "jnp", _Float64(jnp, jnp.float64))
    monkeypatch.setattr(tres, "STATE_DTYPE", torch.float64)


def _column_series(nt=60, nz=NZ, seed=0):
    """[nt, 2 nz] columns of T and q around a profile, seeded, and the
    next-step T targets [nt - 1, nz]."""
    rng = np.random.RandomState(seed)
    T = np.linspace(210.0, 295.0, nz) + 5.0 * rng.randn(nt, 1) \
        + rng.randn(nt, nz)
    q = np.linspace(1e-5, 0.012, nz) * (1.0 + 0.2 * rng.rand(nt, nz))
    u = np.concatenate([T, q], axis=1)
    return u[:-1], u[1:, :nz]


def _cube_series(nt=40, n=8, nf=2, seed=0):
    """A smooth traveling pattern on the cube [nt, 6, n, n, nf]."""
    rng = np.random.RandomState(seed)
    base = rng.randn(6, n, n, nf)
    out = np.empty((nt, 6, n, n, nf))
    for t in range(nt):
        out[t] = np.roll(base, t, axis=2) + 0.01 * rng.randn(6, n, n, nf)
    return out


def _jds(u, y, dims, dtype=np.float64):
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    return JDataset({"inputs": JQuantity(jnp.asarray(u, dtype), dims),
                     "outputs": JQuantity(jnp.asarray(y, dtype), dims)})


def _tds(u, y, dims):
    return Dataset({"inputs": Quantity(torch.tensor(u), dims),
                    "outputs": Quantity(torch.tensor(y), dims)})


COLUMN_HP = dict(state_size=40, n_burn=5, seed=3, l2_regularization=1e-3)
CUBE_HP = dict(state_size=32, n_burn=5, seed=1, l2_regularization=1e-3)


def _jhp(**kw):
    from fv3net_tpu.fit.reservoir import ReservoirHyperparameters

    return ReservoirHyperparameters(**kw)


def _subdomain_hps(hybrid):
    from fv3net_tpu.fit.reservoir import SubdomainReservoirHyperparameters

    kw = dict(subdomain_layout=(2, 2), overlap=1, hybrid=hybrid)
    return (SubdomainReservoirHyperparameters(reservoir=_jhp(**CUBE_HP),
                                              **kw),
            tres.SubdomainReservoirHyperparameters(
                reservoir=tres.ReservoirHyperparameters(**CUBE_HP), **kw))


def _train_pair(kind, hybrid=False):
    """(reference model, port model) trained on the same series."""
    from fv3net_tpu.fit import reservoir as jres

    if kind == "column":
        u, y = _column_series()
        jm = jres._train_reservoir(_jhp(**COLUMN_HP),
                                   [_jds(u, y, ("time", "f"))], hybrid)
        tm = tres._train_reservoir(tres.ReservoirHyperparameters(
            **COLUMN_HP), [_tds(u, y, ("time", "f"))], hybrid)
        return jm, tm
    s = _cube_series()
    dims = ("time", "tile", "y", "x", "f")
    jhp, thp = _subdomain_hps(hybrid)
    jm = jres.train_subdomain_reservoir(jhp, [_jds(s[:-1], s[1:], dims)])
    with serial_solves():
        tm = tres.train_subdomain_reservoir(thp,
                                            [_tds(s[:-1], s[1:], dims)])
    return jm, tm


def _held_out(kind, dtype):
    """Three held-out inputs of each kind (increment, increment, read)."""
    if kind == "column":
        u, _ = _column_series(nt=4, seed=9)
        return [np.repeat(x[None], 5, axis=0).astype(dtype) for x in u[:3]]
    return list(_cube_series(nt=3, seed=9).astype(dtype))


def _rollout(model, inputs, array, batch):
    """Reset, increment twice and read out: the prediction as numpy."""
    if batch:
        model.reset_state(batch_shape=(inputs[0].shape[0],))
    else:
        model.reset_state()
    for x in inputs[:2]:
        model.increment(array(x))
    return np.asarray(model.predict_from_state(array(inputs[2])))


def _both_rollouts(jm, tm, kind):
    batch = kind == "column"
    inputs = _held_out(kind, np.float32)
    want = _rollout(jm, inputs, jnp.asarray, batch)
    got = _rollout(tm, inputs, torch.tensor, batch)
    return got, want


# ------------------------------------------------------------ matrices
@pytest.mark.parametrize("n_input,state_size,seed", [
    (3, 100, 1), (64, 500, 0), (7, 33, 5)])
def test_build_reservoir_matrices_bit_for_bit(n_input, state_size, seed):
    """W_in and W, the reference's RandomState draws and float32 cast."""
    from fv3net_tpu.fit.reservoir import build_reservoir_matrices

    kw = dict(state_size=state_size, seed=seed, spectral_radius=0.7)
    jW_in, jW = build_reservoir_matrices(n_input, _jhp(**kw))
    W_in, W = tres.build_reservoir_matrices(
        n_input, tres.ReservoirHyperparameters(**kw))
    assert W_in.dtype == W.dtype == torch.float32
    np.testing.assert_array_equal(W_in.numpy(), np.asarray(jW_in))
    np.testing.assert_array_equal(W.numpy(), np.asarray(jW))


def test_spectral_radius_scaling():
    hp = tres.ReservoirHyperparameters(state_size=100, spectral_radius=0.5,
                                       seed=1)
    _, W = tres.build_reservoir_matrices(3, hp)
    eigs = np.abs(np.linalg.eigvals(W.numpy()))
    np.testing.assert_allclose(eigs.max(), 0.5, rtol=0.05)


# ------------------------------------------------------------ divider
@pytest.mark.parametrize("layout,overlap,nz", [
    ((2, 2), 0, 3), ((2, 2), 1, 0), ((2, 2), 2, 3), ((1, 2), 1, 2),
    ((4, 4), 1, 0)])
def test_divider_matches_reference(layout, overlap, nz):
    """get_subdomains, flatten and merge_subdomains bit for bit against
    fv3net_tpu/fit/domain.py, cross-tile overlap included."""
    from fv3net_tpu.fit.domain import CubeXYDivider as JDivider

    rng = np.random.RandomState(sum(layout) + overlap + nz)
    field = rng.rand(6, 8, 8, nz) if nz else rng.rand(6, 8, 8)
    jdiv = JDivider(layout, overlap, (8, 8))
    div = CubeXYDivider(layout, overlap, (8, 8))
    assert div.n_subdomains == jdiv.n_subdomains
    assert div.subdomain_extent == jdiv.subdomain_extent
    want = np.asarray(jdiv.get_subdomains(jnp.asarray(field)))
    got = div.get_subdomains(torch.tensor(field))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        div.flatten_subdomain_features(got).numpy(),
        np.asarray(jdiv.flatten_subdomain_features(jnp.asarray(want))))
    o = overlap
    interior = want[:, o:want.shape[1] - o, o:want.shape[2] - o]
    np.testing.assert_array_equal(
        div.merge_subdomains(torch.tensor(interior)).numpy(),
        np.asarray(jdiv.merge_subdomains(jnp.asarray(interior))))
    np.testing.assert_array_equal(
        div.merge_subdomains(torch.tensor(interior)).numpy(), field)


def test_divider_overlap_is_neighbor_data():
    """Overlap cells within a tile equal the adjacent subdomain's edge."""
    field = torch.arange(6 * 8 * 8, dtype=torch.float64).reshape(6, 8, 8)
    div = CubeXYDivider((2, 2), overlap=1, rank_extent=(8, 8))
    subs = div.get_subdomains(field)
    assert subs.shape == (24, 6, 6)
    np.testing.assert_array_equal(subs[0, 1:-1, -1].numpy(),
                                  field[0, 0:4, 4].numpy())
    with pytest.raises(ValueError, match="not divisible"):
        CubeXYDivider((3, 3), 1, (8, 8))


# ------------------------------------------------------------ models
@pytest.mark.parametrize("kind,hybrid", [
    ("column", False), ("column", True), ("cube", False), ("cube", True)])
def test_reference_model_increment_predict_float32(kind, hybrid):
    """The reference's trained float32 model carried over by
    ``reservoir_from_jax``: two increments and a readout on held-out
    inputs, float32 as the reference computes, within F32_STEP_RTOL of
    scale (float32 sums of up to 500 terms in another order)."""
    jm, _ = _train_pair(kind, hybrid)
    tm = tres.reservoir_from_jax(jm)
    assert type(tm).__name__ == type(jm).__name__
    got, want = _both_rollouts(jm, tm, kind)
    assert got.dtype == want.dtype == np.float32
    assert rel_diff(got, want) <= F32_STEP_RTOL
    assert rel_diff(tm.state.numpy(), np.asarray(jm.state)) <= F32_STEP_RTOL


@pytest.mark.parametrize("kind,hybrid", [
    ("column", False), ("column", True), ("cube", False), ("cube", True)])
def test_trainers_float64(kind, hybrid, float64_everywhere):
    """The trainers with every float32 cast read as float64 on both
    sides: held-out rollouts within F64_RTOL.  (The readout's
    coefficients themselves agree only to the ridge system's condition
    number times float64's epsilon, ~1e-10 for the hybrid subdomain
    model's 104 features from 34 samples.)"""
    jm, tm = _train_pair(kind, hybrid)
    assert tm.coefficients.dtype == torch.float64
    batch = kind == "column"
    inputs = _held_out(kind, np.float64)
    want = _rollout(jm, inputs, jnp.asarray, batch)
    got = _rollout(tm, inputs, torch.tensor, batch)
    assert rel_diff(got, want) <= F64_RTOL


@pytest.mark.parametrize("kind,hybrid", [
    ("column", False), ("column", True), ("cube", False), ("cube", True)])
def test_trainers_float32_within_the_references_own_error(
        kind, hybrid, monkeypatch):
    """The float32 trainers (the reference's precision): held-out
    rollouts within 3x the reference's float32 error against its float64
    run, plus 1e-6 of scale (see the module docstring)."""
    from fv3net_tpu.fit import reservoir as jres

    jm, tm = _train_pair(kind, hybrid)
    assert tm.coefficients.dtype == torch.float32
    got, want = _both_rollouts(jm, tm, kind)
    with monkeypatch.context() as mp:
        mp.setattr(jres, "np", _Float64(np, np.float64))
        mp.setattr(jres, "jnp", _Float64(jnp, jnp.float64))
        j64, _ = _train_pair(kind, hybrid)
    batch = kind == "column"
    control = _rollout(j64, _held_out(kind, np.float64), jnp.asarray, batch)
    own = rel_diff(want, control)
    assert rel_diff(got, want) <= 3.0 * own + 1e-6, (rel_diff(got, want),
                                                    own)


def test_offline_predict_matches_reference():
    """``predict`` (the stateless rollout) of a carried-over hybrid column
    model and of a subdomain model, float32 inputs (the reference's
    column rollout needs them: its scan carry is float32)."""
    for kind in ("column", "cube"):
        jm, _ = _train_pair(kind, hybrid=True)
        tm = tres.reservoir_from_jax(jm)
        u, y = ((_column_series(nt=12, seed=4)) if kind == "column" else
                (_cube_series(nt=5, seed=4),) * 2)
        dims = (("time", "f") if kind == "column"
                else ("time", "tile", "y", "x", "f"))
        want = np.asarray(jm.predict(_jds(u, u, dims, np.float32))[
            "outputs"].data)
        got = tm.predict(_tds(u.astype(np.float32), u.astype(np.float32),
                              dims))["outputs"].data.numpy()
        assert rel_diff(got, want) <= F32_STEP_RTOL, kind


@pytest.mark.parametrize("kind,hybrid", [
    ("column", False), ("column", True), ("cube", False)])
def test_artifacts_read_both_ways(kind, hybrid, tmp_path):
    """A model the reference dumped loads in the port, and one the port
    dumped loads in the reference, each predicting as the model it was
    dumped from did (the same arrays: bit for bit in the package that
    loads it)."""
    from fv3net_tpu import fit as jfit

    jm, tm = _train_pair(kind, hybrid)
    jfit.dump(jm, str(tmp_path / "ref"))
    io.dump(tm, str(tmp_path / "port"))
    name = {("column", False): "pure-reservoir",
            ("column", True): "hybrid-reservoir",
            ("cube", False): "subdomain-reservoir"}[kind, hybrid]
    for d in ("ref", "port"):
        assert (tmp_path / d / "name").read_text() == name
    batch = kind == "column"
    inputs = _held_out(kind, np.float32)
    from_ref = io.load(str(tmp_path / "ref"))
    assert type(from_ref).__name__ == type(jm).__name__
    np.testing.assert_array_equal(
        _rollout(from_ref, inputs, torch.tensor, batch),
        _rollout(tres.reservoir_from_jax(jm), inputs, torch.tensor, batch))
    from_port = jfit.load(str(tmp_path / "port"))
    assert type(from_port).__name__ == type(tm).__name__
    for k in ("W_in", "W", "coefficients", "intercept"):
        np.testing.assert_array_equal(np.asarray(getattr(from_port, k)),
                                      getattr(tm, k).numpy())
    assert rel_diff(_rollout(from_port, inputs, jnp.asarray, batch),
                    _rollout(tm, inputs, torch.tensor, batch)) \
        <= F32_STEP_RTOL


def test_trainers_registered_and_config_from_dict():
    from fv3net_torch.fit import train

    for name in ("reservoir", "hybrid_reservoir", "subdomain_reservoir"):
        assert callable(train.get_training_function(name))
    cfg = train.TrainingConfig.from_dict({
        "model_type": "subdomain_reservoir",
        "hyperparameters": {"subdomain_layout": [2, 2],
                            "reservoir": {"state_size": 20}}})
    assert cfg.hyperparameters.reservoir.state_size == 20
    assert cfg.hyperparameters.subdomain_layout == (2, 2)


# ------------------------------------------------------------ steppers
def test_finite_state_machine_enforces_order():
    fsm = tsteppers._FiniteStateMachine()
    with pytest.raises(ValueError, match="incremented before"):
        fsm(fsm.PREDICT)
    fsm(fsm.INCREMENT)
    fsm(fsm.PREDICT)
    with pytest.raises(ValueError):
        fsm(fsm.PREDICT)  # two predicts without a new increment
    assert fsm.completed_increments == 1


def test_incrementer_time_averages_at_reservoir_cadence():
    """The incrementer accumulates model-step inputs and fires with their
    mean every reservoir_timestep_seconds (the first call fires)."""
    fired = []

    class FakeSpatialModel:
        divider = object()  # marks the model as a subdomain one
        input_variables = ["a"]

        def increment(self, u):
            fired.append(u.clone())

    inc = tsteppers.ReservoirIncrementOnlyStepper(
        FakeSpatialModel(), tsteppers.ReservoirConfig(
            reservoir_timestep_seconds=1800.0))

    def state_with(value):
        return {"a": Quantity(torch.full((6, 4, 4), value),
                              ("tile", "y", "x"))}

    inc(T0, state_with(1.0))
    assert len(fired) == 1 and torch.all(fired[0] == 1.0)
    inc(T0 + DT, state_with(2.0))
    assert len(fired) == 1
    inc(T0 + 2 * DT, state_with(4.0))
    assert len(fired) == 2 and torch.all(fired[1] == 3.0)
    assert fired[1].shape == (6, 4, 4, 1)
    assert inc.completed_sync_steps == 2 and inc._fsm.pending_predict


def _column_state(n=3, nz=NZ, seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    T = np.linspace(210.0, 295.0, nz)[None, :, None, None] \
        + rng.randn(6, nz, n, n)
    q = 0.01 * rng.rand(6, nz, n, n)
    delp = np.full((6, nz, n, n), 100.0)
    dims = ("tile", "z", "y", "x")
    return {k: v.astype(dtype) for k, v in
            (("air_temperature", T), ("specific_humidity", q),
             ("pressure_thickness_of_atmospheric_layer", delp))}, dims


def test_stepper_pair_matches_reference():
    """The reference's hybrid column model (T and q in, T out) through
    both packages' incrementer and predictor over 6 steps of seeded
    float64 states (reservoir step 1800 s, 1 synchronization step):
    the model's state after each step and every prediction within
    F64_RTOL (the float32 matrices meet float64 inputs in float64 on
    both sides), on the same steps."""
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.runtime.steppers import reservoir as jsteppers

    jm, _ = _train_pair("column", hybrid=True)
    jm.input_variables = ["air_temperature", "specific_humidity"]
    jm.output_variables = ["air_temperature"]
    tm = tres.reservoir_from_jax(jm)
    kw = dict(synchronize_steps=1, reservoir_timestep_seconds=1800.0)
    jpair = (jsteppers.ReservoirIncrementOnlyStepper(
        jm, jsteppers.ReservoirConfig(**kw)),
        jsteppers.ReservoirPredictStepper(jm, jsteppers.ReservoirConfig(
            **kw)))
    tpair = (tsteppers.ReservoirIncrementOnlyStepper(
        tm, tsteppers.ReservoirConfig(**kw)),
        tsteppers.ReservoirPredictStepper(tm, tsteppers.ReservoirConfig(
            **kw)))
    predicted = []
    for i in range(6):
        fields, dims = _column_state(seed=i)
        js = {k: JQuantity(jnp.asarray(v), dims) for k, v in fields.items()}
        ts = {k: Quantity(torch.tensor(v), dims) for k, v in fields.items()}
        t = T0 + i * DT
        for jst, tst in zip(jpair, tpair):
            jt, jd, ju = jst(t, js)
            tt, td, tu = tst(t, ts)
            assert (set(jt), set(jd), set(ju)) == (set(tt), set(td), set(tu))
            for k in ju:
                assert rel_diff(tu[k].data.numpy(),
                                np.asarray(ju[k].data)) <= F64_RTOL
                predicted.append(i)
        assert rel_diff(tm.state.numpy(), np.asarray(jm.state)) <= F64_RTOL
        assert tm.state.dtype == torch.float64
    assert predicted == [2, 4]  # increments at 0, 2, 4; the first syncs
    assert tpair[0].completed_sync_steps == 3


def test_warm_start_rename_and_diagnostic_only(tmp_path):
    """warm_start restores the saved state and skips synchronization;
    rename_mapping reads the run-side names; diagnostic_only returns the
    prediction as a diagnostic and updates nothing."""
    class FakeModel:
        input_variables = ["T_model"]
        output_variables = ["T_model"]
        output_features = [NZ]
        state = torch.zeros((6 * 3 * 3, 16))

        def reset_state(self, batch_shape=()):
            self.state = torch.zeros(tuple(batch_shape) + (16,))

        def increment(self, u):
            assert u.shape == (6 * 3 * 3, NZ)

        def predict_from_state(self, u):
            return torch.full((u.shape[0], NZ), 5.0)

    model = FakeModel()
    model.state = torch.ones((6 * 3 * 3, 16)) * 7.0
    path = tsteppers.save_reservoir_state(model, str(tmp_path))
    assert os.path.basename(path) == "reservoir_state.npz"
    model.reset_state((6 * 3 * 3,))
    rc = tsteppers.ReservoirConfig(
        model_path=str(tmp_path), synchronize_steps=100,
        rename_mapping={"T_model": "air_temperature"},
        diagnostic_only=True, warm_start=True)
    inc = tsteppers.ReservoirIncrementOnlyStepper(model, rc)
    pred = tsteppers.ReservoirPredictStepper(model, rc)
    assert float(model.state[0, 0]) == 7.0
    fields, dims = _column_state()
    state = {k: Quantity(torch.tensor(v), dims) for k, v in fields.items()}
    inc(T0, state)
    tend, diags, updates = pred(T0, state)
    assert tend == {} and updates == {}
    q = diags["air_temperature_reservoir_prediction"]
    assert q.data.shape == (6, NZ, 3, 3) and torch.all(q.data == 5.0)
    with pytest.raises(FileNotFoundError, match="warm_start"):
        tsteppers.ReservoirIncrementOnlyStepper(
            FakeModel(), dataclasses.replace(rc, model_path=str(
                tmp_path / "none")))


def _subdomain_model(n, nz, hybrid=False):
    """A port subdomain model (T in, T out) trained on a seeded series of
    T fields near an isothermal 250 K, [6, n, n, nz]."""
    rng = np.random.RandomState(0)
    series = 250.0 + 0.01 * rng.randn(12, 6, n, n, nz)
    hp = tres.SubdomainReservoirHyperparameters(
        input_variables=["air_temperature"],
        output_variables=["air_temperature"], subdomain_layout=(1, 1),
        overlap=1, hybrid=hybrid,
        reservoir=tres.ReservoirHyperparameters(state_size=16, n_burn=2,
                                                l2_regularization=1.0))
    dims = ("time", "tile", "y", "x", "f")
    with serial_solves():
        return tres.train_subdomain_reservoir(
            hp, [_tds(series[:-1], series[1:], dims)])


def test_subdomain_corrector_in_the_loop_against_direct_calls(tmp_path):
    """A subdomain model as the config's reservoir_corrector in a C6
    float64 TimeLoop (3 steps, reservoir step = model step, 1
    synchronization step): each step increments on the state before its
    dynamics and, from the second step, predicts last, its prediction
    landing in the state; the same model called directly on the recorded
    states gives the same reservoir states and predictions."""
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop

    io.dump(_subdomain_model(6, 8), str(tmp_path / "model"))
    cfg = get_config({
        "namelist": {"npx": 6, "npz": 8}, "duration_seconds": 2700.0,
        "reservoir_corrector": {"model_path": str(tmp_path / "model"),
                                "synchronize_steps": 1,
                                "reservoir_timestep_seconds": 900.0}})
    loop = TimeLoop(cfg, dtype=torch.float64, device="cpu")
    assert not loop.fusable()
    inc, pred = loop._reservoir_incrementer, loop._reservoir_predictor
    assert inc.model is pred.model and inc._fsm is pred._fsm
    calls = []

    class Recorded:
        def __init__(self, stepper):
            self.stepper, self.label = stepper, stepper.label

        def __call__(self, time, state):
            out = self.stepper(time, state)
            calls.append((self.label, state["air_temperature"].data.clone(),
                          out, self.stepper.model.state.clone()))
            return out

    loop._reservoir_incrementer = Recorded(inc)
    loop._reservoir_predictor = Recorded(pred)
    before = []
    for i in range(3):
        before.append(loop._derived()["air_temperature"].data.clone())
        t, diags = loop._step()
        T_after = loop._derived()["air_temperature"].data
        label, T_in, out, _ = calls[-1]
        assert label == "reservoir_predictor"
        if i:
            update = out[2]["air_temperature"].data
            assert rel_diff(T_after.numpy(), update.numpy()) <= 1e-13
        else:
            assert out == ({}, {}, {})
    assert [c[0] for c in calls] == [
        "reservoir_incrementer", "reservoir_predictor"] * 3
    direct = tres.SubdomainReservoirModel.load(str(tmp_path / "model"))
    for i in range(3):
        _, T_inc, _, r_inc = calls[2 * i]
        _, T_pred, out, _ = calls[2 * i + 1]
        np.testing.assert_array_equal(T_inc.numpy(), before[i].numpy())
        direct.increment(T_inc.movedim(1, -1))
        assert rel_diff(r_inc.numpy(), direct.state.numpy()) <= 1e-14
        if i:
            want = direct.predict_from_state(
                T_pred.movedim(1, -1)).movedim(-1, 1)
            got = out[2]["air_temperature"].data
            assert rel_diff(got.numpy(), want.numpy()) <= 1e-14


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' readings and the one-process reading of the subdomain
    corrector's step on a (2, 1) layout (``reservoir_worker``)."""
    from fv3net_torch.parallel import sharded

    out = tmp_path_factory.mktemp("reservoir_ranks")
    io.dump(_subdomain_model(8, 8), str(out / "model"))
    threads = max(1, torch.get_num_threads() // 2)
    return sharded.launch(reservoir_worker, 2, (str(out), threads))


def test_subdomain_corrector_two_ranks_against_one_process(two_ranks):
    """Each rank's block of the state after 2 steps with the subdomain
    corrector (its predictions on the second step) equals the block of
    the one-process run within 1e-12 of scale, or 1e-14 absolutely for
    the winds of the state at rest (~1e-5 m/s of roundoff-driven motion);
    both ranks hold the same whole-cube reservoir state."""
    results = two_ranks
    whole = results[0]["single"]
    for res in results:
        ys, xs = res["block"]
        for k, v in res["state"].items():
            want = whole[k][..., ys, xs]
            assert (rel_diff(v, want) <= 1e-12
                    or np.abs(v - want).max() <= 1e-14), k
        np.testing.assert_array_equal(res["reservoir_state"],
                                      results[0]["reservoir_state"])
    assert rel_diff(results[0]["reservoir_state"],
                    results[0]["single_reservoir_state"]) <= 1e-12


def _column_model(nz):
    """A port hybrid column model (T in, T out) trained on a seeded
    series of T columns near an isothermal 250 K, [nt, nz]."""
    rng = np.random.RandomState(1)
    series = 250.0 + 0.01 * rng.randn(12, nz)
    model = tres.train_hybrid_reservoir_model(
        tres.ReservoirHyperparameters(state_size=16, n_burn=2,
                                      l2_regularization=1.0),
        [_tds(series[:-1], series[1:], ("time", "f"))])
    model.input_variables = ["air_temperature"]
    model.output_variables = ["air_temperature"]
    return model


@pytest.fixture(scope="module")
def two_ranks_column(tmp_path_factory):
    """Both ranks' readings and the one-process reading of a column
    corrector warm-started on a (2, 1) layout
    (``column_reservoir_worker``)."""
    from fv3net_torch.parallel import sharded

    out = tmp_path_factory.mktemp("column_reservoir_ranks")
    model = _column_model(8)
    for name in ("column", "column_single"):
        io.dump(model, str(out / name))
    threads = max(1, torch.get_num_threads() // 2)
    return sharded.launch(column_reservoir_worker, 2, (str(out), threads))


def test_column_corrector_warm_start_two_ranks_against_one_process(
        two_ranks_column):
    """Under a (2, 1) layout ``save_reservoir_state`` writes the whole
    cube's column state in the one-process column order, and a warm start
    hands each rank its block of it: the saved file equals the
    one-process run's, each rank's reservoir state after the warm start
    is its block of the one-process state, and each rank's block of the
    state after the warm-started segment equals the one-process run's
    within 1e-12 of scale (1e-14 absolutely for the winds at rest)."""
    from fv3net_torch.fit.packer import stack_columns, unstack_columns

    results = two_ranks_column
    single = results[0]["single"]
    for res in results:
        assert rel_diff(res["saved"], single["saved"]) <= 1e-12
        ys, xs = res["block"]
        whole = unstack_columns(torch.tensor(single["warm_state"]),
                                (6, 8, 8))
        want = stack_columns(whole[..., ys, xs]).numpy()
        assert rel_diff(res["warm_state"], want) <= 1e-12
        for k, v in res["state"].items():
            want = single["state"][k][..., ys, xs]
            assert (rel_diff(v, want) <= 1e-12
                    or np.abs(v - want).max() <= 1e-14), k


def test_tendency_helpers_match_reference():
    """``tendencies_from_state_updates`` ((updated - initial) / dt for the
    variables with a tendency name) and ``state_updates_from_tendency``
    (the renamed results) against fv3net_tpu/runtime/tendency.py."""
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.runtime import tendency as jtendency

    from fv3net_torch.runtime import tendency

    before, dims = _column_state(seed=1)
    after, _ = _column_state(seed=2)
    after["cloud_water_mixing_ratio"] = after["specific_humidity"]
    before["cloud_water_mixing_ratio"] = before["specific_humidity"]

    def quantities(d, cls, array):
        return {k: cls(array(v), dims) for k, v in d.items()}

    want = jtendency.tendencies_from_state_updates(
        quantities(before, JQuantity, jnp.asarray),
        quantities(after, JQuantity, jnp.asarray), 900.0)
    got = tendency.tendencies_from_state_updates(
        quantities(before, Quantity, torch.tensor),
        quantities(after, Quantity, torch.tensor), 900.0)
    assert set(got) == set(want) == {"dQ1", "dQ2", "dQp"}
    for k in want:
        assert got[k].dims == want[k].dims
        assert rel_diff(got[k].data.numpy(), np.asarray(want[k].data)) \
            <= 1e-15, k
    renamed = tendency.state_updates_from_tendency(got)
    assert list(renamed) == list(jtendency.state_updates_from_tendency(
        want)) == [f"{k}_state_from_postphysics_tendency" for k in got]
    assert renamed["dQ1_state_from_postphysics_tendency"] is got["dQ1"]
