"""The rest of the ML library in ``fv3net_torch`` (``fit/transformed.py``,
``fit/novelty.py``, ``fit/jacobian.py``, ``fit/input_sensitivity.py``,
``fit/graph.py``, ``fit/recurrent.py``, ``fit/tracking.py``,
``fit/sweep.py`` and the registries) against ``fv3net_tpu`` on the same
numpy inputs, on the CPU.

Tolerances: float64 apply paths within 1e-12 of scale and Jacobians
within 1e-13 (summation order only); one float64 trained epoch within
1e-10 of scale (a few Adam steps of those differences).  The reference's
trainers run on the reference's initial weights, handed to the port by
monkeypatching its init function.  The graph trainer takes 2 samples
for one epoch: the reference's graph test is the tier-1 run's tail.
"""
import importlib
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import handover, rel_diff

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import graph as tgraph
from fv3net_torch.fit import io
from fv3net_torch.fit import novelty as tnov
from fv3net_torch.fit import recurrent as trec
from fv3net_torch.fit import transformed as ttf

jax.config.update("jax_enable_x64", True)

F64_RTOL = 1e-12
TRAIN_RTOL = 1e-10
JACOBIAN_RTOL = 1e-13
N = 96  # samples
NZ = 6  # levels



def _leaves_close(got, want, rtol):
    """Each tensor of ``got`` (a port pytree) within ``rtol`` of scale of
    the same leaf of ``want`` (the reference's)."""
    jl = jax.tree_util.tree_leaves(want)
    from fv3net_torch.fit.networks import tree_leaves

    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert t.shape == j.shape
        assert rel_diff(t.numpy(), np.asarray(j)) <= rtol


def _both(data, dims):
    """(reference Dataset, port Dataset) of the same numpy arrays."""
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    return (JDataset({k: JQuantity(jnp.asarray(v), dims[k])
                      for k, v in data.items()}),
            Dataset({k: Quantity(torch.tensor(v), dims[k])
                     for k, v in data.items()}))


# ---------------------------------------------------------------------------
# the transformed emulator
# ---------------------------------------------------------------------------
def _microphysics_columns(n=N, seed=2):
    rng = np.random.RandomState(seed)
    qv = 10 ** rng.uniform(-6, -2, (n, NZ))
    T = 250 + 40 * rng.rand(n, NZ)
    qc = 1e-5 * rng.rand(n, NZ)
    p = np.linspace(2e4, 1e5, NZ) * (1 + 0.01 * rng.rand(n, NZ))
    qv_out = qv * np.exp(-0.3 + 0.01 * (T - 270))
    T_out = T + 1e3 * (qv - qv_out)
    return dict(specific_humidity=qv, air_temperature=T,
                cloud_water_mixing_ratio=qc, pressure=p,
                specific_humidity_after=qv_out, air_temperature_after=T_out)


# the emulator's transforms: log humidity and temperature, the network
# predicting their log increments, q limited at 0.  The hook reads the
# outputs under the state's own names, and the trainer packs inputs and
# targets from one dict, so the log of each state field "to" its
# "_after" tensor is the slot through which the network's output comes
# back under that name: in training the "_after" field's log overwrites
# it, at prediction the increment's backward does.
EMULATOR_TRANSFORMS = [
    {"kind": "limit", "field": "specific_humidity", "lower": 0.0},
] + [spec for f in ("specific_humidity", "air_temperature") for spec in (
    {"kind": "log", "field": f, "to": f"log_{f}_after"},
    {"kind": "log", "field": f"{f}_after", "to": f"log_{f}_after"},
    {"kind": "log", "field": f, "to": f"log_{f}_input"},
    {"kind": "difference", "to": f"dlog_{f}", "before": f"log_{f}_input",
     "after": f"log_{f}_after"})]


def _emulator_hp(arch, epochs=2):
    return dict(
        input_variables=["log_specific_humidity_input",
                         "log_air_temperature_input",
                         "cloud_water_mixing_ratio", "pressure"],
        output_variables=["dlog_specific_humidity", "dlog_air_temperature"],
        data_variables=["specific_humidity", "specific_humidity_after",
                        "air_temperature", "air_temperature_after",
                        "cloud_water_mixing_ratio", "pressure"],
        predicted_variables=["air_temperature", "specific_humidity"],
        tensor_transforms=EMULATOR_TRANSFORMS, architecture=arch, width=8,
        hidden_layers=2, epochs=epochs, batch_size=32, seed=4)


@pytest.fixture(scope="module")
def transformed_pairs():
    """arch -> (reference, port) trained 2 float64 epochs from the same
    initial weights."""
    from fv3net_tpu.fit import packer as jpacker
    from fv3net_tpu.fit import transformed as jtf

    data = _microphysics_columns()
    dims = {k: ("sample", "z") for k in data}
    jds, tds = _both(data, dims)
    out = {}
    for arch in ("dense", "linear", "rnn"):
        kw = _emulator_hp(arch)
        jm = jtf.train_transformed_model(jtf.TransformedParameters(**kw),
                                         [jds])
        jhp = jtf.TransformedParameters(**kw)
        info_in = jpacker.PackingInfo(kw["input_variables"], [NZ] * 4)
        info_out = jpacker.PackingInfo(kw["output_variables"], [NZ] * 2)
        init = jtf._init_params(jhp, jax.random.PRNGKey(jhp.seed), info_in,
                                info_out)
        mp = pytest.MonkeyPatch()
        mp.setattr(ttf, "_init_params", handover([init]))
        try:
            tm = ttf.train_transformed_model(
                ttf.TransformedParameters(**kw), [tds])
        finally:
            mp.undo()
        out[arch] = (jm, tm)
    return out, data


@pytest.mark.parametrize("arch", ["dense", "linear", "rnn"])
def test_transformed_trained_epochs_match_reference(arch,
                                                    transformed_pairs):
    pairs, data = transformed_pairs
    jm, tm = pairs[arch]
    _leaves_close(tm.params, jm.params, TRAIN_RTOL)
    assert tm.input_variables == jm.input_variables == [
        "air_temperature", "cloud_water_mixing_ratio", "pressure",
        "specific_humidity"]
    state = {k: data[k][:20] for k in tm.input_variables}
    want = jm.predict_arrays({k: jnp.asarray(v) for k, v in state.items()})
    got = tm.predict_arrays({k: torch.tensor(v) for k, v in state.items()})
    for k in ("air_temperature", "specific_humidity"):
        assert rel_diff(got[k].numpy(), np.asarray(want[k])) <= TRAIN_RTOL
    assert (got["specific_humidity"].numpy() >= 0).all()


@pytest.mark.parametrize("arch", ["dense", "linear", "rnn"])
def test_transformed_apply_and_artifacts_both_ways(arch, transformed_pairs,
                                                   tmp_path):
    """The reference's model carried over predicts as it does (1e-12);
    each package loads the other's artifact (leaves in JAX's flatten
    order)."""
    from fv3net_tpu.fit import io as jio

    pairs, data = transformed_pairs
    jm, tm = pairs[arch]
    carried = ttf.transformed_from_jax(jm)
    state = {k: data[k][30:50] for k in tm.input_variables}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.tensor(v) for k, v in state.items()}
    want = jm.predict_arrays(jstate)
    for model in (carried,):
        got = model.predict_arrays(tstate)
        for k in want:
            assert rel_diff(got[k].numpy(), np.asarray(want[k])) <= F64_RTOL
    jio.dump(jm, str(tmp_path / "j"))
    io.dump(tm, str(tmp_path / "t"))
    t_from_j = io.load(str(tmp_path / "j"))
    j_from_t = jio.load(str(tmp_path / "t"))
    for k, v in t_from_j.predict_arrays(tstate).items():
        assert rel_diff(v.numpy(), np.asarray(want[k])) <= F64_RTOL
    mine = tm.predict_arrays(tstate)
    for k, v in j_from_t.predict_arrays(jstate).items():
        assert rel_diff(np.asarray(v), mine[k].numpy()) <= F64_RTOL


def test_rnn_emulator_in_the_microphysics_emulator(transformed_pairs):
    """The rnn model through both packages' MicrophysicsEmulator on a
    [2, 3, 4, nz] state: the outputs land under the state's names."""
    from fv3net_torch.emulation import MicrophysicsEmulator
    from fv3net_tpu.emulation import MicrophysicsEmulator as JEmulator

    pairs, data = transformed_pairs
    jm, tm = pairs["rnn"]
    state = {k: data[k][:24].reshape(2, 3, 4, NZ)
             for k in tm.input_variables}
    want = JEmulator(jm)({k: jnp.asarray(v) for k, v in state.items()})
    got = MicrophysicsEmulator(tm)(
        {k: torch.tensor(v) for k, v in state.items()})
    assert sorted(got) == sorted(state)
    for k in ("air_temperature", "specific_humidity"):
        assert got[k].shape == (2, 3, 4, NZ)
        assert rel_diff(got[k].numpy(), np.asarray(want[k])) <= TRAIN_RTOL
        assert not np.array_equal(got[k].numpy(), state[k])
    np.testing.assert_array_equal(got["pressure"].numpy(), state["pressure"])


def test_rnn_cell_is_the_reference_gru_without_hidden_bias():
    """``_rnn_apply`` on seeded weights against the reference's scan
    (1e-12), and not ``torch.nn.GRU``'s cell with a zero hidden bias
    unless the input bias is zero too."""
    from fv3net_tpu.fit import transformed as jtf

    rng = np.random.RandomState(0)
    p = {"wx": rng.randn(3, 12), "wh": rng.randn(4, 12), "b": rng.randn(12),
         "wo": rng.randn(4, 2), "bo": rng.randn(2)}
    x = rng.randn(5, NZ, 3)
    want = np.asarray(jtf._rnn_apply({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x)))
    got = ttf._rnn_apply({k: torch.tensor(v) for k, v in p.items()},
                         torch.tensor(x))
    assert got.shape == (5, NZ, 2)
    assert rel_diff(got.numpy(), want) <= F64_RTOL


# ---------------------------------------------------------------------------
# novelty and out-of-sample tapering
# ---------------------------------------------------------------------------
def test_taper_functions_match_reference():
    from fv3net_tpu.fit import novelty as jnov

    score = np.linspace(-2.0, 3.0, 41)
    for name, cfg in (("taper_mask", {"cutoff": 0.5}),
                      ("taper_ramp", {"ramp_min": -1.0, "ramp_max": 2.0}),
                      ("taper_decay", {"threshold": 0.2, "rate": 0.7})):
        want = np.asarray(jnov.get_taper_function(name, cfg)(
            jnp.asarray(score)))
        got = tnov.get_taper_function(name, cfg)(torch.tensor(score))
        assert rel_diff(got.numpy(), want) <= F64_RTOL, name


_DENSE_PAIRS = {}


def _dense_pair(seed=0):
    """(reference DenseModel trained 1 float64 epoch, the port's carried
    over) on T and q columns -> dQ1 and dQ2, trained once a seed."""
    if seed not in _DENSE_PAIRS:
        _DENSE_PAIRS[seed] = _train_dense_pair(seed)
    return _DENSE_PAIRS[seed]


def _train_dense_pair(seed):
    from fv3net_torch.fit.dense import params_from_jax
    from fv3net_tpu.fit.dense import DenseHyperparameters, train_dense_model

    rng = np.random.RandomState(seed)
    data = {"air_temperature": 250 + 30 * rng.rand(N, NZ),
            "specific_humidity": 1e-3 * rng.rand(N, NZ),
            "surface_pressure": 1e5 + 100 * rng.rand(N)}
    data["dQ1"] = 1e-4 * rng.randn(N, NZ)
    data["dQ2"] = 1e-7 * rng.randn(N, NZ)
    dims = {k: ("sample",) if v.ndim == 1 else ("sample", "z")
            for k, v in data.items()}
    jds, tds = _both(data, dims)
    jm = train_dense_model(DenseHyperparameters(
        input_variables=["air_temperature", "specific_humidity",
                         "surface_pressure"],
        output_variables=["dQ1", "dQ2"], hidden_layers=2, width=16,
        epochs=1, batch_size=32), [jds])
    return jm, params_from_jax(jm), data, jds, tds


def test_minmax_detector_and_out_of_sample_model(tmp_path):
    """The minmax trainer on 2 batches, its scores, and an out_of_sample
    model (a dense base, the detector, taper_ramp) against the reference;
    both artifacts read both ways."""
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit import novelty as jnov

    jdense, tdense, data, jds, tds = _dense_pair()
    names = ["air_temperature", "specific_humidity"]
    half = N // 2
    dims = {k: ("sample",) if v.ndim == 1 else ("sample", "z")
            for k, v in data.items()}
    parts = [_both({k: v[s] for k, v in data.items()}, dims)
             for s in (slice(0, half), slice(half, None))]
    jdet = jnov.train_min_max_novelty_detector(
        jnov.MinMaxNoveltyDetectorHyperparameters(names),
        [p[0] for p in parts])
    tdet = tnov.train_min_max_novelty_detector(
        tnov.MinMaxNoveltyDetectorHyperparameters(names),
        [p[1] for p in parts])
    np.testing.assert_array_equal(tdet.minima.numpy(),
                                  np.asarray(jdet.minima))
    # held-out columns, some outside the training range
    rng = np.random.RandomState(7)
    held = {k: v[:40] * (1 + 0.02 * rng.randn(*v[:40].shape))
            for k, v in data.items()}
    jh, th = _both(held, dims)
    want_s = np.asarray(jdet.predict(jh)["centered_score"].data)
    got_s = tdet.predict(th)["centered_score"].data.numpy()
    assert rel_diff(got_s, want_s) <= F64_RTOL
    assert (got_s > 0).any() and (got_s <= 0).any()

    taper = {"name": "taper_ramp", "ramp_min": 0.0, "ramp_max": 0.5}
    jo = jnov.OutOfSampleModel(jdense, jdet, cutoff=0.0, taper_config=taper)
    to = tnov.OutOfSampleModel(tdense, tnov.minmax_from_jax(jdet),
                               cutoff=0.0, taper_config=taper)
    assert to.input_variables == jo.input_variables
    assert to.output_variables == jo.output_variables
    want = jo.predict(jh)
    got = to.predict(th)
    for k in want:
        assert rel_diff(got[k].data.numpy(), np.asarray(want[k].data)) \
            <= F64_RTOL, k
    jio.dump(jo, str(tmp_path / "j"))
    io.dump(to, str(tmp_path / "t"))
    for k, v in io.load(str(tmp_path / "j")).predict(th).items():
        assert rel_diff(v.data.numpy(), np.asarray(want[k].data)) <= F64_RTOL
    for k, v in jio.load(str(tmp_path / "t")).predict(jh).items():
        assert rel_diff(np.asarray(v.data), got[k].data.numpy()) <= F64_RTOL


def test_constant_output_novelty_and_ocsvm_raise(tmp_path):
    """The constant-output detector under the taper both ways, and the
    reference's one-class SVM inside its out_of_sample model read and
    scored by the port (the name is the one this test had when the SVM
    raised)."""
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit import novelty as jnov

    jdense, tdense, data, jds, tds = _dense_pair()
    jo = jnov.OutOfSampleModel(
        jdense, jnov.ConstantOutputNoveltyDetector(["air_temperature"], 1.5),
        cutoff=1.0)
    io.dump(tnov.OutOfSampleModel(
        tdense, tnov.ConstantOutputNoveltyDetector(["air_temperature"], 1.5),
        cutoff=1.0), str(tmp_path / "t"))
    back = io.load(str(tmp_path / "t"))
    got = back.predict(tds)
    want = jo.predict(jds)
    assert float(got["taper_values"].data.max()) == 0.0
    for k in want:
        np.testing.assert_array_equal(got[k].data.numpy(),
                                      np.asarray(want[k].data))
    assert isinstance(jio.load(str(tmp_path / "t")).novelty_detector,
                      jnov.ConstantOutputNoveltyDetector)
    # the one-class SVM under the taper: the reference's scikit-learn
    # detector, dumped inside its out_of_sample model, read by the port
    jsvm = jnov.OCSVMNoveltyDetector(["air_temperature"])
    jsvm.fit(jds)
    jio.dump(jnov.OutOfSampleModel(jdense, jsvm, cutoff=0.0),
             str(tmp_path / "svm"))
    back = io.load(str(tmp_path / "svm"))
    assert isinstance(back.novelty_detector, tnov.OCSVMNoveltyDetector)
    got = back.predict(tds)
    want = jnov.OutOfSampleModel(jdense, jsvm, cutoff=0.0).predict(jds)
    score = np.asarray(want["centered_score"].data)
    np.testing.assert_allclose(got["centered_score"].data.numpy(), score,
                               rtol=0, atol=1e-12 * np.abs(score).max())
    np.testing.assert_array_equal(got["taper_values"].data.numpy(),
                                  np.asarray(want["taper_values"].data))


# ---------------------------------------------------------------------------
# Jacobians and input sensitivity
# ---------------------------------------------------------------------------
def test_jacobians_and_input_sensitivity_match_reference():
    """Exact Jacobians at the training mean (1e-13 of scale), their
    nondimensional form, and both branches of ``input_sensitivity``."""
    from fv3net_torch.fit.input_sensitivity import input_sensitivity
    from fv3net_torch.fit.jacobian import (
        compute_jacobians,
        nondimensionalize_jacobians,
    )
    from fv3net_tpu.fit import jacobian as jjac

    # the reference's package binds input_sensitivity to the function
    jis = importlib.import_module("fv3net_tpu.fit.input_sensitivity")

    jm, tm, data, _, _ = _dense_pair(seed=1)
    base = {k: data[k].mean(axis=0) for k in jm.input_variables}
    want = jax.jit(lambda b: jjac.compute_jacobians(jm, b))(
        {k: jnp.asarray(v) for k, v in base.items()})
    got = compute_jacobians(tm, {k: torch.tensor(v) for k, v in base.items()})
    assert sorted(got) == ["dQ1", "dQ2"]
    for o in want:
        for i in want[o]:
            assert got[o][i].shape == want[o][i].shape
            assert rel_diff(got[o][i].numpy(), np.asarray(want[o][i])) \
                <= JACOBIAN_RTOL
    std = {k: v.std(axis=0) for k, v in data.items()}
    nd_want = jjac.nondimensionalize_jacobians(
        want, {k: jnp.asarray(v) for k, v in std.items()})
    nd_got = nondimensionalize_jacobians(
        got, {k: torch.tensor(v) for k, v in std.items()})
    assert rel_diff(nd_got["dQ2"]["specific_humidity"].numpy(),
                    np.asarray(nd_want["dQ2"]["specific_humidity"])) \
        <= JACOBIAN_RTOL
    sens = input_sensitivity(tm, {k: torch.tensor(v)
                                  for k, v in base.items()})
    assert sens.rf_feature_importances is None
    assert rel_diff(sens.jacobians["dQ1"]["air_temperature"],
                    np.asarray(want["dQ1"]["air_temperature"])) \
        <= JACOBIAN_RTOL

    class Forest:
        def feature_importances(self):
            return {"a": (np.array([0.2, 0.3]), np.array([0.1, 0.0])),
                    "b": (0.5, 0.05)}

    got_rf = input_sensitivity(Forest(), None).rf_feature_importances
    want_rf = jis.input_sensitivity(Forest(), None).rf_feature_importances
    assert {k: vars(v) for k, v in got_rf.items()} == {
        k: vars(v) for k, v in want_rf.items()}


# ---------------------------------------------------------------------------
# the graph network
# ---------------------------------------------------------------------------
def _cube_samples(nt=2, n=6, seed=0):
    rng = np.random.RandomState(seed)
    T = 250 + 10 * rng.randn(nt, 6, 3, n, n)
    ps = 1e5 + 200 * rng.randn(nt, 6, n, n)
    dT = 1e-4 * rng.randn(nt, 6, 3, n, n)
    data = {"air_temperature": T, "surface_pressure": ps, "dQ1": dT}
    dims = {"air_temperature": ("time", "tile", "z", "y", "x"),
            "surface_pressure": ("time", "tile", "y", "x"),
            "dQ1": ("time", "tile", "z", "y", "x")}
    return _both(data, dims)


def test_neighbor_mean_and_gnn_apply_match_reference():
    from fv3net_tpu.fit import graph as jgraph

    rng = np.random.RandomState(3)
    x = rng.randn(6, 5, 5, 4)
    want = np.asarray(jax.jit(jgraph._neighbor_mean)(jnp.asarray(x)))
    got = tgraph._neighbor_mean(torch.tensor(x))
    assert rel_diff(got.numpy(), want) <= F64_RTOL
    batched = tgraph._neighbor_mean(torch.tensor(np.stack([x, 2 * x])))
    assert rel_diff(batched[1].numpy(), 2 * want) <= F64_RTOL
    params = jgraph._init_gnn(jax.random.PRNGKey(0), 4, 8, 2, 3)
    want = np.asarray(jax.jit(jgraph.gnn_apply)(params, jnp.asarray(x)))
    got = tgraph.gnn_apply(handover([params])(), torch.tensor(x))
    assert rel_diff(got.numpy(), want) <= F64_RTOL


def test_graph_trainer_and_artifacts_match_reference(tmp_path):
    """One float64 epoch over 2 cube samples (C6) from the reference's
    initial weights; predictions and artifacts both ways."""
    from fv3net_tpu.fit import graph as jgraph
    from fv3net_tpu.fit import io as jio

    jds, tds = _cube_samples()
    kw = dict(input_variables=["air_temperature", "surface_pressure"],
              output_variables=["dQ1"], hidden_width=8, n_message_passing=2,
              epochs=1, seed=0)
    jm = jgraph.train_graph_network(jgraph.GraphHyperparameters(**kw), [jds])
    init = jgraph._init_gnn(jax.random.PRNGKey(0), 4, 8, 2, 3)
    mp = pytest.MonkeyPatch()
    mp.setattr(tgraph, "_init_gnn", handover([init]))
    try:
        tm = tgraph.train_graph_network(tgraph.GraphHyperparameters(**kw),
                                        [tds])
    finally:
        mp.undo()
    _leaves_close(tm.params, jm.params, TRAIN_RTOL)
    want = np.asarray(jm.predict(jds)["dQ1"].data)
    got = tm.predict(tds)["dQ1"]
    assert got.dims == ("time", "tile", "z", "y", "x")
    assert rel_diff(got.data.numpy(), want) <= TRAIN_RTOL
    carried = tgraph.graph_from_jax(jm)
    assert rel_diff(carried.predict(tds)["dQ1"].data.numpy(), want) \
        <= F64_RTOL
    jio.dump(jm, str(tmp_path / "j"))
    io.dump(tm, str(tmp_path / "t"))
    assert rel_diff(io.load(str(tmp_path / "j")).predict(tds)["dQ1"]
                    .data.numpy(), want) <= F64_RTOL
    assert rel_diff(np.asarray(jio.load(str(tmp_path / "t")).predict(jds)[
        "dQ1"].data), got.data.numpy()) <= F64_RTOL


# ---------------------------------------------------------------------------
# the autoregressive (fmr) model
# ---------------------------------------------------------------------------
def _series(nt=8, ns=20, seed=0):
    rng = np.random.RandomState(seed)
    T = 260 + np.cumsum(rng.randn(nt, ns, 3), axis=0)
    q = 1e-3 * (1 + 0.1 * np.cumsum(rng.randn(nt, ns), axis=0))
    return _both({"air_temperature": T, "specific_humidity": q},
                 {"air_temperature": ("time", "sample", "z"),
                  "specific_humidity": ("time", "sample")})


def test_fmr_trainer_rollout_and_artifacts_match_reference(tmp_path):
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit import recurrent as jrec
    from fv3net_tpu.fit.dense import init_mlp_params

    jds, tds = _series()
    kw = dict(state_variables=["air_temperature", "specific_humidity"],
              hidden_layers=1, width=8, train_window=3, epochs=2, seed=1)
    jm = jrec.train_autoregressive_model(
        jrec.RecurrentHyperparameters(**kw), [jds])
    init = init_mlp_params(jax.random.PRNGKey(1), [4, 8, 4])
    mp = pytest.MonkeyPatch()
    mp.setattr(trec, "init_mlp_params", handover([init]))
    try:
        tm = trec.train_autoregressive_model(
            trec.RecurrentHyperparameters(**kw), [tds])
    finally:
        mp.undo()
    _leaves_close(tm.params, jm.params, TRAIN_RTOL)
    carried = trec.autoregressive_from_jax(jm)
    s0 = np.concatenate([np.asarray(jds["air_temperature"].data[0]),
                         np.asarray(jds["specific_humidity"].data[0])[:, None]],
                        axis=1)
    want = np.asarray(jm.rollout(jnp.asarray(s0), 5))
    got = carried.rollout(torch.tensor(s0), 5)
    assert got.shape == (5, 20, 4)
    assert rel_diff(got.numpy(), want) <= F64_RTOL
    one = {"air_temperature": np.asarray(jds["air_temperature"].data[2]),
           "specific_humidity": np.asarray(jds["specific_humidity"].data[2])}
    jone, tone = _both(one, {"air_temperature": ("sample", "z"),
                             "specific_humidity": ("sample",)})
    want1 = jm.predict(jone)
    jio.dump(jm, str(tmp_path / "j"))
    io.dump(tm, str(tmp_path / "t"))
    got1 = io.load(str(tmp_path / "j")).predict(tone)
    for k in want1:
        assert rel_diff(got1[k].data.numpy(), np.asarray(want1[k].data)) \
            <= F64_RTOL
    back = jio.load(str(tmp_path / "t")).predict(jone)
    mine = tm.predict(tone)
    for k in back:
        assert rel_diff(np.asarray(back[k].data), mine[k].data.numpy()) \
            <= F64_RTOL


def test_fmr_reads_windowed_records_with_the_window_as_time():
    """A windowed loader's record [sample, window, z] trains as the same
    series given [time, sample, z]."""
    _, tds = _series(nt=5, ns=4)
    windowed = Dataset({k: Quantity(q.data.transpose(0, 1),
                                    ("sample", "window") + q.dims[2:])
                        for k, q in tds.items()})
    kw = dict(state_variables=["air_temperature", "specific_humidity"],
              hidden_layers=1, width=8, train_window=2, epochs=1, seed=1)
    a = trec.train_autoregressive_model(trec.RecurrentHyperparameters(**kw),
                                        [tds])
    b = trec.train_autoregressive_model(trec.RecurrentHyperparameters(**kw),
                                        [windowed])
    for la, lb in zip(a.params, b.params):
        np.testing.assert_array_equal(la["w"].numpy(), lb["w"].numpy())


# ---------------------------------------------------------------------------
# tracking, sweeps and the registries
# ---------------------------------------------------------------------------
def test_tracking_copy_equals_its_original(tmp_path, capsys):
    from fv3net_torch.fit import tracking as ttrack
    from fv3net_tpu.fit import tracking as jtrack

    def body(module):
        src = inspect.getsource(module)
        return src[src.index("from __future__"):].replace("fv3net_tpu",
                                                          "fv3net_torch")

    assert body(ttrack) == body(jtrack)
    run = ttrack.init(project="p", name="r", config={"a": 1},
                      dir=str(tmp_path))
    ttrack.log({"loss": 0.5})
    ttrack.finish()
    assert ttrack.read_history(run.dir)[0]["loss"] == 0.5
    assert ttrack.main(["--dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.split()[:3] == ["p", "r", "1"]


def test_sweep_runs_trials_and_tracks_them(tmp_path, capsys):
    """``expand_sweep`` as the reference's; a 2-trial grid of the dense
    trainer through ``run_sweep``, each trial an artifact and a tracking
    run that ``tracking-query-torch`` lists."""
    from fv3net_torch.fit import sweep as tsweep
    from fv3net_torch.fit import tracking as ttrack
    from fv3net_tpu.fit import sweep as jsweep

    for cfg in ({"method": "grid", "parameters": {
                    "a.b": {"values": [1, 2]}, "c": {"values": [3, 4, 5]}}},
                {"method": "random", "count": 4, "parameters": {
                    "lr": {"min": 1e-4, "max": 1e-2,
                           "distribution": "log_uniform"},
                    "w": {"values": [8, 16]}}}):
        assert tsweep.expand_sweep(cfg, seed=3) == jsweep.expand_sweep(
            cfg, seed=3)
    _, _, _, _, tds = _dense_pair()
    base = {"model_type": "dense", "hyperparameters": {
        "input_variables": ["air_temperature"],
        "output_variables": ["dQ1"], "hidden_layers": 1, "width": 4,
        "epochs": 1}}
    results = tsweep.run_sweep(base, {"method": "grid", "parameters": {
        "hyperparameters.width": {"values": [4, 8]}}}, [tds],
        str(tmp_path / "sweep"))
    assert [r.ok for r in results] == [True, True]
    for r in results:
        assert os.path.exists(os.path.join(r.value, "name"))
    widths = [json.load(open(os.path.join(r.value, "metadata.json")))[
        "n_layers"] for r in results]
    assert widths == [2, 2]
    runs = list(ttrack.query_runs(str(tmp_path / "sweep" / "tracking")))
    assert [r["name"] for r in runs] == ["trial_000", "trial_001"]
    assert runs[1]["config"]["assignment"] == {"hyperparameters.width": 8}
    # the CLI over a trainer that takes state variables: the loader is
    # asked for them (a WindowedZarrLoader of the fmr's series)
    import yaml

    from fv3net_torch.core import zarrio

    rng = np.random.RandomState(5)
    T = 260 + np.cumsum(rng.randn(6, 10, 3), axis=0)
    q = 1e-3 * (1 + 0.1 * np.cumsum(rng.randn(6, 10), axis=0))
    zarrio.to_zarr(Dataset({
        "air_temperature": Quantity(T, ("time", "sample", "z")),
        "specific_humidity": Quantity(q, ("time", "sample"))}),
        str(tmp_path / "series.zarr"))
    (tmp_path / "data.yaml").write_text(yaml.safe_dump({
        "data_path": str(tmp_path / "series.zarr"), "unstacked_dims": ["z"],
        "window_size": 3, "batch_size": 4, "n_windows": 2}))
    (tmp_path / "sweep.yaml").write_text(yaml.safe_dump({
        "base": {"model_type": "fmr", "hyperparameters": {
            "state_variables": ["air_temperature", "specific_humidity"],
            "hidden_layers": 1, "width": 4, "train_window": 2,
            "epochs": 1}},
        "method": "grid",
        "parameters": {"hyperparameters.width": {"values": [4, 8]}}}))
    capsys.readouterr()
    out = tmp_path / "cli"
    assert tsweep.main([str(tmp_path / "sweep.yaml"),
                        str(tmp_path / "data.yaml"), str(out),
                        "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "trials": [str(out / "trial_000"), str(out / "trial_001")],
        "failed": 0}
    assert [m.params[0]["w"].shape[1] for m in (
        io.load(str(out / f"trial_00{i}")) for i in (0, 1))] == [4, 8]
    assert [r["name"] for r in ttrack.query_runs(str(out / "tracking"))] \
        == ["trial_000", "trial_001"]


def test_registries_raise_only_for_the_scikit_learn_models(tmp_path):
    """The registries equal the reference's: every model type and
    trainer of the reference is registered in the port (the scikit-learn
    ones too), and an unknown model type raises the reference's
    ValueError (the name is the one this test had when the scikit-learn
    models raised)."""
    import fv3net_tpu.fit  # noqa: F401  (registers everything)
    from fv3net_torch.fit import train as ttrain
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit import train as jtrain

    assert ttrain.training_function_names() == jtrain.training_function_names()
    (tmp_path / "name").write_text("not_a_model")
    with pytest.raises(ValueError, match="unknown model type"):
        io.load(str(tmp_path))  # the port's model types register
    with pytest.raises(ValueError, match="unknown model type"):
        jio.load(str(tmp_path))
    assert set(jio.register._model_types) == set(io.register._model_types)
    for name in ("ocsvm_novelty_detector", "sklearn_random_forest"):
        assert (ttrain.get_hyperparameter_class(name).__name__
                == jtrain.get_hyperparameter_class(name).__name__)
    assert ttrain.config_variables({"hyperparameters": {
        "input_variables": ["a"], "state_variables": ["b", "c"]}}) == [
            "a", "b", "c"]
