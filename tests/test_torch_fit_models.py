"""The port's models and trainers (``fit/{models,testing,networks,
precipitative,convolutional,train}.py``) held against ``fv3net_tpu.fit``
in float64 on the CPU: the precipitative and convolutional trainers on
the reference's initial weights (handed over by replacing the port's
``init_params`` / ``init_conv_params``), the network configs and the
generic training loop, every model type dumped by one package and
loaded by the other in both directions, the ensemble's median of two
members, ``fit.train.main`` from yaml in both packages, and
``run_segment`` with a tapered ensemble of two dense models against the
reference's."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from torch_port_util import rel_diff

from fv3net_torch.core import zarrio
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import config as tconfig
from fv3net_torch.fit import convolutional as tconv
from fv3net_torch.fit import io as tio
from fv3net_torch.fit import models as tmodels
from fv3net_torch.fit import networks as tnetworks
from fv3net_torch.fit import precipitative as tprecip
from fv3net_torch.fit import testing as ttesting
from fv3net_torch.fit import train as ttrain

jax.config.update("jax_enable_x64", True)

NZ = 6
# float64 training on the same data and initial weights: roundoff only,
# relative to each parameter's scale
TRAIN_RTOL = 1e-10
# a prediction of the same weights in another order of operations
PREDICT_RTOL = 1e-12
# float64 chunk of 2 steps (the production chunk tests' bound)
CHUNK_RTOL = 1e-8
DELP = "pressure_thickness_of_atmospheric_layer"
COLUMN_INPUTS = ("air_temperature", "specific_humidity", DELP,
                 "physics_precip", "pQ1")


def _columns(seed=0, n=96):
    rng = np.random.RandomState(seed)
    return {
        "air_temperature": 230 + 60 * rng.rand(n, NZ),
        "specific_humidity": 0.015 * rng.rand(n, NZ),
        DELP: 500 + 2500 * rng.rand(n, NZ),
        "physics_precip": 1e-3 * rng.rand(n),
        "pQ1": 1e-5 * rng.randn(n, NZ),
        "dQ1": 1e-4 * rng.randn(n, NZ),
        "dQ2": 1e-7 * rng.randn(n, NZ),
        "total_precipitation_rate": 1e-3 * rng.rand(n),
    }


def _dims(x):
    return ("sample", "z") if x.ndim == 2 else ("sample",)


def _batch_pair(cols):
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    jb = JDataset({k: JQuantity(jnp.asarray(v), _dims(v))
                   for k, v in cols.items()})
    tb = Dataset({k: Quantity(torch.tensor(v), _dims(v))
                  for k, v in cols.items()})
    return jb, tb


def _np(x):
    x = getattr(x, "data", x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_params_close(got, want, rtol):
    """Nested dicts/lists of tensors (port) and arrays (reference)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_params_close(got[k], want[k], rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_params_close(g, w, rtol)
    else:
        assert rel_diff(_np(got), np.asarray(want)) <= rtol


def _assert_predictions_close(got, want, rtol=PREDICT_RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].dims) == tuple(want[k].dims), k
        assert rel_diff(_np(got[k]), _np(want[k])) <= rtol, k


# --------------------------------------------------------- precipitative
def _reference_precip_init(hp, x_features, n_z):
    """The reference trainer's initial weights (precipitative.py:262-281:
    four keys split from the seed's)."""
    from fv3net_tpu.fit import dense as jdense

    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(hp["seed"]), 4)
    width = hp["width"]
    trunk = jdense.init_mlp_params(
        k1, [x_features] + [width] * hp["hidden_layers"])

    def head(k):
        return {"w": jax.random.normal(k, (width, n_z)) * jnp.sqrt(
            1.0 / width), "b": jnp.zeros(n_z)}

    return {"trunk": trunk, "head_T": head(k2), "head_q": head(k3),
            "head_precip": head(k4)}


def _hand_over_precip(monkeypatch, params):
    def draws(generator, trunk_sizes, n_T, n_q, dtype=torch.float32,
              device=None):
        def t(x):
            return torch.tensor(np.asarray(x), dtype=dtype, device=device)

        return {"trunk": [{k: t(v) for k, v in layer.items()}
                          for layer in params["trunk"]],
                **{h: {k: t(v) for k, v in params[h].items()}
                   for h in tprecip.HEADS}}

    monkeypatch.setattr(tprecip, "init_params", draws)


@pytest.mark.parametrize("case", ["coupled", "uncoupled", "limited"])
def test_precipitative_trainer_matches_reference(monkeypatch, case):
    """n = 96, batch 32, 2 epochs (the shuffle matters): parameters and
    predictions within TRAIN_RTOL of scale."""
    from fv3net_tpu.fit import precipitative as jprecip

    hp = dict(hidden_layers=2, width=12, epochs=2, batch_size=32, seed=3,
              additional_input_variables=["pQ1"],
              couple_precip_to_dQ1_dQ2=case != "uncoupled")
    if case == "limited":
        hp["output_limit_config"] = {"total_precipitation_rate":
                                     {"min": 0.0}}
    jb, tb = _batch_pair(_columns())
    want = jprecip.train_precipitative_model(
        jprecip.PrecipitativeHyperparameters(**hp), [jb])
    _hand_over_precip(monkeypatch, _reference_precip_init(
        hp, 4 * NZ + 1, NZ))
    got = tprecip.train_precipitative_model(
        tprecip.PrecipitativeHyperparameters(**hp), [tb])
    _assert_params_close(got.params, want.params, TRAIN_RTOL)
    jx, tx = _batch_pair(_columns(seed=1, n=20))
    _assert_predictions_close(got.predict(tx), want.predict(jx), TRAIN_RTOL)


# ---------------------------------------------------------- convolutional
CONV_N = 4


def _cube(seed, nt=2):
    rng = np.random.RandomState(seed)
    s3, s2 = (nt, 6, 3, CONV_N, CONV_N), (nt, 6, CONV_N, CONV_N)
    return {
        "air_temperature": (230 + 60 * rng.rand(*s3), s3),
        "specific_humidity": (0.015 * rng.rand(*s3), s3),
        "surface_temperature": (280 + 20 * rng.rand(*s2), s2),
        "dQ1": (1e-4 * rng.randn(*s3), s3),
        "total_precipitation_rate": (1e-3 * rng.rand(*s2), s2),
    }


def _cube_pair(seed, nt=2):
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    d3, d2 = ("time", "tile", "z", "y", "x"), ("time", "tile", "y", "x")
    cube = _cube(seed, nt)
    jb = JDataset({k: JQuantity(jnp.asarray(v), d3 if v.ndim == 5 else d2)
                   for k, (v, _) in cube.items()})
    tb = Dataset({k: Quantity(torch.tensor(v), d3 if v.ndim == 5 else d2)
                  for k, (v, _) in cube.items()})
    return jb, tb


CONV_HP = dict(input_variables=["air_temperature", "specific_humidity",
                                "surface_temperature"],
               output_variables=["dQ1", "total_precipitation_rate"],
               filters=5, depth=2, kernel_size=3, epochs=2, seed=2,
               learning_rate=1e-3)


def test_convolutional_trainer_matches_reference(monkeypatch):
    """Two batches of 2 times on a C4 cube, 2 layers of 3 x 3 (a halo of
    2), 2 epochs: the kernels and predictions within TRAIN_RTOL of
    scale."""
    from fv3net_tpu.fit import convolutional as jconv

    batches = [_cube_pair(s) for s in (0, 1)]
    want = jconv.train_convolutional_model(
        jconv.ConvolutionalHyperparameters(**CONV_HP),
        [b[0] for b in batches])
    init = jconv.init_conv_params(jax.random.PRNGKey(CONV_HP["seed"]),
                                  [7, 5, 4], 3)

    def draws(generator, channels, kernel_size, dtype=torch.float32,
              device=None):
        assert list(channels) == [7, 5, 4]
        return [{k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
                 for k, v in layer.items()} for layer in init]

    monkeypatch.setattr(tconv, "init_conv_params", draws)
    got = tconv.train_convolutional_model(
        tconv.ConvolutionalHyperparameters(**CONV_HP),
        [b[1] for b in batches])
    _assert_params_close(got.params, want.params, TRAIN_RTOL)
    assert got.halo == want.halo == 2
    jx, tx = _cube_pair(5, nt=1)
    _assert_predictions_close(got.predict(tx), want.predict(jx), TRAIN_RTOL)


# ---------------------------------------------------------------- networks
def test_network_configs_and_defaults_match_reference():
    """ConvolutionalNetworkConfig.apply and halos_required, LossConfig's
    four forms, and the hyperparameter dataclasses' defaults."""
    import dataclasses

    from fv3net_tpu.fit import convolutional as jconv
    from fv3net_tpu.fit import networks as jnetworks
    from fv3net_tpu.fit import precipitative as jprecip

    rng = np.random.RandomState(4)
    net_t = tnetworks.ConvolutionalNetworkConfig(filters=4, depth=3)
    net_j = jnetworks.ConvolutionalNetworkConfig(filters=4, depth=3)
    assert net_t.halos_required == net_j.halos_required == 2
    params = [{"w": rng.randn(3, 3, 2, 4), "b": rng.randn(4)},
              {"w": rng.randn(3, 3, 4, 4), "b": rng.randn(4)},
              {"w": rng.randn(1, 1, 4, 3), "b": rng.randn(3)}]
    x = rng.randn(2, 9, 8, 2)
    got = net_t.apply([{k: torch.tensor(v) for k, v in p.items()}
                       for p in params], torch.tensor(x))
    want = net_j.apply([{k: jnp.asarray(v) for k, v in p.items()}
                        for p in params], jnp.asarray(x))
    assert got.shape == want.shape == (2, 5, 4, 3)
    assert rel_diff(got.numpy(), np.asarray(want)) <= PREDICT_RTOL
    built = net_t.build(torch.Generator().manual_seed(0), 2, 3,
                        dtype=torch.float64)
    assert [tuple(p["w"].shape) for p in built.params] == [
        tuple(p["w"].shape) for p in params[:2]] + [(1, 1, 4, 3)]
    assert float(net_t.penalty(built.params)) == 0.0

    pred, target, std = rng.randn(5, 3), rng.randn(5, 3), rng.rand(3) + 0.5
    for loss_type in ("mse", "mae"):
        for scaling in ("standard", "standard_uniform"):
            kw = dict(loss_type=loss_type, scaling=scaling, weight=1.5)
            g = tnetworks.LossConfig(**kw).loss(torch.tensor(std))(
                torch.tensor(pred), torch.tensor(target))
            w = jnetworks.LossConfig(**kw).loss(jnp.asarray(std))(
                jnp.asarray(pred), jnp.asarray(target))
            assert float(g) == pytest.approx(float(w), rel=1e-14)
    with pytest.raises(ValueError):
        tnetworks.LossConfig(scaling="none").loss(torch.ones(2))
    for t, j in ((tconv.ConvolutionalHyperparameters,
                  jconv.ConvolutionalHyperparameters),
                 (tprecip.PrecipitativeHyperparameters,
                  jprecip.PrecipitativeHyperparameters),
                 (tnetworks.ConvolutionalNetworkConfig,
                  jnetworks.ConvolutionalNetworkConfig),
                 (tnetworks.LossConfig, jnetworks.LossConfig),
                 (tnetworks.TrainingLoopConfig,
                  jnetworks.TrainingLoopConfig)):
        assert dataclasses.asdict(t()) == dataclasses.asdict(j()), t
    assert tconv.halos_required(3, 5) == jconv.halos_required(3, 5)
    assert tprecip.PrecipitativeHyperparameters().input_variables == \
        jprecip.PrecipitativeHyperparameters().input_variables


def test_training_loop_matches_reference():
    """TrainingLoopConfig.fit_loop: 3 epochs of batches of 8 of a linear
    model, adam, with validation: the parameters, each batch's loss and
    each epoch's logs as the reference's."""
    from fv3net_tpu.fit import networks as jnetworks

    rng = np.random.RandomState(7)
    X, y = rng.randn(30, 4), rng.randn(30, 2)
    w0 = {"w": rng.randn(4, 2), "b": np.zeros(2)}
    xv, yv = rng.randn(6, 4), rng.randn(6, 2)

    def jloss(p, xb, yb):
        return jnp.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    def tloss(p, xb, yb):
        return torch.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    logs_t, logs_j = [], []
    want, res_j = jnetworks.TrainingLoopConfig(3, 8, 1).fit_loop(
        jloss, {k: jnp.asarray(v) for k, v in w0.items()}, jnp.asarray(X),
        jnp.asarray(y), optax.adam(1e-2), (xv, yv), [logs_j.append])
    got, res_t = tnetworks.TrainingLoopConfig(3, 8, 1).fit_loop(
        tloss, {k: torch.tensor(v) for k, v in w0.items()}, torch.tensor(X),
        torch.tensor(y), tconfig.OptimizerConfig(
            "adam", {"learning_rate": 1e-2}).instance,
        (xv, yv), [logs_t.append])
    _assert_params_close(got, want, TRAIN_RTOL)
    assert len(res_t) == len(res_j) == len(logs_t) == 3
    for a, b in zip(res_t, res_j):
        assert a.epoch == b.epoch and len(a.batch_logs) == 3
        for k in ("loss", "val_loss"):
            assert a.epoch_logs[k] == pytest.approx(b.epoch_logs[k],
                                                    rel=1e-10)


# -------------------------------------------------------------- artifacts
def _reference_models():
    """The reference's models of every type, built from seeded weights
    and scalers (no training, so nothing to compile): a name -> model
    dict."""
    from fv3net_tpu.fit import convolutional as jconv
    from fv3net_tpu.fit import dense as jdense
    from fv3net_tpu.fit import models as jmodels
    from fv3net_tpu.fit import precipitative as jprecip
    from fv3net_tpu.fit import testing as jtesting
    from fv3net_tpu.fit.config import OutputLimitConfig
    from fv3net_tpu.fit.normalize import StandardScaler as JScaler
    from fv3net_tpu.fit.packer import PackingInfo as JInfo

    rng = np.random.RandomState(12)

    def layers(sizes):
        return [{"w": jnp.asarray(rng.randn(a, b) / np.sqrt(a)),
                 "b": jnp.asarray(0.1 * rng.randn(b))}
                for a, b in zip(sizes[:-1], sizes[1:])]

    def scaler(mean, std):
        return JScaler(jnp.asarray(mean), jnp.asarray(std))

    x_scaler = scaler(np.r_[np.full(NZ, 260.0), np.full(NZ, 0.007)],
                      np.r_[np.full(NZ, 17.0), np.full(NZ, 0.004)])

    def dense(outputs):
        n_out = NZ * len(outputs)
        return jdense.DenseModel(
            ["air_temperature", "specific_humidity"], outputs,
            layers([2 * NZ, 8, n_out]),
            JInfo(["air_temperature", "specific_humidity"], [NZ, NZ]),
            JInfo(list(outputs), [NZ] * len(outputs)), x_scaler,
            scaler(1e-6 * rng.randn(n_out), 1e-5 * (1 + rng.rand(n_out))),
            OutputLimitConfig.from_dict({"dQ2": {"max": 2e-5}}))

    d1, d2 = dense(["dQ1", "dQ2"]), dense(["dQ1", "dQ2"])
    n_x = 3 * NZ + 1
    precip = jprecip.PrecipitativeModel(
        list(jprecip.PrecipitativeHyperparameters().input_variables),
        {"trunk": layers([n_x, 8, 8]),
         **{h: layers([8, NZ])[0] for h in tprecip.HEADS}},
        JInfo(["air_temperature", "specific_humidity", DELP,
               "physics_precip"], [NZ, NZ, NZ, 1]),
        scaler(rng.rand(n_x) * 100, 1 + rng.rand(n_x) * 100),
        {"dQ1": scaler(np.zeros(NZ), np.full(NZ, 1e-4)),
         "dQ2": scaler(np.zeros(NZ), np.full(NZ, 1e-7)),
         "total_precipitation_rate": scaler(np.zeros(1), np.ones(1))},
        couple=True)
    conv = jconv.ConvolutionalModel(
        CONV_HP["input_variables"], CONV_HP["output_variables"],
        [{"w": jnp.asarray(0.3 * rng.randn(3, 3, a, b)),
          "b": jnp.asarray(0.1 * rng.randn(b))}
         for a, b in ((7, 5), (5, 4))],
        JInfo(CONV_HP["input_variables"], [3, 3, 1]),
        JInfo(CONV_HP["output_variables"], [3, 1]),
        scaler(rng.rand(7) * 100, 1 + rng.rand(7) * 10),
        scaler(np.zeros(4), np.r_[np.full(3, 1e-4), 1e-3]), 3,
        output_z_names=["dQ1"])
    taper = {"dQ1": {"cutoff": 3, "rate": 2.0},
             "dQ2": {"cutoff": 2, "rate": 1.0}}
    return {
        "dense": d1,
        "precipitative": precip,
        "convolutional": conv,
        "constant-output": jtesting.ConstantOutputPredictor(
            ["air_temperature"], ["dQ1", "dQ2"],
            {"dQ1": np.arange(NZ) * 1e-5}),
        "combined_output_model": jmodels.CombinedOutputModel(
            [dense(["dQ1"]), dense(["dQ2"])]),
        "ensemble_mean": jmodels.EnsembleModel([d1, d2], "mean"),
        "ensemble_median": jmodels.EnsembleModel([d1, d2, d1], "median"),
        "tapered_model": jmodels.TaperedModel(
            jmodels.EnsembleModel([d1, d2], "median"), taper),
        "derived_model": jmodels.DerivedModel(
            d1, ["Q1", "column_integrated_dQ1"]),
        "output_transformed_model": jmodels.TransformedPredictor(
            d1, [{"name": "Q1_from_dQ1_pQ1"},
                 {"name": "tapered_dQ2", "kwargs": {"cutoff": 2}}]),
        "squashed_output_model": jmodels.SquashedOutputModel(
            d1, "dQ2", 0.0, ["dQ1"]),
    }


def _inputs_of(name):
    if name == "convolutional":
        return _cube_pair(6, nt=1)
    cols = _columns(seed=8, n=25)
    return _batch_pair({k: cols[k] for k in COLUMN_INPUTS})


@pytest.fixture(scope="module")
def reference_models():
    return _reference_models()


@pytest.mark.parametrize("name", [
    "dense", "precipitative", "convolutional", "constant-output",
    "combined_output_model", "ensemble_mean", "ensemble_median",
    "tapered_model", "derived_model", "output_transformed_model",
    "squashed_output_model"])
def test_artifacts_both_ways(reference_models, tmp_path, name):
    """The reference's model dumped and loaded in the port, then dumped by
    the port and loaded in the reference: all three predict the same
    (float64, PREDICT_RTOL of scale), and the ``name`` file names the
    type in every artifact."""
    from fv3net_tpu import fit as jfit

    jmodel = reference_models[name]
    jx, tx = _inputs_of(name)
    want = jmodel.predict(jx)
    jfit.dump(jmodel, str(tmp_path / "ref"))
    mine = tio.load(str(tmp_path / "ref"))
    assert sorted(mine.input_variables) == sorted(jmodel.input_variables)
    _assert_predictions_close(mine.predict(tx), want)
    tio.dump(mine, str(tmp_path / "port"))
    assert (tmp_path / "port" / "name").read_text() == \
        (tmp_path / "ref" / "name").read_text()
    back = jfit.load(str(tmp_path / "port"))
    _assert_predictions_close(back.predict(jx), want)
    moved = mine.to(dtype=torch.float64)
    _assert_predictions_close(moved.predict(tx), want)


def test_ensemble_median_of_two_averages_the_middle():
    """The median of 2 members is their midpoint, as jnp.median's (where
    torch.median would return the lower one); of 3 the middle one."""
    from fv3net_tpu.fit.models import EnsembleModel as JEnsemble

    rng = np.random.RandomState(9)
    for n in (2, 3, 4):
        outs = [rng.randn(7, NZ) for _ in range(n)]
        got = tmodels.median(torch.tensor(np.stack(outs)))
        want = jnp.median(jnp.asarray(np.stack(outs)), axis=0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if n == 2:
            np.testing.assert_array_equal(got.numpy(),
                                          (outs[0] + outs[1]) * 0.5)
            assert not torch.equal(
                got, torch.median(torch.tensor(np.stack(outs)), 0).values)
    # through the models: constant members of 2 and of their midpoint
    a, b = np.linspace(0, 1, NZ), np.linspace(2, 5, NZ)
    tm = tmodels.EnsembleModel([
        ttesting.ConstantOutputPredictor(["x"], ["y"], {"y": a}),
        ttesting.ConstantOutputPredictor(["x"], ["y"], {"y": b})], "median")
    from fv3net_tpu.fit.testing import ConstantOutputPredictor as JConst

    jm = JEnsemble([JConst(["x"], ["y"], {"y": a}),
                    JConst(["x"], ["y"], {"y": b})], "median")
    jx, tx = _batch_pair({"x": np.zeros(3)})
    _assert_predictions_close(tm.predict(tx), jm.predict(jx), 0.0)
    np.testing.assert_array_equal(_np(tm.predict(tx)["y"])[0], (a + b) * 0.5)


# -------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def nudged_stores(tmp_path_factory):
    """A nudged run's two stores at C4, 6 levels, 3 times (the state and
    its nudging tendencies, with T and q also in the second), and the
    data configs over them."""
    d = tmp_path_factory.mktemp("nudged")
    rng = np.random.RandomState(11)
    s3, s2 = (3, 6, NZ, CONV_N, CONV_N), (3, 6, CONV_N, CONV_N)
    d5, d4 = ("time", "tile", "z", "y", "x"), ("time", "tile", "y", "x")
    T, q = 230 + 60 * rng.rand(*s3), 0.015 * rng.rand(*s3)
    state = {"air_temperature": T, "specific_humidity": q,
             DELP: 500 + 2500 * rng.rand(*s3),
             "physics_precip": 1e-3 * rng.rand(*s2),
             "total_precipitation_rate": 1e-3 * rng.rand(*s2)}
    nudge = {"air_temperature_tendency_due_to_nudging": 1e-4 *
             rng.randn(*s3),
             "specific_humidity_tendency_due_to_nudging": 1e-7 *
             rng.randn(*s3),
             "air_temperature": T, "specific_humidity": q}
    for name, fields in (("state.zarr", state), ("nudge.zarr", nudge)):
        zarrio.to_zarr(Dataset({k: Quantity(v, d5 if v.ndim == 5 else d4)
                                for k, v in fields.items()}), str(d / name))
    mapper = {"mapper_config": {"function": "open_nudge_to_fine", "kwargs": {
        "state_zarr": str(d / "state.zarr"),
        "nudging_zarr": str(d / "nudge.zarr")}},
        "variable_names": ["air_temperature", "specific_humidity", "dQ1",
                           "dQ2", DELP, "physics_precip",
                           "total_precipitation_rate"],
        "subsample_ratio": 0.5, "shuffle_seed": 0}
    (d / "data.yaml").write_text(yaml.safe_dump(mapper))
    (d / "cube.yaml").write_text(yaml.safe_dump({
        "data_path": str(d / "nudge.zarr"),
        "unstacked_dims": ["tile", "z", "y", "x"], "window_size": 1,
        "batch_size": 1, "n_windows": 2}))
    return d


TRAINING = {
    "dense": {"model_type": "dense", "random_seed": 2, "hyperparameters": {
        "input_variables": ["air_temperature", "specific_humidity"],
        "output_variables": ["dQ1", "dQ2"], "hidden_layers": 1, "width": 8,
        "epochs": 1, "batch_size": 32}},
    "precipitative": {"model_type": "precipitative", "hyperparameters": {
        "hidden_layers": 1, "width": 8, "epochs": 1, "batch_size": 32}},
}


@pytest.mark.parametrize("model_type", list(TRAINING))
def test_train_main_from_yaml_both_packages(nudged_stores, tmp_path,
                                            model_type, capsys):
    """fit.train.main of each package on the same training and data
    yaml (a BatchesFromMapperConfig over open_nudge_to_fine): each loads
    the other's artifact and predicts what the other does."""
    from fv3net_tpu import fit as jfit
    from fv3net_tpu.fit import train as jtrain

    cfg = tmp_path / "training.yaml"
    cfg.write_text(yaml.safe_dump(TRAINING[model_type]))
    data = str(nudged_stores / "data.yaml")
    assert ttrain.main([str(cfg), data, str(tmp_path / "port"),
                        "--device", "cpu"]) == 0
    assert jtrain.main([str(cfg), data, str(tmp_path / "ref")]) == 0
    assert capsys.readouterr().out.count('"step": "train"') == 2
    jx, tx = _batch_pair({k: v for k, v in _columns(seed=4, n=30).items()
                          if k in COLUMN_INPUTS})
    for mine, theirs in ((tio.load(str(tmp_path / "port")),
                          jfit.load(str(tmp_path / "port"))),
                         (tio.load(str(tmp_path / "ref")),
                          jfit.load(str(tmp_path / "ref")))):
        _assert_predictions_close(mine.predict(tx), theirs.predict(jx))
    with open(tmp_path / "port" / "train.yaml") as f:
        assert yaml.safe_load(f)["model_type"] == model_type


def test_train_main_convolutional_on_the_cube(nudged_stores, tmp_path):
    """The port's CLI trains the convolutional model on whole-cube windows
    of one store (WindowedZarrLoader: [sample, window, tile, z, y, x]);
    the reference loads the artifact and predicts the same.  Without a
    card the default device raises."""
    from fv3net_tpu import fit as jfit

    cfg = tmp_path / "training.yaml"
    cfg.write_text(yaml.safe_dump({
        "model_type": "convolutional", "hyperparameters": {
            "input_variables": ["air_temperature", "specific_humidity"],
            "output_variables": ["air_temperature_tendency_due_to_nudging"],
            "filters": 4, "epochs": 1}}))
    data = str(nudged_stores / "cube.yaml")
    assert ttrain.main([str(cfg), data, str(tmp_path / "port"),
                        "--device", "cpu"]) == 0
    mine = tio.load(str(tmp_path / "port"))
    theirs = jfit.load(str(tmp_path / "port"))
    store = zarrio.open_zarr(str(nudged_stores / "nudge.zarr"))
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    names = ["air_temperature", "specific_humidity"]
    tx = Dataset({k: Quantity(torch.tensor(store[k].values), store[k].dims)
                  for k in names})
    jx = JDataset({k: JQuantity(jnp.asarray(store[k].values), store[k].dims)
                   for k in names})
    _assert_predictions_close(mine.predict(tx), theirs.predict(jx))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ttrain.main([str(cfg), data, str(tmp_path / "x")])


# ------------------------------------------------------------ online run
ONLINE_NPX, ONLINE_NPZ = 4, 8


@pytest.fixture(scope="module")
def wrapped_model(tmp_path_factory):
    """Two quiet dense models (the production entry's recipe, seeds 0 and
    1, their last layers scaled by 1e-4 so that the humidity limiter
    does not act) in an ensemble under a taper, dumped."""
    from fv3net_torch import entry

    members = []
    for seed in (0, 1):
        m = entry.train_entry_model(ONLINE_NPZ, torch.float64, "cpu", seed,
                                    hidden=(16,), n=64,
                                    dq_scale=(1e-6, 1e-9))
        with torch.no_grad():
            m.layers[-1].weight.mul_(1e-4)
            m.layers[-1].bias.mul_(1e-4)
        members.append(m)
    model = tmodels.TaperedModel(
        tmodels.EnsembleModel(members, "median"),
        {"dQ1": {"cutoff": 3, "rate": 2.0}, "dQ2": {"cutoff": 3,
                                                    "rate": 2.0}})
    path = str(tmp_path_factory.mktemp("wrapped") / "model")
    tio.dump(model, path)
    return path, members


def test_run_segment_with_tapered_ensemble_matches_reference(
        wrapped_model, tmp_path):
    """One fused chunk of 2 steps (gray, C4) with the wrapped model
    through ``scikit_learn.model`` in each package's run_segment (the
    reference's loop in float64): the end states within CHUNK_RTOL; the
    loops are fused; the wrapped model's prediction on the loop's first
    state is the taper of the members' midpoint."""
    from fv3net_tpu.runtime.config import get_config as jget_config
    from fv3net_tpu.runtime.loop import TimeLoop as JTimeLoop
    from fv3net_tpu.runtime.segmented_run import api as japi

    from fv3net_torch.data_transform import vertical_tapering_scale_factors
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.segmented_run import api
    from fv3net_torch.runtime.steppers.machine_learning import predict

    path, members = wrapped_model
    cfg = {"namelist": {"npx": ONLINE_NPX, "npz": ONLINE_NPZ},
           "duration_seconds": 1800.0, "fused_chunk_steps": 2,
           "scikit_learn": {"model": [path]},
           "diagnostics": [{"name": "diags.zarr",
                            "variables": ["air_temperature",
                                          "specific_humidity"],
                            "times": {"kind": "every"}}]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "TimeLoop",
                   functools.partial(JTimeLoop, dtype=jnp.float64))
        jl = japi.run_segment(jget_config(cfg), str(tmp_path / "jax"))
    tl = api.run_segment(get_config(cfg), str(tmp_path / "torch"),
                         device="cpu", dtype=torch.float64)
    assert jl.fusable() and tl.fusable()
    assert jl.time == tl.time
    from torch_port_util import assert_states_close

    assert_states_close(tl.state.dycore, jl.state.dycore, CHUNK_RTOL)
    mine = zarrio.open_zarr(str(tmp_path / "torch" / "diags.zarr"))
    theirs = zarrio.open_zarr(str(tmp_path / "jax" / "diags.zarr"))
    for k in ("air_temperature", "specific_humidity"):
        assert rel_diff(mine[k].values, theirs[k].values) <= CHUNK_RTOL, k

    loop = TimeLoop(get_config(cfg), dtype=torch.float64, device="cpu")
    wrapped = loop._postphysics_stepper.model.models[0]
    assert isinstance(wrapped, tmodels.TaperedModel)
    got = predict(wrapped, loop._derived())
    ds = predict(members[0], loop._derived())
    other = predict(members[1], loop._derived())
    for k in ("dQ1", "dQ2"):
        scale = torch.tensor(vertical_tapering_scale_factors(ONLINE_NPZ, 3,
                                                             2.0))
        want = (ds[k].data + other[k].data) * 0.5 * scale
        np.testing.assert_array_equal(got[k].data.numpy(), want.numpy())
