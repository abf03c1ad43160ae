"""The port's dense trainer (``fit/{config,networks,train,dense}.py``) held
against ``fv3net_tpu.fit``, float64: ``train_dense_model`` on the
reference's initial weights (handed over by replacing the port's
``init_mlp_params``) for each optimizer, loss and penalty configuration;
the optax update rules and schedules one by one (ten float64 updates of
each rule added later: rmsprop centered and bias-corrected, adagrad,
adamax, nadam, radam, amsgrad, adabelief, yogi); the output limits
through ``dump``/``load`` both ways; ``train_main``'s artifact read by
the reference; and the entries' trained models."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_util  # noqa: F401  (torch threads under xdist)

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import config as tconfig
from fv3net_torch.fit import dense as tdense
from fv3net_torch.fit import io as tio
from fv3net_torch.fit import networks as tnetworks
from fv3net_torch.fit import train as ttrain

jax.config.update("jax_enable_x64", True)

NPZ, N = 8, 96
NAMES_IN = ["air_temperature", "specific_humidity"]
NAMES_OUT = ["dQ1", "dQ2"]
# float64 training of 9 steps on the same data and initial weights:
# roundoff only, relative to each parameter's scale
RTOL = 1e-10


def _columns(seed=0, n=N):
    rng = np.random.RandomState(seed)
    return {
        "air_temperature": 260 + 30 * rng.rand(n, NPZ),
        "specific_humidity": 0.01 * rng.rand(n, NPZ),
        "dQ1": 1e-5 * rng.randn(n, NPZ),
        "dQ2": 1e-8 * rng.randn(n, NPZ),
    }


def _batches(cols):
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    jb = JDataset({k: JQuantity(jnp.asarray(v), ("sample", "z"))
                   for k, v in cols.items()})
    tb = Dataset({k: Quantity(torch.tensor(v), ("sample", "z"))
                  for k, v in cols.items()})
    return jb, tb


def _hand_over(monkeypatch, jax_params):
    """The port's trainer starts from the reference's initial weights."""
    def draws(generator, sizes, dtype=torch.float32, device=None):
        return [{k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
                 for k, v in layer.items()} for layer in jax_params]

    monkeypatch.setattr(tdense, "init_mlp_params", draws)


def _sizes(hp):
    width, depth = hp.get("width", 16), hp.get("hidden_layers", 2) + 1
    if "dense_network" in hp:
        width, depth = hp["dense_network"]["width"], \
            hp["dense_network"]["depth"]
    return [2 * NPZ] + [width] * (depth - 1) + [2 * NPZ]


CASES = {
    "adam": {},
    "mae": {"loss": {"loss_type": "mae", "weight": 2.0}},
    "l2": {"l2_regularization": 1e-3},
    "l1_l2": {"dense_network": {
        "width": 12, "depth": 3, "kernel_regularizer": {
            "name": "l1_l2", "kwargs": {"l1": 1e-4, "l2": 1e-3}}}},
    "exponential_decay": {"optimizer_config": {
        "name": "adam", "learning_rate_schedule": {
            "name": "exponential_decay", "kwargs": {
                "init_value": 3e-3, "transition_steps": 2,
                "decay_rate": 0.5}}}},
    "adamw": {"optimizer_config": {"name": "adamw",
                                   "kwargs": {"learning_rate": 2e-3}}},
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_dense_model_matches_reference(monkeypatch, case):
    """n = 96, batch 32, 3 epochs (the shuffle matters): parameters and
    predictions within 1e-10 of scale."""
    from fv3net_tpu.fit import dense as jdense

    hp = dict(input_variables=NAMES_IN, output_variables=NAMES_OUT,
              hidden_layers=2, width=16, epochs=3, batch_size=32, seed=4,
              **CASES[case])
    jb, tb = _batches(_columns())
    want = jdense.train_dense_model(jdense.DenseHyperparameters(**hp), [jb])
    _hand_over(monkeypatch, jdense.init_mlp_params(
        jax.random.PRNGKey(hp["seed"]), _sizes(hp)))
    got = tdense.train_dense_model(tdense.DenseHyperparameters(**hp), [tb])
    assert len(got.layers) == len(want.params)
    for layer, ref in zip(got.layers, want.params):
        for mine, theirs in ((layer.weight.detach().numpy().T, ref["w"]),
                             (layer.bias.detach().numpy(), ref["b"])):
            theirs = np.asarray(theirs)
            err = np.abs(mine - theirs).max() / np.abs(theirs).max()
            assert err <= RTOL, (case, err)
    x = _columns(seed=1, n=20)
    p_want = want.predict_arrays({k: jnp.asarray(x[k]) for k in NAMES_IN})
    p_got = got.predict_arrays({k: torch.tensor(x[k]) for k in NAMES_IN})
    for k in NAMES_OUT:
        ref = np.asarray(p_want[k])
        err = np.abs(p_got[k].numpy() - ref).max() / np.abs(ref).max()
        assert err <= RTOL, (case, k, err)


def test_minibatches_are_the_reference_shuffle():
    """The indices: one RandomState(seed) permutation per epoch, whole
    batches only (n = 100, batch 32: 3 steps an epoch, 4 samples left)."""
    idx = tdense.minibatch_indices(100, 32, 2, seed=5)
    rng = np.random.RandomState(5)
    want = np.concatenate([rng.permutation(100)[:96].reshape(3, 32)
                           for _ in range(2)])
    np.testing.assert_array_equal(idx, want)
    assert tdense.minibatch_indices(10, 512, 1, 0).shape == (1, 10)


@pytest.mark.parametrize("name,kwargs", [
    ("adam", {"learning_rate": 1e-2}),
    ("adamw", {"learning_rate": 1e-2}),
    ("sgd", {"learning_rate": 1e-2, "momentum": 0.9}),
    ("sgd", {"learning_rate": 1e-2, "momentum": 0.9, "nesterov": True}),
    ("rmsprop", {"learning_rate": 1e-2}),
    ("rmsprop", {"learning_rate": 1e-2, "momentum": 0.5}),
    ("lion", {"learning_rate": 1e-2}),
])
def test_update_rules_match_optax(name, kwargs):
    """Five updates of each optax optimizer the port writes, with optax's
    defaults (adamw decays by 1e-4, lion by 1e-3, rmsprop's decay is 0.9
    with eps inside the square root), on the same gradients."""
    rng = np.random.RandomState(2)
    p0 = [rng.randn(4, 3), rng.randn(3)]
    grads = [[rng.randn(4, 3), rng.randn(3)] for _ in range(5)]
    tx = getattr(optax, name)(**kwargs)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    port = tconfig.OptimizerConfig(name.upper() if name == "sgd" else name,
                                   kwargs).instance
    tp = [torch.tensor(p) for p in p0]
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        port.step(tp, [torch.tensor(x) for x in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=1e-15)


@pytest.mark.parametrize("name,kwargs", [
    ("rmsprop", {"learning_rate": 1e-2, "centered": True}),
    ("rmsprop", {"learning_rate": 1e-2, "centered": True,
                 "bias_correction": True, "momentum": 0.5,
                 "nesterov": True}),
    ("rmsprop", {"learning_rate": 1e-2, "bias_correction": True,
                 "eps_in_sqrt": False}),
    ("adagrad", {"learning_rate": 1e-2}),
    ("adamax", {"learning_rate": 1e-2}),
    ("nadam", {"learning_rate": 1e-2}),
    ("radam", {"learning_rate": 1e-2}),
    ("amsgrad", {"learning_rate": 1e-2}),
    ("adabelief", {"learning_rate": 1e-2}),
    ("yogi", {"learning_rate": 1e-2}),
])
def test_more_update_rules_match_optax(name, kwargs):
    """Ten updates of each further optax rule the port writes, float64,
    on the same gradients, with optax's defaults; within 1e-13 of each
    tensor's scale (radam's b2**t is the one power optax takes in its
    own precision: 3e-15 apart)."""
    rng = np.random.RandomState(2)
    p0 = [rng.randn(4, 3), rng.randn(3)]
    grads = [[rng.randn(4, 3), rng.randn(3)] for _ in range(10)]
    tx = getattr(optax, name)(**kwargs)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    port = tconfig.OptimizerConfig(name, kwargs).instance
    tp = [torch.tensor(p) for p in p0]
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        port.step(tp, [torch.tensor(x) for x in g])
    for a, b in zip(tp, jp):
        b = np.asarray(b)
        assert b.dtype == np.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-13 * np.abs(b).max())


@pytest.mark.parametrize("name,kwargs", [
    ("constant_schedule", {"value": 3e-3}),
    ("exponential_decay", {"init_value": 3e-3, "transition_steps": 2,
                           "decay_rate": 0.5}),
    ("exponential_decay", {"init_value": 1e-2, "transition_steps": 3,
                           "decay_rate": 0.7, "transition_begin": 2,
                           "staircase": True, "end_value": 4e-3}),
    ("cosine_decay_schedule", {"init_value": 3e-3, "decay_steps": 5,
                               "alpha": 0.1}),
    ("piecewise_constant_schedule", {
        "init_value": 3e-3, "boundaries_and_scales": {3: 0.5, 6: 0.1}}),
    ("linear_schedule", {"init_value": 1e-3, "end_value": 1e-2,
                         "transition_steps": 6, "transition_begin": 2}),
    ("polynomial_schedule", {"init_value": 1e-2, "end_value": 1e-4,
                             "power": 2.0, "transition_steps": 7}),
    ("warmup_cosine_decay_schedule", {
        "init_value": 0.0, "peak_value": 1e-2, "warmup_steps": 3,
        "decay_steps": 8, "end_value": 1e-4}),
    ("warmup_exponential_decay_schedule", {
        "init_value": 1e-4, "peak_value": 1e-2, "warmup_steps": 3,
        "transition_steps": 2, "decay_rate": 0.5, "end_value": 2e-3}),
    ("cosine_onecycle_schedule", {"transition_steps": 8,
                                  "peak_value": 1e-2}),
])
def test_schedules_match_optax(name, kwargs):
    """The port's schedules give optax's rate at every update count (its
    exponential decay and its polynomial and warm-up schedules compute in
    float32, as optax's int32 count makes them)."""
    want = getattr(optax, name)(**kwargs)
    got = tconfig.LearningRateScheduleConfig(name, kwargs).instance
    for count in range(10):
        ref = float(want(jnp.asarray(count, jnp.int32)))
        assert got(count) == pytest.approx(ref, rel=1e-15, abs=0), count


def test_unported_names_raise():
    """The names the port wrote last build (``lamb``, ``sgdr_schedule``);
    a name optax lacks raises the reference's ValueError with its
    message in both packages; the trainer registry has every trainer of
    the reference, the random forest among them."""
    from fv3net_tpu.fit import config as jconfig
    from fv3net_tpu.fit import train as jtrain

    tconfig.OptimizerConfig("lamb", {"learning_rate": 1e-3}).instance
    cosine = {"init_value": 0.0, "peak_value": 1e-2, "warmup_steps": 2,
              "decay_steps": 5}
    assert tconfig.LearningRateScheduleConfig(
        "sgdr_schedule", {"cosine_kwargs": [cosine] * 2}).instance(3) > 0
    for cls, name in (("OptimizerConfig", "Lambda"),
                      ("LearningRateScheduleConfig", "sgdr")):
        messages = []
        for config in (tconfig, jconfig):
            with pytest.raises(ValueError) as err:
                getattr(config, cls)(name=name).instance
            messages.append(str(err.value))
        assert messages[0] == messages[1], messages
    assert (ttrain.get_training_function("sklearn_random_forest").__name__
            == jtrain.get_training_function("sklearn_random_forest").__name__)


def test_config_copies_match_reference():
    """RegularizerConfig.penalty (weights only), OutputLimit(Config),
    DenseNetworkConfig.apply and the train registry's helpers against the
    reference's."""
    from fv3net_tpu.fit import config as jconfig
    from fv3net_tpu.fit import networks as jnetworks
    from fv3net_tpu.fit import train as jtrain
    from fv3net_tpu.fit.packer import PackingInfo as JInfo

    from fv3net_torch.fit.packer import PackingInfo

    rng = np.random.RandomState(3)
    layers = [{"w": rng.randn(5, 4), "b": rng.randn(4)},
              {"w": rng.randn(4, 2), "b": rng.randn(2)}]
    jl = [{k: jnp.asarray(v) for k, v in x.items()} for x in layers]
    tl = [{k: torch.tensor(v) for k, v in x.items()} for x in layers]
    for name, kw in [("none", {}), ("l1", {}), ("l2", {"l2": 0.3}),
                     ("l1_l2", {"l1": 0.2})]:
        want = float(jconfig.RegularizerConfig(name, kw).penalty(jl))
        got = float(tconfig.RegularizerConfig(name, kw).penalty(tl))
        assert got == pytest.approx(want, rel=1e-14, abs=0), name
    x = rng.randn(7, 5)
    net_j = jnetworks.DenseNetworkConfig(width=4, depth=2)
    net_t = tnetworks.DenseNetworkConfig(width=4, depth=2)
    np.testing.assert_allclose(
        net_t.apply(tl, torch.tensor(x)).numpy(),
        np.asarray(net_j.apply(jl, jnp.asarray(x))), rtol=1e-14)
    built = net_t.build(torch.Generator().manual_seed(0), 5, 2,
                        dtype=torch.float64)
    assert [tuple(p["w"].shape) for p in built.params] == [(5, 4), (4, 2)]
    noisy = tnetworks.DenseNetworkConfig(width=4, depth=2,
                                         gaussian_noise=0.1)
    a = noisy.apply(tl, torch.tensor(x), torch.Generator().manual_seed(1))
    b = noisy.apply(tl, torch.tensor(x), torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(
        a, net_t.apply(tl, torch.tensor(x)))

    limits = {"dQ1": {"min": -1.0, "max": 0.5}, "dQ2": {"min": 0.0}}
    Y = 2 * rng.randn(6, 5)
    want = jconfig.OutputLimitConfig.from_dict(limits).limit_packed(
        jnp.asarray(Y), JInfo(NAMES_OUT, [3, 2]))
    got = tconfig.OutputLimitConfig.from_dict(limits).limit_packed(
        torch.tensor(Y), PackingInfo(NAMES_OUT, [3, 2]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tconfig.OutputLimit(min=1.0, max=0.0)

    d = {"model_type": "dense", "random_seed": 3,
         "hyperparameters": {"input_variables": NAMES_IN,
                             "output_variables": NAMES_OUT, "width": 4}}
    over = ["hyperparameters.epochs=2", "hyperparameters.loss.weight=0.5"]
    assert ttrain.apply_config_overrides(dict(d), over) == \
        jtrain.apply_config_overrides(dict(d), over)
    assert ttrain.TrainingConfig.from_dict(d).to_dict() == \
        jtrain.TrainingConfig.from_dict(d).to_dict()
    ttrain.set_random_seed(9)
    a = np.random.rand()
    jtrain.set_random_seed(9)
    assert np.random.rand() == a


def test_output_limits_through_dump_and_load_both_ways(tmp_path):
    """A model trained with output limits clamps its predictions; its
    artifact loads in the reference with the same predictions, and the
    reference's loads in the port."""
    from fv3net_tpu import fit as jfit

    hp = dict(input_variables=NAMES_IN, output_variables=NAMES_OUT,
              hidden_layers=1, width=8, epochs=1, batch_size=32,
              output_limit_config={"dQ1": {"min": 0.0},
                                   "dQ2": {"max": 1e-9}})
    _, tb = _batches(_columns())
    model = tdense.train_dense_model(tdense.DenseHyperparameters(**hp), [tb])
    x = _columns(seed=2, n=30)
    got = model.predict_arrays({k: torch.tensor(x[k]) for k in NAMES_IN})
    assert float(got["dQ1"].min()) == 0.0
    assert float(got["dQ2"].max()) <= 1e-9
    tio.dump(model, str(tmp_path / "port"))
    ref = jfit.load(str(tmp_path / "port"))
    want = ref.predict_arrays({k: jnp.asarray(x[k]) for k in NAMES_IN})
    jfit.dump(ref, str(tmp_path / "ref"))
    back = tio.load(str(tmp_path / "ref"))
    again = back.predict_arrays({k: torch.tensor(x[k]) for k in NAMES_IN})
    for k in NAMES_OUT:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12, atol=0)
        np.testing.assert_array_equal(again[k].numpy(), got[k].numpy())
    carried = tdense.params_from_jax(ref)
    assert carried.output_limits.to_dict() == model.output_limits.to_dict()


def test_train_main_writes_an_artifact_the_reference_reads(tmp_path,
                                                            capsys):
    """train_main: the dense model and its train.yaml; the reference's
    fit.io.load reads the model and predicts what the port predicts."""
    import yaml

    from fv3net_tpu import fit as jfit

    cfg = {"model_type": "dense", "random_seed": 1,
           "hyperparameters": {"input_variables": NAMES_IN,
                               "output_variables": NAMES_OUT,
                               "hidden_layers": 1, "width": 8, "epochs": 2,
                               "batch_size": 48}}
    _, tb = _batches(_columns())
    out = str(tmp_path / "model")
    model = ttrain.train_main(cfg, [tb], None, out)
    assert '"model_type": "dense"' in capsys.readouterr().out
    with open(tmp_path / "model" / "train.yaml") as f:
        assert yaml.safe_load(f)["hyperparameters"]["epochs"] == 2
    ref = jfit.load(out)
    x = _columns(seed=3, n=10)
    want = ref.predict_arrays({k: jnp.asarray(x[k]) for k in NAMES_IN})
    got = model.predict_arrays({k: torch.tensor(x[k]) for k in NAMES_IN})
    for k in NAMES_OUT:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12, atol=0)
    # the CLI trains the same config from a data config (the legacy
    # {kind, path, variables} dict over a zarr store of the same columns
    # as one time of a [tile, z, y, x] cube), and its model predicts
    # what the reference loads from its artifact
    from fv3net_torch.core import zarrio

    cols = _columns()
    zarrio.to_zarr(Dataset({k: Quantity(
        v.reshape(1, 6, 4, 4, NPZ).transpose(0, 1, 4, 2, 3),
        ("time", "tile", "z", "y", "x")) for k, v in cols.items()}),
        str(tmp_path / "columns.zarr"))
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({
        "kind": "zarr", "path": str(tmp_path / "columns.zarr"),
        "variables": NAMES_IN + NAMES_OUT}))
    assert ttrain.main([str(tmp_path / "model" / "train.yaml"), str(data),
                        str(tmp_path / "cli"), "--device", "cpu"]) == 0
    cli = tio.load(str(tmp_path / "cli"))
    want = jfit.load(str(tmp_path / "cli")).predict_arrays(
        {k: jnp.asarray(x[k]) for k in NAMES_IN})
    got = cli.predict_arrays({k: torch.tensor(x[k]) for k in NAMES_IN})
    for k in NAMES_OUT:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12, atol=0)


def test_entries_train_their_models(monkeypatch):
    """train_entry_model builds the reference entries' batch (RandomState
    of the seed: 256 samples for the flagship's 2 x 128, 64 for
    production's 1 x 16) and trains one epoch: on the reference's
    initial weights, the reference's trained model."""
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.fit import dense as jdense

    from fv3net_torch import entry

    npz = 4
    for hidden, n, scale in [((128, 128), 256, (1e-5, 1e-8)),
                             ((16,), 64, (1e-6, 1e-9))]:
        rng = np.random.RandomState(0)
        cols = {"air_temperature": 260 + 30 * rng.rand(n, npz),
                "specific_humidity": 0.01 * rng.rand(n, npz),
                "dQ1": scale[0] * rng.randn(n, npz),
                "dQ2": scale[1] * rng.randn(n, npz)}
        want = jdense.train_dense_model(jdense.DenseHyperparameters(
            input_variables=NAMES_IN, output_variables=NAMES_OUT,
            hidden_layers=len(hidden), width=hidden[0], epochs=1),
            [JDataset({k: JQuantity(jnp.asarray(v), ("sample", "z"))
                       for k, v in cols.items()})])
        _hand_over(monkeypatch, jdense.init_mlp_params(
            jax.random.PRNGKey(0), [2 * npz, *hidden, 2 * npz]))
        got = entry.train_entry_model(npz, torch.float64, "cpu", 0,
                                      hidden=hidden, n=n, dq_scale=scale)
        for layer, ref in zip(got.layers, want.params):
            w = np.asarray(ref["w"])
            err = np.abs(layer.weight.detach().numpy().T - w).max()
            assert err <= RTOL * np.abs(w).max(), (hidden, err)
