"""The latent space of the subdomain reservoir in ``fv3net_torch``
(``fit/transformers.py``, ``fit/autoencoder.py``, ``transformer_path``
of ``fit/reservoir.py``) against ``fv3net_tpu`` on the same numpy
inputs, on the CPU.

Tolerances: the PCA fit is the reference's numpy code, so its arrays
are equal bit for bit; float64 encodes, decodes and trained epochs agree
to 1e-12 of scale (summation order only), float32 ones to 1e-5.  The
reference's trainers run on the reference's initial weights, handed to
the port by monkeypatching its init function.  The reference's
subdomain reservoir cannot take the autoencoder as its latent space
(its ``encode`` takes a dict; ROADMAP.md Queue 3), so the port's
autoencoder-latent model is held against the reference's plain
subdomain reservoir trained on the reference autoencoder's latents.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import Float64Module, handover, rel_diff, serial_solves

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import autoencoder as tae
from fv3net_torch.fit import io
from fv3net_torch.fit import reservoir as tres
from fv3net_torch.fit import transformers as ttr

jax.config.update("jax_enable_x64", True)

F64_RTOL = 1e-12
F32_RTOL = 1e-5
N_SUB = 8  # C8 cube series
DIMS = ("time", "tile", "y", "x", "f")


def _features(n=200, seed=0, dtype=np.float64):
    """[n, 10] correlated features: 6 of one variable, 4 of another."""
    rng = np.random.RandomState(seed)
    base = rng.randn(n, 3)
    mix = rng.randn(3, 10)
    return (base @ mix + 0.05 * rng.randn(n, 10) + 3.0).astype(dtype)


def _cube_series(nt=30, n=N_SUB, nf=6, seed=0, dtype=np.float64):
    """A smooth traveling pattern on the cube [nt, 6, n, n, nf], its
    features correlated (a rank-3 mix plus noise)."""
    rng = np.random.RandomState(seed)
    base = rng.randn(6, n, n, 3)
    mix = rng.randn(3, nf)
    out = np.empty((nt, 6, n, n, nf))
    for t in range(nt):
        out[t] = (np.roll(base, t, axis=2) @ mix
                  + 0.01 * rng.randn(6, n, n, nf))
    return out.astype(dtype)




# ---------------------------------------------------------------------------
# transformers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pca_fit_encode_decode_match_reference(dtype):
    """The fit equal bit for bit (the same numpy code, its dtype the
    data's); encode and decode within 1e-5 (float32) / 1e-12 (float64);
    ``encode`` resets the split sizes as the reference's does."""
    from fv3net_tpu.fit.transformers import PCATransformer as JPCA

    X = _features(dtype=dtype)
    parts = [X[:, :6], X[:, 6:]]
    jp = JPCA.fit(parts, n_components=4, enforce_positive_outputs=True)
    tp = ttr.PCATransformer.fit([torch.tensor(p) for p in parts],
                                n_components=4,
                                enforce_positive_outputs=True)
    for name in ("mean", "std", "components"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert tp.components.dtype == torch.float32 if dtype == np.float32 \
        else torch.float64
    tol = F32_RTOL if dtype == np.float32 else F64_RTOL
    held = _features(n=16, seed=3, dtype=dtype)
    want = np.asarray(jp.encode([jnp.asarray(held)]))
    got = tp.encode([torch.tensor(held)])
    assert rel_diff(got.numpy(), want) <= tol
    assert tp.original_feature_sizes == jp.original_feature_sizes == [10]
    for g, w in zip(tp.decode(got), jp.decode(jnp.asarray(want))):
        assert rel_diff(g.numpy(), np.asarray(w)) <= tol
        assert (g.numpy() >= 0).all()
    with pytest.raises(ValueError, match="exceeds"):
        ttr.PCATransformer.fit([torch.tensor(X[:3])], n_components=5)


def test_pca_encode_promotes_as_the_reference():
    """A float32 field encoded by float64 components gives a float64
    latent in both packages."""
    from fv3net_tpu.fit.transformers import PCATransformer as JPCA

    X = _features()
    jp = JPCA.fit([X], 3)
    tp = ttr.PCATransformer.fit([X], 3)
    x32 = X[:5].astype(np.float32)
    want = jp.encode([jnp.asarray(x32)])
    got = tp.encode([torch.tensor(x32)])
    assert str(want.dtype) == "float64" and got.dtype == torch.float64
    assert rel_diff(got.numpy(), np.asarray(want)) <= F64_RTOL


def test_do_nothing_autoencoder_and_artifacts_both_ways(tmp_path):
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit.transformers import PCATransformer as JPCA

    a, b = _features()[:, :6], _features()[:, 6:]
    dn = ttr.DoNothingAutoencoder([])
    with pytest.raises(ValueError, match="encode"):
        dn.decode(torch.zeros(2, 10))
    latent = dn.encode([torch.tensor(a), torch.tensor(b)])
    assert dn.n_latent_dims == 10
    back = dn.decode(latent)
    np.testing.assert_array_equal(back[1].numpy(), b)
    io.dump(dn, str(tmp_path / "dn"))
    assert jio.load(str(tmp_path / "dn")).original_feature_sizes == [6, 4]

    jp = JPCA.fit([a, b], 4)
    jio.dump(jp, str(tmp_path / "jpca"))
    tp = io.load(str(tmp_path / "jpca"))
    assert isinstance(tp, ttr.PCATransformer)
    io.dump(tp, str(tmp_path / "tpca"))
    jback = jio.load(str(tmp_path / "tpca"))
    for name in ("mean", "std", "components"):
        np.testing.assert_array_equal(np.asarray(getattr(jback, name)),
                                      np.asarray(getattr(jp, name)))
    np.testing.assert_array_equal(
        ttr.pca_from_jax(jp).components.numpy(), np.asarray(jp.components))


def test_dataset_predictor_with_halo_against_reference(tmp_path):
    """The halo path: every variable haloed by the cube's halo append,
    then the base model's ``predict_arrays`` (a stand-in that doubles
    the haloed field's rows)."""
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.fit.transformers import DatasetPredictor as JDP

    class Echo:
        input_variables = ["a"]

        def predict_arrays(self, data):
            return {"b": data["a"].reshape(-1, 9) * 2.0}

    field = np.random.RandomState(1).randn(6, 3, 5, 5)
    jd = JDP(["a"], ["b"], Echo(), n_halo=2).predict(
        JDataset({"a": JQuantity(jnp.asarray(field),
                                 ("tile", "z", "y", "x"))}))
    td = ttr.DatasetPredictor(["a"], ["b"], Echo(), n_halo=2).predict(
        Dataset({"a": Quantity(torch.tensor(field),
                               ("tile", "z", "y", "x"))}))
    np.testing.assert_array_equal(td["b"].data.numpy(),
                                  np.asarray(jd["b"].data))
    assert td["b"].data.shape == (6 * 3 * 9, 9)


# ---------------------------------------------------------------------------
# the dense autoencoder
# ---------------------------------------------------------------------------
AE_HP = dict(state_variables=["a", "b"], latent_dim_size=3, units=16,
             n_dense_layers=2, learning_rate=1e-3, epochs=3, batch_size=64,
             seed=2)


def _ae_batch(jax_side, n=200):
    X = _features(n=n)
    if jax_side:
        from fv3net_tpu.core.dataset import Dataset as JDataset
        from fv3net_tpu.core.quantity import Quantity as JQuantity

        return JDataset({"a": JQuantity(jnp.asarray(X[:, :6]),
                                        ("sample", "z")),
                         "b": JQuantity(jnp.asarray(X[:, 6:]),
                                        ("sample", "z"))})
    return Dataset({"a": Quantity(torch.tensor(X[:, :6]), ("sample", "z")),
                    "b": Quantity(torch.tensor(X[:, 6:]), ("sample", "z"))})


def _reference_autoencoder_init(hp):
    """The reference trainer's initial (encoder, decoder) weights."""
    from fv3net_tpu.fit.dense import init_mlp_params

    k1, k2 = jax.random.split(jax.random.PRNGKey(hp["seed"]))
    nf, lat, u = 10, hp["latent_dim_size"], hp["units"]
    n = hp["n_dense_layers"]
    return (init_mlp_params(k1, [nf] + [u] * n + [lat]),
            init_mlp_params(k2, [lat] + [u] * n + [nf]))


@pytest.fixture(scope="module")
def autoencoders():
    """(reference, port) autoencoders trained 3 float64 epochs from the
    same initial weights."""
    from fv3net_tpu.fit.autoencoder import (
        DenseAutoencoderHyperparameters as JHP,
        train_dense_autoencoder as jtrain,
    )

    jm = jtrain(JHP(**AE_HP), [_ae_batch(True)])
    mp = pytest.MonkeyPatch()
    mp.setattr(tae, "init_mlp_params",
               handover(_reference_autoencoder_init(AE_HP)))
    try:
        tm = tae.train_dense_autoencoder(
            tae.DenseAutoencoderHyperparameters(**AE_HP),
            [_ae_batch(False)])
    finally:
        mp.undo()
    return jm, tm


def test_autoencoder_trained_epochs_match_reference(autoencoders):
    jm, tm = autoencoders
    for tag in ("enc_params", "dec_params"):
        for jl, tl in zip(getattr(jm, tag), getattr(tm, tag)):
            for k in ("w", "b"):
                assert rel_diff(tl[k].numpy(), np.asarray(jl[k])) <= 1e-10
    assert tm.n_latent_dims == 3


def test_autoencoder_apply_paths_match_reference(autoencoders):
    """encode (dict and sequence), decode and the round trip."""
    jm, _ = autoencoders
    tm = tae.autoencoder_from_jax(jm)
    X = _features(n=20, seed=5)
    data = {"a": X[:, :6], "b": X[:, 6:]}
    want = np.asarray(jm.encode({k: jnp.asarray(v) for k, v in data.items()}))
    got = tm.encode({k: torch.tensor(v) for k, v in data.items()})
    assert rel_diff(got.numpy(), want) <= F64_RTOL
    seq = tm.encode([torch.tensor(X.reshape(4, 5, 10))])
    assert rel_diff(seq.numpy().reshape(20, 3), want) <= F64_RTOL
    dec_want = jm.decode(jnp.asarray(want))
    dec_got = tm.decode(got)
    for k in ("a", "b"):
        assert rel_diff(dec_got[k].numpy(), np.asarray(dec_want[k])) \
            <= F64_RTOL
    pred = tm.predict(_ae_batch(False, n=20))
    assert sorted(pred) == ["a", "b"] and pred["a"].shape == (20, 6)


def test_autoencoder_artifacts_both_ways(autoencoders, tmp_path):
    from fv3net_tpu.fit import io as jio

    jm, tm = autoencoders
    jio.dump(jm, str(tmp_path / "j"))
    io.dump(tm, str(tmp_path / "t"))
    t_from_j = io.load(str(tmp_path / "j"))
    j_from_t = jio.load(str(tmp_path / "t"))
    X = _features(n=10, seed=6)
    data = {"a": X[:, :6], "b": X[:, 6:]}
    want = np.asarray(jm.encode({k: jnp.asarray(v) for k, v in data.items()}))
    got = t_from_j.encode({k: torch.tensor(v) for k, v in data.items()})
    assert rel_diff(got.numpy(), want) <= F64_RTOL
    back = np.asarray(j_from_t.encode(
        {k: jnp.asarray(v) for k, v in data.items()}))
    assert rel_diff(back, tm.encode(
        {k: torch.tensor(v) for k, v in data.items()}).numpy()) <= F64_RTOL


def test_reference_latent_reservoir_rejects_its_autoencoder(autoencoders,
                                                            tmp_path):
    """The reference's subdomain reservoir calls ``encode([field])``,
    which its Autoencoder cannot take (it packs a dict): ROADMAP.md
    Queue 3.  The port's takes it."""
    from fv3net_tpu.fit import io as jio

    jm, _ = autoencoders
    with pytest.raises(TypeError):
        jm.encode([jnp.zeros((4, 10))])
    jio.dump(jm, str(tmp_path / "ae"))
    tm = io.load(str(tmp_path / "ae"))
    assert tm.encode([torch.zeros((2, 3, 10), dtype=torch.float64)]).shape \
        == (2, 3, 3)


# ---------------------------------------------------------------------------
# the latent-space subdomain reservoir
# ---------------------------------------------------------------------------
RES_HP = dict(state_size=32, n_burn=4, seed=1, l2_regularization=1e-3)


def _jds(u, y):
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    return JDataset({"inputs": JQuantity(jnp.asarray(u), DIMS),
                     "outputs": JQuantity(jnp.asarray(y), DIMS)})


def _tds(u, y):
    return Dataset({"inputs": Quantity(torch.tensor(u), DIMS),
                    "outputs": Quantity(torch.tensor(y), DIMS)})


def _hps(path):
    from fv3net_tpu.fit import reservoir as jres

    kw = dict(subdomain_layout=(2, 2), overlap=1, transformer_path=path)
    return (jres.SubdomainReservoirHyperparameters(
                reservoir=jres.ReservoirHyperparameters(**RES_HP), **kw),
            tres.SubdomainReservoirHyperparameters(
                reservoir=tres.ReservoirHyperparameters(**RES_HP), **kw))


def _rollout(model, series, array):
    model.reset_state()
    for x in series[:3]:
        model.increment(array(x))
    return np.asarray(model.predict_from_state())


@pytest.fixture
def float64_everywhere(monkeypatch):
    from fv3net_tpu.fit import reservoir as jres

    monkeypatch.setattr(jres, "np", Float64Module(np, np.float64))
    monkeypatch.setattr(jres, "jnp", Float64Module(jnp, jnp.float64))
    monkeypatch.setattr(tres, "STATE_DTYPE", torch.float64)


def test_pca_latent_reservoir_float64_matches_reference(
        float64_everywhere, tmp_path):
    """Readout, rollout (decoded to the raw features) and artifacts of a
    PCA-latent subdomain model, float64 components and series, within
    1e-10 of scale."""
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit import reservoir as jres
    from fv3net_tpu.fit.transformers import PCATransformer as JPCA

    s = _cube_series()
    path = str(tmp_path / "pca")
    jio.dump(JPCA.fit([s.reshape(-1, 6)], n_components=3), path)
    jhp, thp = _hps(path)
    jm = jres.train_subdomain_reservoir(jhp, [_jds(s[:-1], s[1:])])
    with serial_solves():
        tm = tres.train_subdomain_reservoir(thp, [_tds(s[:-1], s[1:])])
    assert tm.n_features_out == jm.n_features_out == 3
    assert tm.state.dtype == torch.float64
    assert rel_diff(tm.coefficients.numpy(),
                    np.asarray(jm.coefficients)) <= 1e-10
    held = _cube_series(nt=3, seed=9)
    want = _rollout(jm, held, jnp.asarray)
    got = _rollout(tm, held, torch.tensor)
    assert got.shape == (6, N_SUB, N_SUB, 6)
    assert rel_diff(got, want) <= 1e-10
    # artifacts both ways, the nested transformer included
    io.dump(tm, str(tmp_path / "t"))
    jio.dump(jm, str(tmp_path / "j"))
    j_from_t = jio.load(str(tmp_path / "t"))
    t_from_j = io.load(str(tmp_path / "j"))
    assert isinstance(t_from_j.transformer, ttr.PCATransformer)
    assert rel_diff(_rollout(t_from_j, held, torch.tensor), want) <= 1e-10
    assert rel_diff(_rollout(j_from_t, held, jnp.asarray), got) <= 1e-10
    carried = tres.reservoir_from_jax(jm)
    assert rel_diff(_rollout(carried, held, torch.tensor), want) <= 1e-10
    offline = tm.predict(_tds(held, held))["outputs"].data.numpy()
    joff = np.asarray(jm.predict(_jds(held, held))["outputs"].data)
    assert offline.shape == (3, 6, N_SUB, N_SUB, 6)
    assert rel_diff(offline, joff) <= 1e-10


def test_pca_latent_reservoir_float32_matches_reference(tmp_path):
    """float32 series and components: the latents stay float32 in both
    packages; the rollout within 3 times the reference's own float32
    error, plus 1e-5, against the float64 run on the same artifact (the
    port's, which the test above holds to the reference's float64 run
    within 1e-10)."""
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit import reservoir as jres
    from fv3net_tpu.fit.transformers import PCATransformer as JPCA

    s = _cube_series(dtype=np.float32)
    path = str(tmp_path / "pca")
    jio.dump(JPCA.fit([s.reshape(-1, 6)], n_components=3), path)
    jhp, thp = _hps(path)
    jm = jres.train_subdomain_reservoir(jhp, [_jds(s[:-1], s[1:])])
    with serial_solves():
        tm = tres.train_subdomain_reservoir(thp, [_tds(s[:-1], s[1:])])
    held = _cube_series(nt=3, seed=9, dtype=np.float32)
    want = _rollout(jm, held, jnp.asarray)
    got = _rollout(tm, held, torch.tensor)
    assert tm.state.dtype == torch.float32 and got.dtype == np.float32
    with pytest.MonkeyPatch.context() as mp, serial_solves():
        mp.setattr(tres, "STATE_DTYPE", torch.float64)
        t64 = tres.train_subdomain_reservoir(thp, [_tds(s[:-1], s[1:])])
        control = _rollout(t64, held.astype(np.float64), torch.tensor)
    own = rel_diff(want, control)
    assert rel_diff(got, want) <= 3.0 * own + F32_RTOL, (
        rel_diff(got, want), own)


def test_autoencoder_latent_reservoir_against_reference_on_latents(
        autoencoders, float64_everywhere, tmp_path):
    """The port's autoencoder-latent model: its readout equals the
    reference's plain subdomain reservoir trained on the reference
    autoencoder's latents of the same series, its rollout that readout
    decoded by the reference's decoder."""
    from fv3net_tpu.fit import reservoir as jres

    jae, _ = autoencoders
    s = _cube_series(nf=10)
    path = str(tmp_path / "ae")
    io.dump(tae.autoencoder_from_jax(jae), path)

    def latents(x):
        flat = jnp.asarray(x.reshape(-1, 10))
        return np.asarray(jae.encode_packed(flat)).reshape(
            x.shape[:-1] + (3,))

    jhp, thp = _hps("")
    lat = latents(s)
    jm = jres.train_subdomain_reservoir(jhp, [_jds(lat[:-1], lat[1:])])
    thp.transformer_path = path
    with serial_solves():
        tm = tres.train_subdomain_reservoir(thp, [_tds(s[:-1], s[1:])])
    assert rel_diff(tm.coefficients.numpy(),
                    np.asarray(jm.coefficients)) <= 1e-9
    held = _cube_series(nt=3, nf=10, seed=9)
    jm.reset_state()
    for x in latents(held):
        jm.increment(jnp.asarray(x))
    readout = np.asarray(jm.predict_from_state())
    want = np.asarray(jae.decode_packed(jnp.asarray(
        readout.reshape(-1, 3)))).reshape(readout.shape[:-1] + (10,))
    got = _rollout(tm, held, torch.tensor)
    assert got.shape == (6, N_SUB, N_SUB, 10)
    assert rel_diff(got, want) <= 1e-9
    io.dump(tm, str(tmp_path / "model"))
    back = io.load(str(tmp_path / "model"))
    assert isinstance(back.transformer, tae.Autoencoder)
    np.testing.assert_array_equal(_rollout(back, held, torch.tensor), got)


def test_latent_corrector_in_the_loop_against_direct_calls(tmp_path):
    """A PCA-latent subdomain model (T in, T out, 8 levels, 3
    components) as the reservoir_corrector of a C6 float64 TimeLoop (3
    steps, 1 synchronization step): its predictions land in the state
    and equal the model called directly on the recorded states."""
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop

    rng = np.random.RandomState(0)
    series = 250.0 + 0.01 * rng.randn(12, 6, 6, 6, 8)
    pca = ttr.PCATransformer.fit([series.reshape(-1, 8)], 3)
    io.dump(pca, str(tmp_path / "pca"))
    hp = tres.SubdomainReservoirHyperparameters(
        input_variables=["air_temperature"],
        output_variables=["air_temperature"], subdomain_layout=(1, 1),
        overlap=1, transformer_path=str(tmp_path / "pca"),
        reservoir=tres.ReservoirHyperparameters(state_size=16, n_burn=2,
                                                l2_regularization=1.0))
    with serial_solves():
        model = tres.train_subdomain_reservoir(
            hp, [_tds(series[:-1], series[1:])])
    io.dump(model, str(tmp_path / "model"))
    cfg = get_config({
        "namelist": {"npx": 6, "npz": 8}, "duration_seconds": 2700.0,
        "reservoir_corrector": {"model_path": str(tmp_path / "model"),
                                "synchronize_steps": 1,
                                "reservoir_timestep_seconds": 900.0}})
    loop = TimeLoop(cfg, dtype=torch.float64, device="cpu")
    inc, pred = loop._reservoir_incrementer, loop._reservoir_predictor
    assert inc.model.transformer is not None
    calls = []

    def recorded(stepper):
        def call(time, state):
            out = stepper(time, state)
            calls.append(state["air_temperature"].data.clone())
            calls.append(out)
            return out
        return call

    loop._reservoir_incrementer = recorded(inc)
    loop._reservoir_predictor = recorded(pred)
    for i in range(3):
        loop._step()
        if i:
            update = calls[-1][2]["air_temperature"].data
            T_after = loop._derived()["air_temperature"].data
            assert rel_diff(T_after.numpy(), update.numpy()) <= 1e-13
    direct = io.load(str(tmp_path / "model"))
    for i in range(3):
        T_inc, T_pred, out = calls[4 * i], calls[4 * i + 2], calls[4 * i + 3]
        direct.increment(T_inc.movedim(1, -1))
        if i:
            want = direct.predict_from_state(
                T_pred.movedim(1, -1)).movedim(-1, 1)
            assert rel_diff(out[2]["air_temperature"].data.numpy(),
                            want.numpy()) <= 1e-14


def test_reservoir_module_has_no_not_ported_latent_space():
    import inspect

    assert "_transformer_not_ported" not in inspect.getsource(tres)
    assert tres.SubdomainReservoirModel.__init__.__defaults__ == (None,)
