"""The CycleGAN of ``fv3net_torch`` (``fit/cyclegan.py``) against
``fv3net_tpu``'s on the same numpy inputs, on the CPU, at C8 with narrow
networks.

The reference's network is float32 by design; for float64 comparisons
its module's ``np``/``jnp`` are replaced by objects whose ``float32``
reads float64, so that its weights, geographic features and training
arrays are float64.  Tolerances: the convolution primitives and apply
paths within 1e-12 of scale in float64, 1e-5 in float32; one float64
trained epoch (3 samples, the replay pool full after 2): its predictions
and each weight within 1e-12 of scale, but the biases ahead of an
instance norm (the generator's first, down, resnet and up convolutions),
held within 1e-6 of the learning rate: their gradient is roundoff alone
(0 in exact arithmetic), which Adam's first steps turn into updates of
up to lr |g| / eps each, different in each package.  The reference's
initial weights and pool draws are handed to the port by monkeypatching
its init functions and ``pool_draws``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import Float64Module, rel_diff

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import cyclegan as tcg
from fv3net_torch.fit import io

jax.config.update("jax_enable_x64", True)

N = 8
F64_RTOL = 1e-12
F32_RTOL = 1e-5
GEN = dict(n_convolutions=1, n_resnet=0, max_filters=8)
DISC = dict(n_convolutions=1, max_filters=8)



@pytest.fixture
def jcg64(monkeypatch):
    """The reference's cyclegan module in float64."""
    from fv3net_tpu.fit import cyclegan as jcg

    monkeypatch.setattr(jcg, "np", Float64Module(np, np.float64))
    monkeypatch.setattr(jcg, "jnp", Float64Module(jnp, jnp.float64))
    return jcg


def _tree(node, dtype=None):
    """A reference pytree as tensors."""
    if isinstance(node, dict):
        return {k: _tree(v, dtype) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree(v, dtype) for v in node)
    return torch.tensor(np.asarray(node), dtype=dtype)


def _field(c=5, seed=0, n=N, lead=()):
    return np.random.RandomState(seed).randn(*lead, 6, n, n, c)


@pytest.mark.parametrize("k,stride", [(3, 1), (7, 1), (4, 2), (3, 2)])
def test_conv_matches_reference(k, stride, jcg64):
    rng = np.random.RandomState(k + stride)
    x = _field()
    w, b = rng.randn(k, k, 5, 4), rng.randn(4)
    want = np.asarray(jcg64._conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), stride=stride))
    got = tcg._conv(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                    stride=stride)
    assert got.shape == want.shape == (6, N // stride, N // stride, 4)
    assert rel_diff(got.numpy(), want) <= F64_RTOL
    # leading sample dimensions fold into the batch
    two = tcg._conv(torch.tensor(np.stack([x, -x])), torch.tensor(w),
                    torch.zeros(4, dtype=torch.float64), stride=stride)
    assert rel_diff(two[1].numpy(), -(want - b)) <= F64_RTOL


@pytest.mark.parametrize("k", [3, 4])
def test_conv_transpose_matches_lax_semantics(k, jcg64):
    """The halo, zero dilation and VALID cross-correlation of
    ``lax.conv_general_dilated(lhs_dilation=2)``: the kernel unflipped."""
    rng = np.random.RandomState(k)
    x = _field(c=3, n=4)
    w, b = rng.randn(k, k, 3, 2), rng.randn(2)
    want = np.asarray(jcg64._conv_transpose(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(b)))
    got = tcg._conv_transpose(torch.tensor(x), torch.tensor(w),
                              torch.tensor(b))
    assert got.shape == want.shape == (6, 8, 8, 2)
    assert rel_diff(got.numpy(), want) <= F64_RTOL


def test_halo_and_inorm_match_reference(jcg64):
    x = _field(c=2)
    want = np.asarray(jcg64._halo(jnp.asarray(x), 2))
    got = tcg._halo(torch.tensor(x), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jcg64._inorm(jnp.asarray(x)))
    assert rel_diff(tcg._inorm(torch.tensor(x)).numpy(), want) <= F64_RTOL


def _configs(jcg):
    return (jcg.GeneratorConfig(**GEN), jcg.DiscriminatorConfig(**DISC))


def _geo64():
    """The reference's geographic features in float64 (its own are
    float32), handed to its apply functions."""
    from fv3net_tpu.grid.geometry import make_grid

    grid = make_grid(N)
    lat, lon = jnp.asarray(grid.lat), jnp.asarray(grid.lon)
    xyz = jnp.stack([jnp.cos(lat) * jnp.cos(lon), jnp.cos(lat) * jnp.sin(lon),
                     jnp.sin(lat)], axis=-1)
    return lat, lon, xyz


def _discriminator_close(jcg, dp, dcfg, geo, td, tgeo, x, tol):
    want = np.asarray(jax.jit(lambda p, a: jcg.apply_discriminator(
        p, dcfg, geo, a))(dp, jnp.asarray(x)))
    got = tcg.apply_discriminator(_tree(dp), td, tgeo, torch.tensor(x))
    assert got.shape == want.shape == (6, N // 2, N // 2, 1)
    assert rel_diff(got.numpy(), want) <= tol


def test_discriminator_apply_float64():
    """The discriminator, jitted in the reference, on its initial weights
    in float64 (the generator is held by the trained models' predictions
    below, in float64 and float32)."""
    from fv3net_tpu.fit import cyclegan as jcg

    _, dcfg = _configs(jcg)
    dp = jax.tree_util.tree_map(
        lambda a: a.astype(np.float64),
        jcg.init_discriminator(jax.random.PRNGKey(5), dcfg, 3))
    _discriminator_close(jcg, dp, dcfg, _geo64(), _configs(tcg)[1],
                         tcg._geo_features(N), _field(c=3, seed=4),
                         F64_RTOL)


def test_pool_query_matches_reference():
    """The port's list pool and the reference's in-graph buffer return the
    same images on the same draws (size 3, 8 queries)."""
    from fv3net_tpu.fit import cyclegan as jcg

    size = 3
    keys = jax.random.split(jax.random.PRNGKey(4), 8)
    pool, count = jnp.zeros((size, 2)), jnp.int32(0)
    tpool = []
    for i, key in enumerate(keys):
        img = np.full(2, float(i))
        pool, count, ret = jcg.pool_query(pool, count, key, jnp.asarray(img))
        ku, ki = jax.random.split(key)
        draws = (float(jax.random.uniform(ku)),
                 int(jax.random.randint(ki, (), 0, size)))
        got = tcg.pool_query(tpool, size, draws, torch.tensor(img))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ret))
    assert len(tpool) == size


def _datasets(nt=3, seed=0):
    """Domain a and domain b samples [time, tile, z, y, x] of T (2
    levels) and surface pressure, as (reference, port) pairs."""
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    rng = np.random.RandomState(seed)
    out = []
    for shift in (0.0, 3.0):
        T = 250 + shift + 5 * rng.randn(nt, 6, 2, N, N)
        ps = 1e5 + 300 * rng.randn(nt, 6, N, N)
        dims = (("time", "tile", "z", "y", "x"), ("time", "tile", "y", "x"))
        out.append((
            JDataset({"T": JQuantity(jnp.asarray(T), dims[0]),
                      "ps": JQuantity(jnp.asarray(ps), dims[1])}),
            Dataset({"T": Quantity(torch.tensor(T), dims[0]),
                     "ps": Quantity(torch.tensor(ps), dims[1])})))
    return out


HP = dict(state_variables=["T", "ps"], image_pool_size=2, epochs=1, seed=3)


def _reference_draws(seed, nt, size):
    """The reference trainer's pool draws, in the order of the port's
    calls (domain a, then b, each sample)."""
    key = jax.random.split(jax.random.PRNGKey(seed), 5)[4]
    draws = []
    for _ in range(nt):
        key, ka, kb = jax.random.split(key, 3)
        for k in (ka, kb):
            ku, ki = jax.random.split(k)
            draws.append((float(jax.random.uniform(ku)),
                          int(jax.random.randint(ki, (), 0, size))))
    return draws


@pytest.fixture(scope="module")
def trained():
    """(reference, port) trained one float64 epoch on 3 samples from the
    same initial weights and pool draws; the reference's module in
    float64 while its models are used."""
    from fv3net_tpu.fit import cyclegan as jcg

    patch = pytest.MonkeyPatch()
    patch.setattr(jcg, "np", Float64Module(np, np.float64))
    patch.setattr(jcg, "jnp", Float64Module(jnp, jnp.float64))
    jcg64 = jcg
    (ja, ta), (jb, tb) = _datasets()
    jhp = jcg64.CycleGANHyperparameters(
        generator=jcg64.GeneratorConfig(**GEN),
        discriminator=jcg64.DiscriminatorConfig(**DISC), **HP)
    jm = jcg64.train_cyclegan(jhp, [(ja, jb)])
    keys = jax.random.split(jax.random.PRNGKey(HP["seed"]), 5)
    gens = iter([jcg64.init_generator(keys[i], jhp.generator, 3, N)
                 for i in (0, 1)])
    discs = iter([jcg64.init_discriminator(keys[i], jhp.discriminator, 3)
                  for i in (2, 3)])
    draws = iter(_reference_draws(HP["seed"], 3, 2))
    mp = pytest.MonkeyPatch()
    mp.setattr(tcg, "init_generator",
               lambda *a, **k: _tree(next(gens)))
    mp.setattr(tcg, "init_discriminator",
               lambda *a, **k: _tree(next(discs)))
    mp.setattr(tcg, "pool_draws", lambda g, size: next(draws))
    try:
        tm = tcg.train_cyclegan(tcg.CycleGANHyperparameters(
            generator=dict(GEN), discriminator=dict(DISC), **HP),
            [(ta, tb)])
    finally:
        mp.undo()
    yield jm, tm, (ja, ta), (jb, tb)
    patch.undo()


def _leaf_paths(tree, path=()):
    """(path, leaf) of a parameter tree in its flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, path + (i,))
    else:
        yield path, tree


def _ahead_of_inorm(path):
    """A generator's bias whose convolution feeds an instance norm."""
    return path[-1] == "b" and path[0] in ("first", "down", "resnet", "up")


def test_trained_epoch_float64_matches_reference(trained):
    jm, tm, *_ = trained
    lr = tcg.CycleGANHyperparameters().learning_rate
    n_floored = 0
    for tag in ("g_ab", "g_ba"):
        jl = jax.tree_util.tree_leaves(getattr(jm, tag))
        tl = list(_leaf_paths(getattr(tm, tag)))
        assert len(jl) == len(tl)
        for (path, t), j in zip(tl, jl):
            j = np.asarray(j)
            err = np.abs(t.numpy() - j).max()
            if _ahead_of_inorm(path):
                n_floored += 1
                assert err <= 1e-6 * lr, (tag, path, err)
            else:
                assert err <= F64_RTOL * np.abs(j).max(), (tag, path, err)
    assert n_floored == 6  # first, down.0 and up.0 of each generator


def test_predict_reverse_and_artifacts_both_ways(trained, tmp_path):
    from fv3net_tpu.fit import io as jio

    jm, tm, (ja, ta), (jb, tb) = trained
    for direction in ("predict", "reverse"):
        want = getattr(jm, direction)(ja)
        got = getattr(tm, direction)(ta)
        for k in ("T", "ps"):
            assert got[k].dims == want[k].dims
            assert rel_diff(got[k].data.numpy(),
                            np.asarray(want[k].data)) <= F64_RTOL
    # the same float64 weights: the generator's apply path to 1e-12; in
    # float32 (weights and inputs) to 1e-5
    carried = tcg.cyclegan_from_jax(jm)
    want = jm.predict(ja)
    for k, v in carried.predict(ta).items():
        assert rel_diff(v.data.numpy(), np.asarray(want[k].data)) \
            <= F64_RTOL
    f32 = tcg.cyclegan_from_jax(jm, dtype=torch.float32)
    for k, v in f32.predict(ta).items():
        assert v.data.dtype == torch.float32
        assert rel_diff(v.data.numpy(), np.asarray(want[k].data)) \
            <= F32_RTOL
    jio.dump(jm, str(tmp_path / "j"))
    io.dump(tm, str(tmp_path / "t"))
    for k, v in io.load(str(tmp_path / "j")).predict(ta).items():
        assert rel_diff(v.data.numpy(), np.asarray(want[k].data)) \
            <= F64_RTOL
    mine = tm.predict(ta)
    back = jio.load(str(tmp_path / "t")).predict(ja)
    for k in mine:
        assert rel_diff(np.asarray(back[k].data), mine[k].data.numpy()) \
            <= F64_RTOL
