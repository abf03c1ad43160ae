"""fv3net_torch's vertical remap held against fv3net_tpu's on shared numpy
inputs, and the CUDA kernel K1 against its plain version on the card.

The JAX side runs on the CPU; its Pallas kernel runs in interpret mode.
On a machine without jax (the card's), only the card test runs:
``python -m pytest --noconftest tests/test_torch_remap.py -m gpu``.
"""
import functools

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
except ImportError:  # the card's machine has no jax
    jax = jnp = None

import torch_port_util  # noqa: F401  (torch threads under xdist)

from fv3net_torch.ops import remap as tr
from fv3net_torch.ops import remap_cuda, zscan

TORCH = {"float64": torch.float64, "float32": torch.float32}
# f64: roundoff of reassociated sums; f32: the bounds the reference holds
# its own Pallas kernel to (tests/test_pallas_kernels.py)
F64_RTOL = 1e-12
F32_ATOL = 5e-3


def _need_jax():
    if jax is None:
        pytest.skip("needs jax (the reference package)")


def _edges(shape=(6, 6, 6), km=32, seed=0):
    """A Lagrangian pe1 and a perturbed, sorted target pe2 sharing the
    top and bottom edges (the shape of a dycore remap)."""
    rng = np.random.RandomState(seed)
    pe1 = np.cumsum(np.abs(rng.rand(*shape, km + 1)) + 1.0, -1) * 300.0
    pe2 = pe1.copy()
    pe2[..., 1:-1] += (
        0.3 * np.diff(pe1, axis=-1)[..., :-1] * rng.randn(*shape, km - 1)
    )
    pe2.sort(-1)
    pe2[..., 0] = pe1[..., 0]
    pe2[..., -1] = pe1[..., -1]
    return pe1, pe2, rng


def _field(rng, shape, km, F, iv):
    qshape = ((F,) if F else ()) + shape + (km,)
    q = rng.rand(*qshape) + 0.1
    if iv == -1:
        q = q - 0.6  # winds change sign
    return q


def _jax_search(pe1, pe2, dtype):
    from fv3net_tpu.ops import remap as jr

    return jax.jit(lambda a, b: jr.banded_search(a, b, 2))(
        jnp.asarray(pe1, dtype), jnp.asarray(pe2, dtype)
    )


def _torch_search(pe1, pe2, dtype):
    return tr.banded_search(torch.tensor(pe1, dtype=TORCH[dtype]),
                            torch.tensor(pe2, dtype=TORCH[dtype]), 2)


@functools.lru_cache(maxsize=None)
def _reference_remap(dtype, iv):
    """Inputs and the reference's (cs_profile, remap_apply) outputs for a
    stack of 3 fields, from one jitted call (shared by two tests)."""
    from fv3net_tpu.ops import remap as jr

    pe1, pe2, rng = _edges()
    q = _field(rng, pe1.shape[:-1], 32, 3, iv)

    def ref(a, b, qq):
        search = jr.banded_search(a, b, 2)
        return (jr.cs_profile(qq, search["dp1"], iv, 9),
                jr.remap_apply(search, qq, iv=iv, kord=9))

    profile, q2 = jax.jit(ref)(jnp.asarray(pe1, dtype),
                               jnp.asarray(pe2, dtype),
                               jnp.asarray(q, dtype))
    return pe1, pe2, q, [np.asarray(x) for x in profile], np.asarray(q2)


def _scale_diff(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(
        np.asarray(want)
    ).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_banded_search_matches_reference(dtype):
    _need_jax()
    pe1, pe2, _ = _edges()
    sj = _jax_search(pe1, pe2, dtype)
    st = _torch_search(pe1, pe2, dtype)
    for key in ("p", "below", "dp1"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))
    for oj, ot in zip(sj["offsets"], st["offsets"]):
        np.testing.assert_array_equal(ot["L"], oj["L"])
        np.testing.assert_array_equal(ot["use"].numpy(), np.asarray(oj["use"]))
        for key in ("wA", "wB", "wC"):
            if dtype == "float64":
                assert _scale_diff(ot[key].numpy(), oj[key]) <= F64_RTOL
            else:
                np.testing.assert_allclose(ot[key].numpy(), np.asarray(oj[key]),
                                           atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("iv", [-1, 0, 1, 2])
def test_cs_profile_matches_reference(dtype, iv):
    _need_jax()
    pe1, _, q, want, _ = _reference_remap(dtype, iv)
    got = tr.cs_profile(torch.tensor(q, dtype=TORCH[dtype]),
                        torch.tensor(np.diff(pe1, axis=-1), dtype=TORCH[dtype]),
                        iv, 9)
    for g, w in zip(got, want):
        if dtype == "float64":
            assert _scale_diff(g.numpy(), w) <= F64_RTOL
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("iv", [-1, 0, 1, 2])
def test_remap_apply_matches_reference(dtype, iv):
    _need_jax()
    pe1, pe2, q, _, want = _reference_remap(dtype, iv)
    got = tr.remap_apply(_torch_search(pe1, pe2, dtype),
                         torch.tensor(q, dtype=TORCH[dtype]), iv=iv,
                         kord=9).numpy()
    dp2 = np.diff(pe2, axis=-1)
    if dtype == "float64":
        assert _scale_diff(got, want) <= F64_RTOL
    else:
        assert np.abs((got - want) * dp2).max() < F32_ATOL
        np.testing.assert_allclose(got, want, atol=F32_ATOL)
    # column conservation, telescoping-exact up to roundoff of the column
    # mass (absolute: sign-changing fields cancel in the sum)
    mass1 = q * np.diff(pe1, axis=-1)
    tol = (2e-6 if dtype == "float32" else 1e-12) * np.abs(mass1).sum(-1).max()
    np.testing.assert_allclose((got * dp2).sum(-1), mass1.sum(-1), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("F", [None, 3])
def test_plain_matches_pallas_kernel_interpret(F):
    """The port's plain application against the TPU kernel K1 itself
    (interpret mode), at f32, to the bounds the reference holds K1 to."""
    _need_jax()
    from fv3net_tpu.ops import pallas_remap as pr
    from fv3net_tpu.ops import remap as jr

    pe1, pe2, rng = _edges(shape=(6, 8, 8))
    sj = _jax_search(pe1, pe2, "float32")
    st = _torch_search(pe1, pe2, "float32")
    q = _field(rng, pe1.shape[:-1], 32, F, 1)

    def kernel(search, qq):
        al, ar, a6 = jr.cs_profile(qq, jnp.broadcast_to(search["dp1"], qq.shape),
                                   1, 9)
        return pr.apply_packed(pr.pack_search(search), qq, al, ar, a6,
                               interpret=True)

    want = np.asarray(jax.jit(kernel)(sj, jnp.asarray(q, jnp.float32)))
    got = tr.remap_apply(st, torch.tensor(q, dtype=torch.float32), iv=1,
                         kord=9, impl="torch").numpy()
    dp2 = np.diff(pe2, axis=-1)
    assert np.abs((got - want) * dp2).max() < F32_ATOL
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


def test_zscan_matches_reference():
    _need_jax()
    from fv3net_tpu.ops import zscan as jz

    x = np.random.RandomState(3).randn(4, 5, 7)
    for axis in (1, -1):
        np.testing.assert_allclose(
            zscan.cumsum(torch.tensor(x), axis=axis).numpy(),
            np.asarray(jz.cumsum(jnp.asarray(x), axis=axis)), rtol=1e-13,
            atol=1e-13,
        )
        np.testing.assert_allclose(
            zscan.suffix_sum_strict(torch.tensor(x), axis=axis).numpy(),
            np.asarray(jz.suffix_sum_strict(jnp.asarray(x), axis=axis)),
            rtol=1e-13, atol=1e-13,
        )


def test_cpu_tensor_takes_plain_path_and_cuda_impl_raises():
    pe1, pe2, rng = _edges(shape=(2, 3))
    st = tr.banded_search(torch.tensor(pe1), torch.tensor(pe2), 2)
    q = torch.tensor(_field(rng, pe1.shape[:-1], 32, 2, 1))
    before = remap_cuda.LAUNCHES
    default = tr.remap_apply(st, q, iv=1, kord=9)
    plain = tr.remap_apply(st, q, iv=1, kord=9, impl="torch")
    assert torch.equal(default, plain)
    assert remap_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tr.remap_apply(st, q, iv=1, kord=9, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        tr.remap_apply(st, q, iv=1, kord=9, impl="pallas")


def test_unported_profiles_raise():
    """The profiles this test once held to a raise are ported: kord 7
    (ppm_profile), iv=-2 with a surface value (cs_profile) and the
    one-shot remap_ppm each remap as the reference does, to float64
    roundoff (tests/test_torch_dycore_options.py holds every kord and iv
    against it)."""
    _need_jax()
    from fv3net_tpu.ops import remap as jr

    pe1, pe2, rng = _edges(shape=(2,))
    st = tr.banded_search(torch.tensor(pe1), torch.tensor(pe2), 2)
    q = _field(rng, pe1.shape[:-1], 32, None, 1)
    qs = rng.randn(2)
    sj = jr.banded_search(jnp.asarray(pe1), jnp.asarray(pe2), 2)
    for got, want in (
        (tr.remap_apply(st, torch.tensor(q), iv=1, kord=7),
         jr.remap_apply(sj, jnp.asarray(q), iv=1, kord=7, use_pallas=False)),
        (tr.remap_apply(st, torch.tensor(q), iv=-2, kord=9,
                        qs=torch.tensor(qs)),
         jr.remap_apply(sj, jnp.asarray(q), iv=-2, kord=9, use_pallas=False,
                        qs=jnp.asarray(qs))),
        (tr.remap_ppm(st["pe1"], torch.tensor(q), st["pe2"]),
         jr.remap_ppm(jnp.asarray(pe1), jnp.asarray(q), jnp.asarray(pe2))),
    ):
        assert _scale_diff(got.numpy(), want) <= F64_RTOL


def _to64(x):
    """``x`` with every floating tensor in it (dicts and lists walked) in
    float64."""
    if isinstance(x, dict):
        return {k: _to64(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to64(v) for v in x)
    if torch.is_tensor(x) and x.is_floating_point():
        return x.double()
    return x


def test_float32_error_at_km79_is_inherited():
    """``chip_smoke.py``'s float32 K1 case at km=79 (its C48 edges from
    seed 0, F=3 fields), rebuilt with numpy: the reference's float32
    ``remap_apply`` (its XLA path) and the port's plain version, each
    against the exact (float64) application of its own float32 search and
    profile.  Both difference float32 prefix sums of the column mass, so
    both err by ~1.2e-5 of scale (the plain version read 1.27e-5 on the
    card): the port inherits the error, within a factor of 2 of the
    reference's."""
    _need_jax()
    from fv3net_tpu.ops import remap as jr

    from fv3net_torch.dycore.vertical import hybrid_coordinate
    from fv3net_torch.grid.geometry import make_grid

    npx, km, F = 48, 79, 3
    rng = np.random.RandomState(0)
    grid = make_grid(npx)
    ak, bk = hybrid_coordinate(km)
    ps = 1.0e5 + 1500.0 * np.cos(2 * grid.lat) * np.sin(grid.lon)
    pe2 = ak + bk * ps[..., None]
    pe1 = pe2.copy()
    pe1[..., 1:-1] += 0.3 * np.diff(pe2, axis=-1)[..., :-1] * np.clip(
        rng.randn(*ps.shape, km - 1), -2.5, 2.5)
    pe1.sort(-1)
    q = 250.0 + 30.0 * rng.rand(F, 6, npx, npx, km)

    def error(search, q32, profile, got):
        exact = tr.remap_apply_plain(_to64(search), q32.double(),
                                     *_to64(profile))
        return ((got.double() - exact).abs().max() / exact.abs().max()
                ).item()

    st = tr.banded_search(torch.tensor(pe1, dtype=torch.float32),
                          torch.tensor(pe2, dtype=torch.float32), 2)
    q32 = torch.tensor(q, dtype=torch.float32)
    profile = tr.cs_profile(q32, st["dp1"], 1, 9)
    port = error(st, q32, profile,
                 tr.remap_apply_plain(st, q32, *profile))

    def ref(a, b, qq):
        s = jr.banded_search(a, b, 2)
        return (s, jr.cs_profile(qq, s["dp1"], 1, 9),
                jr.remap_apply(s, qq, iv=1, kord=9))

    sj, pj, want = jax.jit(ref)(jnp.asarray(pe1, jnp.float32),
                                jnp.asarray(pe2, jnp.float32),
                                jnp.asarray(q, jnp.float32))

    def t(x):
        return torch.tensor(np.array(x))

    search = {k: t(sj[k]) for k in ("p", "pe1", "pe2", "below", "dp1")}
    search["offsets"] = [
        {"L": np.array(o["L"]),
         **{k: t(o[k]) for k in ("use", "wA", "wB", "wC")}}
        for o in sj["offsets"]
    ]
    reference = error(search, q32, [t(x) for x in pj], t(want))
    assert 5e-6 < reference < 2e-5, reference
    assert 0.5 * reference <= port <= 2.0 * reference, (port, reference)


def _hybrid_edges(n=48, km=32, seed=0):
    """The C{n} hybrid coordinate over a varying surface pressure (pe2)
    and its Lagrangian perturbation (pe1): layers as thick as the model's,
    so pointwise errors are not amplified by near-empty target layers."""
    from fv3net_torch.dycore.vertical import hybrid_coordinate

    rng = np.random.RandomState(seed)
    ak, bk = hybrid_coordinate(km)
    ps = 1.0e5 + 1500.0 * rng.rand(6, n, n)
    pe2 = ak + bk * ps[..., None]
    pe1 = pe2.copy()
    pe1[..., 1:-1] += 0.3 * np.diff(pe2, axis=-1)[..., :-1] * np.clip(
        rng.randn(6, n, n, km - 1), -2.5, 2.5
    )
    pe1.sort(-1)
    return pe1, pe2, rng


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("float64", 1e-12)])
def test_kernel_matches_plain_on_card(dtype, rtol):
    """K1 on the card against the plain version on the same CUDA inputs,
    over km in {32, 33, 64, 79, 128} (one to four levels per lane; C48 at
    km=32, C16 otherwise), window in {1, 2, 3}, F in {1, 2, 3, 6} fields
    and iv in {-1, 0, 1}: max |diff| <= rtol * max |plain|, and column
    conservation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    tdt = TORCH[dtype]
    for km in (32, 33, 64, 79, 128):
        pe1, pe2, rng = _hybrid_edges(n=48 if km == 32 else 16, km=km)
        for window in (1, 2, 3):
            st = tr.banded_search(torch.tensor(pe1, dtype=tdt, device=dev),
                                  torch.tensor(pe2, dtype=tdt, device=dev),
                                  window)
            dp1 = st["dp1"]
            dp2 = st["pe2"][..., 1:] - st["pe2"][..., :-1]
            for F in (1, 2, 3, 6):
                for iv in (-1, 0, 1):
                    q = torch.tensor(_field(rng, pe1.shape[:-1], km, F, iv),
                                     dtype=tdt, device=dev)
                    before = remap_cuda.LAUNCHES
                    got = tr.remap_apply(st, q, iv=iv, kord=9, impl="cuda")
                    torch.cuda.synchronize()
                    assert remap_cuda.LAUNCHES == before + 1
                    want = tr.remap_apply(st, q, iv=iv, kord=9, impl="torch")
                    err = (got - want).abs().max().item()
                    case = (km, window, F, iv, err)
                    assert err <= rtol * want.abs().max().item(), case
                    m1 = (q * dp1).sum(-1)
                    m2 = (got * dp2).sum(-1)
                    assert ((m2 - m1).abs() <= rtol * m1.abs().max()).all(), case
    with pytest.raises(TypeError):
        remap_cuda.remap_apply_cuda(st, q.half(), q.half(), q.half(), q.half())
