"""fv3net_torch's k-table selections (K4 ``weighted_select_dot``, K3
``spec_band_dot``) held against fv3net_tpu's on shared numpy inputs, and
the CUDA kernels against their plain versions on the card.

The JAX side runs on the CPU: its Pallas kernels in interpret mode and
its one-hot XLA form.  On a machine without jax (the card's), only the
card tests run:
``python -m pytest --noconftest tests/test_torch_ktable.py -m gpu``.
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
except ImportError:  # the card's machine has no jax
    jax = jnp = None

from fv3net_torch.ops import ktable, ktable_cuda

TORCH = {"float64": torch.float64, "float32": torch.float32}
# the plain versions sum the same products in another order than the
# one-hot matmuls (f32: the reference's own bound, tests/test_pallas_ktable)
RTOL = {"float32": 2e-6, "float64": 1e-12}

# (rows, G, K, N): the shapes of tests/test_pallas_ktable.py
K4_SHAPES = [(630, 16, 12, 1000), (70, 12, 4, 512), (1180, 10, 8, 777),
             (10, 140, 2, 300)]
# (nbase, id bound, nspa, ng, paths, kw, st): one LW lower band (band 3)
# and one SW upper band (band 17, ids below the 3 hPa top's 96 rows)
K3_SHAPES = {"lw_lower": (70, 70, 9, 16, 2, 2, 3),
             "sw_upper": (236, 96, 5, 12, 1, 4, 2)}


def _need_jax():
    if jax is None:
        pytest.skip("needs jax (the reference package)")


def _k4_inputs(rows, G, K, N, seed=None):
    """tab [rows, G] and K (ids, w) terms; the first term's weight is None
    (weight 1), as at the reference's unweighted sites."""
    rng = np.random.default_rng(rows + G + K if seed is None else seed)
    tab = rng.standard_normal((rows, G))
    terms = [(rng.integers(0, rows, N).astype(np.int32),
              None if k == 0 else rng.random(N)) for k in range(K)]
    return tab, terms


def _k3_inputs(nbase, id_hi, nspa, ng, paths, kw, st, N=700, seed=5):
    rng = np.random.default_rng(seed)
    tab = rng.random((nbase, nspa * ng))
    w_paths = [[(rng.integers(0, id_hi, N).astype(np.int32), rng.random(N))
                for _ in range(kw)] for _ in range(paths)]
    s_paths = [[(rng.integers(0, nspa, N).astype(np.int32),
                 rng.random(N) * 1e3) for _ in range(st)]
               for _ in range(paths)]
    return tab, w_paths, s_paths


def _t(x, dtype, device="cpu"):
    if x is None:
        return None
    if np.issubdtype(np.asarray(x).dtype, np.integer):
        return torch.tensor(x, device=device)
    return torch.tensor(x, dtype=dtype, device=device)


def _j(x, dtype):
    if x is None:
        return None
    if np.issubdtype(np.asarray(x).dtype, np.integer):
        return jnp.asarray(x, jnp.int32)
    return jnp.asarray(x, dtype)


def _close(got, want, rtol):
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_weighted_select_plain_matches_reference(shape, dtype):
    """The plain K4 (gathers) against the reference's one-hot XLA form and
    its Pallas kernel in interpret mode."""
    _need_jax()
    from fv3net_tpu.ops import pallas_ktable as jk

    tab, terms = _k4_inputs(*shape)
    got = ktable.weighted_select_dot_plain(
        [(_t(i, None), _t(w, TORCH[dtype])) for i, w in terms],
        _t(tab, TORCH[dtype]),
    ).numpy()
    jterms = [(_j(i, dtype), _j(w, dtype)) for i, w in terms]
    jtab = _j(tab, dtype)
    for want in (jk.weighted_select_dot_xla(jterms, jtab),
                 jk.weighted_select_dot(jterms, jtab, interpret=True)):
        _close(got, np.asarray(want), RTOL[dtype])
    # the dispatcher takes the plain version for CPU tensors
    disp = ktable.weighted_select_dot(
        [(_t(i, None), _t(w, TORCH[dtype])) for i, w in terms],
        _t(tab, TORCH[dtype]),
    )
    np.testing.assert_array_equal(disp.numpy(), got)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(K3_SHAPES))
def test_spec_band_plain_matches_reference(case, dtype):
    """The plain K3 (base-row gathers, then the species stencil) against
    the reference's Pallas kernel in interpret mode."""
    _need_jax()
    from fv3net_tpu.ops import pallas_ktable as jk

    nspa = K3_SHAPES[case][2]
    tab, w_paths, s_paths = _k3_inputs(*K3_SHAPES[case])
    tdt = TORCH[dtype]

    def port_paths(paths):
        return [[(_t(i, None), _t(w, tdt)) for i, w in p] for p in paths]

    def jax_paths(paths):
        return [[(_j(i, dtype), _j(w, dtype)) for i, w in p] for p in paths]

    got = ktable.spec_band_dot_plain(port_paths(w_paths),
                                     port_paths(s_paths), _t(tab, tdt),
                                     nspa).numpy()
    want = jk.spec_band_dot(jax_paths(w_paths), jax_paths(s_paths),
                            _j(tab, dtype), nspa, interpret=True)
    _close(got, np.asarray(want), RTOL[dtype])
    disp = ktable.spec_band_dot(port_paths(w_paths), port_paths(s_paths),
                                _t(tab, tdt), nspa)
    np.testing.assert_array_equal(disp.numpy(), got)


def test_plain_versions_clamp_ids_and_keep_leading_shape():
    """Out-of-range ids read the edge rows (the kernels clamp the same
    way); leading shapes carry through."""
    rng = np.random.default_rng(0)
    tab = torch.tensor(rng.random((7, 3)))
    ids = torch.tensor([[-2, 0], [6, 9]])
    w = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    out = ktable.weighted_select_dot_plain([(ids, w)], tab)
    assert out.shape == (2, 2, 3)
    want = w[..., None] * tab[torch.tensor([[0, 0], [6, 6]])]
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    flat = torch.tensor(rng.random((4, 2 * 3)))
    one = torch.ones(2, 2, dtype=torch.float64)
    out = ktable.spec_band_dot_plain([[(ids, one)]], [[(ids, one)]], flat, 2)
    want = flat.reshape(4, 2, 3)[ids.clamp(0, 3), ids.clamp(0, 1)]
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The wrappers take CUDA tensors only; asking for the kernel on CPU
    tensors raises instead of falling back."""
    tab, terms = _k4_inputs(10, 4, 2, 8)
    tterms = [(_t(i, None), _t(w, torch.float64)) for i, w in terms]
    with pytest.raises(ValueError, match="CUDA"):
        ktable.weighted_select_dot(tterms, _t(tab, torch.float64),
                                   impl="cuda")
    tab, w_paths, s_paths = _k3_inputs(*K3_SHAPES["sw_upper"], N=8)
    paths = [[[(_t(i, None), _t(w, torch.float64)) for i, w in p]
              for p in ps] for ps in (w_paths, s_paths)]
    with pytest.raises(ValueError, match="CUDA"):
        ktable.spec_band_dot(*paths, _t(tab, torch.float64), 5, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ktable.spec_band_dot(*paths, _t(tab, torch.float64), 5, impl="tpu")


# ---------------------------------------- K4's and K3's terms, as packed
def _pack_inputs(dtype=torch.float64):
    rng = np.random.default_rng(7)
    tab = torch.tensor(rng.random((9, 5)), dtype=dtype)
    ids = torch.tensor(rng.integers(0, 9, (3, 4)))
    w = torch.tensor(rng.random((3, 4)), dtype=dtype)
    return tab, ids, w


def _pack(form, terms, tab):
    """``terms`` packed by K4's :func:`pack_terms`, or by K3's
    :func:`pack_spec_terms` as one path of one base pair and the rest
    stencil pairs (the struct's order is the terms' either way)."""
    if form == "K4":
        return ktable_cuda.pack_terms(terms, tab)
    struct, keep, lead, shape = ktable_cuda.pack_spec_terms(
        [terms[:1]], [terms[1:]], tab)
    assert shape == (1, 1, len(terms) - 1)
    return struct, keep, lead


FORMS = ["K4", "K3"]


@pytest.mark.parametrize("form", FORMS)
def test_pack_terms_none_weight_is_a_null_pointer(form):
    tab, ids, w = _pack_inputs()
    struct, keep, lead = _pack(form, [(ids, None), (ids, w)], tab)
    assert lead == (3, 4)
    assert struct.n_terms == 2
    assert struct.w[0] is None  # ctypes reads a null pointer as None
    assert struct.w[1] == w.data_ptr()
    assert all(struct.ids[k] is None for k in range(2, ktable_cuda.MAX_TERMS))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_pack_terms_takes_ids_as_they_are(id_dtype, form):
    """int32 and int64 ids go to the kernel without a cast or a copy; a bit
    per term tells the kernel their width."""
    tab, ids, w = _pack_inputs(torch.float32)
    ids = ids.to(id_dtype)
    w = w.float()
    struct, keep, _ = _pack(form, [(ids, w), (ids + 1, w)], tab)
    assert struct.ids[0] == ids.data_ptr()
    assert struct.w[0] == struct.w[1] == w.data_ptr()
    assert struct.ids64 == (0b11 if id_dtype == torch.int64 else 0)
    assert any(x.data_ptr() == struct.ids[1] for x in keep)


@pytest.mark.parametrize("form", FORMS)
def test_pack_terms_copies_only_a_broadcast_or_strided_term(form):
    tab, ids, w = _pack_inputs()
    row = ids[:1]  # [1, 4], broadcast over the 3 rows of the lead
    strided = w.T.contiguous().T  # [3, 4], not contiguous
    struct, keep, lead = _pack(form, [(ids, w), (row, strided)], tab)
    assert lead == (3, 4)
    assert struct.ids[0] == ids.data_ptr() and struct.w[0] == w.data_ptr()
    copies = {x.data_ptr(): x for x in keep}
    got_row = copies[struct.ids[1]]
    assert got_row.is_contiguous() and got_row.shape == (3, 4)
    assert torch.equal(got_row, row.expand(3, 4))
    got_w = copies[struct.w[1]]
    assert struct.w[1] != strided.data_ptr() and got_w.is_contiguous()
    assert torch.equal(got_w, strided)


@pytest.mark.parametrize("form", FORMS)
def test_pack_terms_refuses_other_dtypes(form):
    tab, ids, w = _pack_inputs()
    with pytest.raises(TypeError, match="weight of term 0"):
        _pack(form, [(ids, w.float()), (ids, w)], tab)
    with pytest.raises(TypeError, match="ids of term 1"):
        _pack(form, [(ids, w), (ids.double(), w)], tab)


@pytest.mark.parametrize("form", FORMS)
def test_pack_terms_refuses_another_device(form):
    """A term on another device than the table is refused (the "meta"
    device stands in for a card here)."""
    tab, ids, w = _pack_inputs()
    with pytest.raises(ValueError, match="ids of term 1 is on meta"):
        _pack(form, [(ids, w), (ids.to("meta"), w)], tab)
    with pytest.raises(ValueError, match="weight of term 0 is on meta"):
        _pack(form, [(ids, w.to("meta")), (ids, w)], tab)


@pytest.mark.parametrize("K", [0, ktable_cuda.MAX_TERMS + 1])
def test_pack_terms_refuses_a_count_of_terms(K):
    tab, ids, w = _pack_inputs()
    with pytest.raises(ValueError, match="terms"):
        ktable_cuda.pack_terms([(ids, w)] * K, tab)
    if K:  # the dispatcher's kernel path refuses it too
        with pytest.raises(ValueError):
            ktable.weighted_select_dot([(ids, w)] * K, tab, impl="cuda")


@pytest.mark.parametrize("paths,match", [
    ((2, 4, 5), "terms"),           # 18 terms
    ((1, 5, 1), "base pairs"),      # kw > MAX_BASE
    ((0, 1, 1), "same number"),     # no path
    ("uneven", "same number"),      # paths of different widths
])
def test_pack_spec_terms_refuses_its_paths(paths, match):
    """K3 takes 1 to ``MAX_TERMS`` pairs in all, at most ``MAX_BASE`` base
    pairs a path, and every path alike."""
    tab, ids, w = _pack_inputs()
    if paths == "uneven":
        w_paths = [[(ids, w)], [(ids, w), (ids, w)]]
        s_paths = [[(ids, w)], [(ids, w)]]
    else:
        n_paths, kw, st = paths
        w_paths = [[(ids, w)] * kw for _ in range(n_paths)]
        s_paths = [[(ids, w)] * st for _ in range(n_paths)]
    with pytest.raises(ValueError, match=match):
        ktable_cuda.pack_spec_terms(w_paths, s_paths, tab)
    # the dispatcher's kernel path refuses them too
    with pytest.raises(ValueError):
        ktable.spec_band_dot(w_paths, s_paths, tab, 1, impl="cuda")


@pytest.mark.parametrize("form", FORMS)
def test_pack_terms_allows_sixteen_terms(form):
    tab, ids, w = _pack_inputs()
    terms = [(ids + k, None if k % 3 else w) for k in range(16)]
    struct, _, _ = _pack(form, terms, tab)
    assert struct.n_terms == 16 and struct.ids64 == (1 << 16) - 1
    assert [struct.w[k] is None for k in range(16)] == [
        bool(k % 3) for k in range(16)]


# ---------------------------------------------------------------- the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("on", [False, True])
def test_check_ranges_sees_ids_as_the_caller_passed_them(monkeypatch, on):
    """``CHECK_RANGES`` checks each id tensor as given: a lerp of the LW
    optics passes ``index + 1`` past a table's last row for the kernel to
    clamp, and with the switch on that raises."""
    monkeypatch.setattr(ktable_cuda, "CHECK_RANGES", on)
    index = torch.tensor([[0, 8], [9, 3]])  # rows of a 10-row table
    ktable_cuda._check_range("weighted_select_dot", "ids", index, 10)
    if on:
        with pytest.raises(IndexError, match=r"\[1, 10\]"):
            ktable_cuda._check_range("weighted_select_dot", "ids",
                                     index + 1, 10)
    else:
        ktable_cuda._check_range("weighted_select_dot", "ids", index + 1, 10)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_weighted_select_kernel_matches_plain_on_card(dtype):
    """K4 on the card against the plain version on the same CUDA inputs,
    at the reference test's shapes and at a C48 selfref_all call."""
    dev = _cuda()
    tdt = TORCH[dtype]
    for shape in K4_SHAPES + [(10, 140, 2, 13824 * 32)]:
        tab, terms = _k4_inputs(*shape)
        tterms = [(_t(i, None, dev), _t(w, tdt, dev)) for i, w in terms]
        before = ktable_cuda.SELECT_LAUNCHES
        got = ktable.weighted_select_dot(tterms, _t(tab, tdt, dev))
        torch.cuda.synchronize()
        assert ktable_cuda.SELECT_LAUNCHES == before + 1
        want = ktable.weighted_select_dot(tterms, _t(tab, tdt, dev),
                                          impl="torch")
        err = (got - want).abs().max().item()
        assert err <= RTOL[dtype] * want.abs().max().item(), (shape, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spec_band_kernel_matches_plain_on_card(dtype):
    """K3 on the card against the plain version, at both band shapes."""
    dev = _cuda()
    tdt = TORCH[dtype]
    for case, shape in sorted(K3_SHAPES.items()):
        tab, w_paths, s_paths = _k3_inputs(*shape, N=13824 * 32)
        paths = [[[(_t(i, None, dev), _t(w, tdt, dev)) for i, w in p]
                  for p in ps] for ps in (w_paths, s_paths)]
        before = ktable_cuda.SPEC_LAUNCHES
        got = ktable.spec_band_dot(*paths, _t(tab, tdt, dev), shape[2])
        torch.cuda.synchronize()
        assert ktable_cuda.SPEC_LAUNCHES == before + 1
        want = ktable.spec_band_dot(*paths, _t(tab, tdt, dev), shape[2],
                                    impl="torch")
        err = (got - want).abs().max().item()
        assert err <= RTOL[dtype] * want.abs().max().item(), (case, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_weighted_select_kernel_takes_every_term_form_on_card(dtype):
    """K4 over K in {1, 2, 3, 4, 16} and G in {1, 7, 16, 54, 140}, int32
    and int64 ids (mixed in one call), None weights, a broadcast id term,
    N off any multiple of the tile, out-of-range ids, and N = 0."""
    dev = _cuda()
    tdt = TORCH[dtype]
    rng = np.random.default_rng(11)
    N = 20011
    for K in (1, 2, 3, 4, 16):
        for G in (1, 7, 16, 54, 140):
            R = 13
            tab = torch.tensor(rng.standard_normal((R, G)), dtype=tdt,
                               device=dev)
            terms = []
            for k in range(K):
                ids = torch.tensor(rng.integers(-2, R + 2, N), device=dev,
                                   dtype=torch.int64 if k % 2 else
                                   torch.int32)
                w = (None if k % 3 == 0 else
                     torch.tensor(rng.random(N), dtype=tdt, device=dev))
                terms.append((ids, w))
            if K > 1:
                terms[1] = (terms[1][0][:1], terms[1][1])  # broadcast
            before = ktable_cuda.SELECT_LAUNCHES
            got = ktable.weighted_select_dot(terms, tab)
            torch.cuda.synchronize()
            assert ktable_cuda.SELECT_LAUNCHES == before + 1
            want = ktable.weighted_select_dot(terms, tab, impl="torch")
            assert got.shape == want.shape == (N, G)
            err = (got - want).abs().max().item()
            assert err <= RTOL[dtype] * want.abs().max().item(), (K, G, err)
    empty = [(torch.zeros(0, dtype=torch.int64, device=dev), None)]
    before = ktable_cuda.SELECT_LAUNCHES
    out = ktable.weighted_select_dot(empty, tab)
    assert out.shape == (0, G) and ktable_cuda.SELECT_LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernels_clamp_ids_and_check_ranges_on_card(dtype):
    """Out-of-range ids read the edge rows, as in the plain versions; with
    ``CHECK_RANGES`` on, the wrappers refuse them instead."""
    dev = _cuda()
    tdt = TORCH[dtype]
    tab = torch.arange(30.0, dtype=tdt, device=dev).reshape(10, 3)
    ids = torch.tensor([[-3, 0, 9, 12]], dtype=torch.int32, device=dev)
    w = torch.ones(1, 4, dtype=tdt, device=dev)
    for term in ((ids[0], w[0]), (ids[0].long(), None)):
        got = ktable_cuda.weighted_select_dot_cuda([term], tab)
        torch.testing.assert_close(got, tab[torch.tensor([0, 0, 9, 9])],
                                   rtol=0, atol=0)
    flat = tab.reshape(5, 6)  # nbase 5, nspa 2, ng 3
    sids = torch.tensor([[5, -1, 1, 0]], dtype=torch.int32, device=dev)
    got = ktable_cuda.spec_band_dot_cuda([[(ids[0], w[0])]],
                                         [[(sids[0].long(), None)]], flat, 2)
    want = flat.reshape(5, 2, 3)[torch.tensor([0, 0, 4, 4]),
                                 torch.tensor([1, 0, 1, 0])]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ktable_cuda.CHECK_RANGES = True
    try:
        with pytest.raises(IndexError):
            ktable_cuda.weighted_select_dot_cuda([(ids[0], w[0])], tab)
        with pytest.raises(IndexError):
            ktable_cuda.spec_band_dot_cuda([[(ids[0].clamp(0, 4), w[0])]],
                                           [[(sids[0], w[0])]], flat, 2)
    finally:
        ktable_cuda.CHECK_RANGES = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spec_band_kernel_takes_every_term_form_on_card(dtype):
    """K3 over the shapes of the emulation's cases at 20,011 points: int32
    and int64 ids (mixed in one call, out of range too), None weights, a
    broadcast term, two outputs a thread and one (an odd ng, a table one
    value past an aligned address), and N = 0."""
    dev = _cuda()
    tdt = TORCH[dtype]
    rng = np.random.default_rng(13)
    N = 20011
    for n_paths, kw, st, nbase, nspa, ng, offset in [
            (2, 2, 3, 70, 9, 16, 0), (2, 2, 2, 236, 5, 16, 0),
            (1, 4, 2, 236, 5, 12, 0), (1, 4, 2, 70, 9, 2, 0),
            (3, 1, 1, 10, 3, 5, 0), (2, 2, 3, 70, 9, 16, 1)]:
        buf = torch.tensor(rng.random(offset + nbase * nspa * ng),
                           dtype=tdt, device=dev)
        tab = buf[offset:].view(nbase, nspa * ng)

        def pairs(hi, n, k0):
            return [(torch.tensor(rng.integers(-2, hi + 2, N), device=dev,
                                  dtype=torch.int64 if k % 2 else
                                  torch.int32),
                     None if k % 5 == 1 else
                     torch.tensor(rng.random(N), dtype=tdt, device=dev))
                    for k in range(k0, k0 + n)]

        w_paths = [pairs(nbase, kw, p * kw) for p in range(n_paths)]
        s_paths = [pairs(nspa, st, 7 + p * st) for p in range(n_paths)]
        w_paths[0][0] = (w_paths[0][0][0][:1], w_paths[0][0][1])
        before = ktable_cuda.SPEC_LAUNCHES
        got = ktable.spec_band_dot(w_paths, s_paths, tab, nspa)
        torch.cuda.synchronize()
        assert ktable_cuda.SPEC_LAUNCHES == before + 1
        want = ktable.spec_band_dot(w_paths, s_paths, tab, nspa,
                                    impl="torch")
        assert got.shape == want.shape == (N, ng)
        err = (got - want).abs().max().item()
        assert err <= RTOL[dtype] * want.abs().max().item(), (nbase, ng, err)
    empty = [[(torch.zeros(0, dtype=torch.int64, device=dev), None)]]
    before = ktable_cuda.SPEC_LAUNCHES
    out = ktable.spec_band_dot(empty, empty, tab, nspa)
    assert out.shape == (0, ng) and ktable_cuda.SPEC_LAUNCHES == before
