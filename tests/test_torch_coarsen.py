"""fv3net_torch's block coarsening (``ops/coarsen.py``, the K5 kernel's
plain version), its zarr store and the ``coarsen_diagnostics`` pipeline
held against fv3net_tpu's on shared numpy inputs, and the CUDA kernel
against its plain version on the card.

On a machine without jax (the card's), only the card tests run:
``python -m pytest --noconftest tests/test_torch_coarsen.py -m gpu``.
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

from fv3net_torch.core import zarrio as tz
from fv3net_torch.core.dataset import Dataset as TDataset
from fv3net_torch.core.quantity import Quantity as TQuantity
from fv3net_torch.ops import coarsen as tc
from fv3net_torch.ops import coarsen_cuda
from fv3net_torch.pipelines import coarsen_diagnostics as tpipe

F64_RTOL = 1e-12  # sums of the same values in another order
F32_RTOL = 2e-6   # the reference's own bound (tests/test_pallas_kernels.py)


def _need_jax():
    if jax is None:
        pytest.skip("needs jax (the reference package)")


def _field(shape=(2, 3, 12, 8), seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _categories(shape=(2, 12, 8), seed=1):
    return np.random.default_rng(seed).integers(0, 4, shape).astype(np.float64)


# name -> (inputs, call on a package's module and array constructor, exact)
def _cases():
    x = _field()
    w = np.abs(_field(seed=2)) + 0.1
    cat = _categories()
    mask = np.random.default_rng(3).random(cat.shape) > 0.3
    edge = _field((2, 12, 9), seed=4)
    return {
        "block_sum": (lambda m, a: m.block_sum(a(x), 2), False),
        "block_mean": (lambda m, a: m.block_mean(a(x), 4), False),
        "block_min": (lambda m, a: m.block_min(a(x), 2), True),
        "block_max": (lambda m, a: m.block_max(a(x), 2), True),
        "block_median": (lambda m, a: m.block_median(a(x), 2), True),
        "block_median_odd": (lambda m, a: m.block_median(a(_field((9, 9))), 3),
                             True),
        "block_mode": (lambda m, a: m.block_mode(a(cat), 2), True),
        "block_mode_where": (lambda m, a: m.block_mode(a(cat), 4,
                                                       where=a(mask)), True),
        "weighted_block_average": (
            lambda m, a: m.weighted_block_average(a(x), a(w), 2), False),
        "weighted_block_average_broadcast": (
            lambda m, a: m.weighted_block_average(a(x), a(w[:, :1]), 4),
            False),
        "edge_weighted_block_average_x": (
            lambda m, a: m.edge_weighted_block_average(a(x), a(w), 2, "x"),
            False),
        "edge_weighted_block_average_y": (
            lambda m, a: m.edge_weighted_block_average(a(x), a(w[0, 0]), 4,
                                                       "y"), False),
        "block_edge_sum_x": (lambda m, a: m.block_edge_sum(a(x), 2, "x"),
                             False),
        "block_edge_sum_y": (lambda m, a: m.block_edge_sum(a(x), 4, "y"),
                             False),
        "block_upsample": (lambda m, a: m.block_upsample(a(x), 3), True),
        "block_coarsen_max": (lambda m, a: m.block_coarsen(a(x), 2, "max"),
                              True),
        "block_coarsen_mode": (lambda m, a: m.block_coarsen(a(cat), 2, "mode"),
                               True),
        "shift_edge_var_to_center": (
            lambda m, a: m.shift_edge_var_to_center(a(edge)), False),
        "shift_edge_var_to_center_y": (
            lambda m, a: m.shift_edge_var_to_center(a(edge), axis=-2), False),
        "horizontal_block_reduce": (
            lambda m, a: m.horizontal_block_reduce(a(x), 2), False),
        "xarray_block_reduce": (lambda m, a: m.xarray_block_reduce(a(x), 4),
                                False),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_coarsen_function_matches_reference(name):
    """Every function of ``ops/coarsen.py`` against the reference's on the
    same float64 inputs."""
    _need_jax()
    from fv3net_tpu.ops import coarsen as jc

    call, exact = _cases()[name]
    got = call(tc, torch.tensor).numpy()
    want = np.asarray(call(jc, jnp.asarray))
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        err = np.abs(got - want).max()
        assert err <= F64_RTOL * np.abs(want).max(), err


def test_coarsen_errors_and_coords():
    x = torch.zeros(2, 6, 6)
    with pytest.raises(ValueError, match="divisible"):
        tc.block_sum(x, 4)
    with pytest.raises(ValueError, match="edge"):
        tc.block_edge_sum(x, 2, "z")
    with pytest.raises(ValueError, match="unknown coarsening method"):
        tc.block_coarsen(x, 2, "range")
    with pytest.raises(ValueError, match="impl"):
        tc.weighted_block_average(x, x, 2, impl="tpu")
    np.testing.assert_array_equal(tc.coarsen_coords(8, 48), np.arange(1, 7))
    with pytest.raises(ValueError):
        tc.coarsen_coords(5, 48)


@pytest.mark.parametrize("factor,shape", [
    (8, (2, 128, 1024)),
    (4, (1, 32, 512)),
    (2, (6, 12, 12)),  # the shape the TPU kernel hands to its XLA form
])
def test_weighted_block_average_matches_pallas_interpret(factor, shape):
    """The plain version of K5 (and the dispatcher on CPU tensors) against
    the reference's Pallas kernel in interpret mode, float32."""
    _need_jax()
    from fv3net_tpu.ops.pallas_kernels import weighted_block_average_pallas

    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    w = rng.rand(*shape).astype(np.float32)
    want = np.asarray(weighted_block_average_pallas(
        jnp.asarray(x), jnp.asarray(w), factor, interpret=True))
    got = tc.weighted_block_average(torch.tensor(x), torch.tensor(w), factor)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL)
    plain = tc.weighted_block_average_plain(torch.tensor(x), torch.tensor(w),
                                            factor)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("lead,w_lead,want", [
    ((6, 79), (), (1, 1)),
    ((6, 79), (6, 1), (79, 6)),
    ((6, 79), (1, 79), (1, 79)),
    ((6, 79), (6, 79), (1, 474)),
    ((474,), (), (1, 1)),
    ((2, 6, 79), (6, 1), (79, 6)),
    ((2, 6, 79), (2, 1, 79), None),
    ((), (), (1, 1)),
])
def test_weight_batches(lead, w_lead, want):
    """The (div, mod) form of a broadcast weight indexes the plane that
    broadcasting would."""
    assert coarsen_cuda.weight_batches(lead, w_lead) == want
    if want is not None:
        div, mod = want
        planes = np.arange(int(np.prod(w_lead, dtype=int))).reshape(w_lead)
        full = np.broadcast_to(planes, lead).reshape(-1)
        b = np.arange(full.size)
        np.testing.assert_array_equal((b // div) % mod, full)


def test_weight_batches_refuses_other_shapes():
    with pytest.raises(ValueError, match="broadcast"):
        coarsen_cuda.weight_batches((6, 79), (5, 1))
    with pytest.raises(ValueError, match="more axes"):
        coarsen_cuda.weight_batches((6,), (6, 6))


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.ones(2, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tc.weighted_block_average(x, x, 2, impl="cuda")


# ---------------------------------------------------------------- zarr store
def _dataset(cls_q, cls_d, n=16, nt=2, nz=3, seed=0):
    rng = np.random.default_rng(seed)
    return cls_d(
        {
            "PRATEsfc": cls_q(
                rng.random((nt, 6, n, n)).astype(np.float32),
                ("time", "tile", "y", "x"), units="kg/m2/s"),
            "air_temperature": cls_q(
                (250 + 30 * rng.random((nt, 6, nz, n, n))).astype(np.float32),
                ("time", "tile", "z", "y", "x"), units="K"),
            "area_mean": cls_q(rng.random(nt), ("time",)),
        },
        coords={"time": np.arange(nt, dtype=np.int64)},
        attrs={"source": "seeded"},
    )


def _assert_datasets_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].dims) == tuple(want[name].dims), name
        assert got[name].units == want[name].units, name
        np.testing.assert_array_equal(got[name].values, want[name].values)
    assert sorted(got.coords) == sorted(want.coords)
    for name in want.coords:
        np.testing.assert_array_equal(got.coords[name], want.coords[name])
    assert got.attrs == want.attrs


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_zarr_store_round_trips_between_packages(tmp_path, writer, compress):
    """A store written by either package is read back equal by the other
    (and by itself), chunked along time, with and without zlib."""
    _need_jax()
    from fv3net_tpu.core import zarrio as jz
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    path = str(tmp_path / "store.zarr")
    if writer == "port":
        ds = _dataset(TQuantity, TDataset)
        tz.to_zarr(ds, path, chunks={"time": 1}, compress=compress)
    else:
        ds = _dataset(JQuantity, JDataset)
        jz.to_zarr(ds, path, chunks={"time": 1}, compress=compress)
    _assert_datasets_equal(tz.open_zarr(path), ds)
    _assert_datasets_equal(jz.open_zarr(path), ds)


def test_zarr_array_region_writes_and_resize(tmp_path):
    """Partial-chunk region writes, fill values and appends along time."""
    arr = tz.ZarrArray.create(str(tmp_path / "a"), shape=(0, 5), dtype="<f4",
                              chunks=(2, 3), dims=("time", "x"),
                              fill_value=np.nan)
    arr.resize_time(3)
    arr[(1,)] = np.arange(5)
    arr[2, 1:4] = 7.0
    got = tz.ZarrArray(str(tmp_path / "a")).read()
    want = np.full((3, 5), np.nan, np.float32)
    want[1] = np.arange(5)
    want[2, 1:4] = 7.0
    np.testing.assert_array_equal(got, want)
    assert arr.dims == ("time", "x")
    with pytest.raises(ValueError, match="contiguous"):
        arr[0, ::2] = 1.0


def test_quantity_holds_tensors_and_arrays():
    """``Quantity`` on a tensor and on an array: named indexing,
    dim-aligned arithmetic, reductions and ``values``."""
    data = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    for wrap in (np.asarray, torch.tensor):
        q = TQuantity(wrap(data), ("tile", "y", "x"), units="K")
        assert q.sizes == {"tile": 2, "y": 3, "x": 4}
        assert q.attrs["units"] == "K"
        np.testing.assert_array_equal(q.isel(y=1).values, data[:, 1])
        assert q.isel(y=slice(0, 2)).dims == ("tile", "y", "x")
        np.testing.assert_array_equal(q.transpose("x", "tile", "y").values,
                                      data.transpose(2, 0, 1))
        row = TQuantity(wrap(data[0, 0]), ("x",))
        np.testing.assert_array_equal((q - row).values, data - data[0, 0])
        np.testing.assert_array_equal((2.0 * q).values, 2.0 * data)
        np.testing.assert_array_equal(q.sum(("tile", "x")).values,
                                      data.sum((0, 2)))
        assert q.mean().item() == data.mean()
        np.testing.assert_array_equal(q.max("y").values, data.max(1))
        np.testing.assert_array_equal(q.diff("x").values,
                                      np.diff(data, axis=2))
        np.testing.assert_array_equal(
            q.where(q > 5.0, 0.0).values, np.where(data > 5.0, data, 0.0))
        assert q.expand_dims("time").dims == ("time", "tile", "y", "x")
        assert type(q.copy().data) is type(q.data)
    with pytest.raises(ValueError, match="dims"):
        TQuantity(data, ("y", "x"))
    ds = TDataset({"a": TQuantity(data, ("tile", "y", "x"))})
    assert ds.isel(tile=0)["a"].shape == (3, 4)
    assert ds.dims == {"tile": 2, "y": 3, "x": 4}
    with pytest.raises(TypeError):
        TDataset({"a": data})


# ---------------------------------------------------------------- pipeline
def test_coarsen_diagnostics_matches_reference(tmp_path):
    """C16 -> C8, 2 times, a 2-D and a 3-D variable: the port's pipeline on
    the CPU against the reference's, from one seeded store; the
    area-weighted global mean of each variable is kept."""
    _need_jax()
    from fv3net_tpu.core import zarrio as jz
    from fv3net_tpu.pipelines import coarsen_diagnostics as jpipe
    from fv3net_torch.grid.geometry import make_grid

    src = str(tmp_path / "fine.zarr")
    ds = _dataset(TQuantity, TDataset)
    del ds["area_mean"]
    tz.to_zarr(ds, src, chunks={"time": 1})
    tpipe.coarsen_diagnostics(src, str(tmp_path / "port.zarr"), 2,
                              device="cpu")
    jpipe.coarsen_diagnostics(src, str(tmp_path / "ref.zarr"), 2)
    got = tz.open_zarr(str(tmp_path / "port.zarr"))
    want = jz.open_zarr(str(tmp_path / "ref.zarr"))
    assert sorted(got) == sorted(want) == ["PRATEsfc", "air_temperature"]
    fine_area, coarse_area = make_grid(16).area, make_grid(8).area
    for name in want:
        assert got[name].dims == tuple(want[name].dims)
        assert got[name].shape == want[name].shape
        assert got[name].values.dtype == np.float32
        np.testing.assert_allclose(got[name].values, want[name].values,
                                   rtol=1e-6)
        fine = ds[name].values.astype(np.float64)
        coarse = got[name].values.astype(np.float64)
        if fine.ndim == 5:
            fa, ca = fine_area[:, None], coarse_area[:, None]
        else:
            fa, ca = fine_area, coarse_area
        mean_f = (fine * fa).sum((-1, -2)) / fa.sum((-1, -2))
        mean_c = (coarse * ca).sum((-1, -2)) / ca.sum((-1, -2))
        np.testing.assert_allclose(mean_c, mean_f, rtol=2e-5)


def test_coarsen_diagnostics_cli_and_variable_choice(tmp_path):
    src = str(tmp_path / "fine.zarr")
    ds = _dataset(TQuantity, TDataset, n=8, nt=1)
    tz.to_zarr(ds, src)
    out = str(tmp_path / "out.zarr")
    assert tpipe.main([src, out, "--factor", "4", "--variables", "PRATEsfc",
                       "--device", "cpu"]) == 0
    got = tz.open_zarr(out)
    assert list(got) == ["PRATEsfc"]
    assert got["PRATEsfc"].shape == (1, 6, 2, 2)
    assert got["PRATEsfc"].dims == ("time", "tile", "y", "x")


# ---------------------------------------------------------------- the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wavg_kernel_matches_plain_on_card(dtype):
    """K5 on the card against the plain version: the C384 -> C48 shape
    with an [ny, nx] and a per-tile weight, the reference test's shapes,
    and shapes no (8, 128) tile divides."""
    dev = _cuda()
    rtol = F32_RTOL if dtype == torch.float32 else F64_RTOL
    rng = np.random.RandomState(0)
    cases = [((474, 384, 384), (384, 384), 8),
             ((6, 79, 384, 384), (6, 1, 384, 384), 8),
             ((2, 128, 1024), (2, 128, 1024), 8),
             ((1, 32, 512), (1, 32, 512), 4),
             ((6, 12, 12), (6, 12, 12), 2),
             ((3, 2, 6, 2050), (3, 1, 6, 2050), 1),
             ((2, 3, 2, 9, 15), (2, 1, 2, 9, 15), 3)]
    for shape, w_shape, factor in cases:
        x = torch.tensor(rng.rand(*shape), dtype=dtype, device=dev)
        w = torch.tensor(rng.rand(*w_shape) + 0.1, dtype=dtype, device=dev)
        before = coarsen_cuda.WAVG_LAUNCHES
        got = tc.weighted_block_average(x, w, factor)
        torch.cuda.synchronize()
        assert coarsen_cuda.WAVG_LAUNCHES == before + 1
        want = tc.weighted_block_average(x, w, factor, impl="torch")
        assert got.shape == want.shape
        err = ((got - want).abs() / want.abs()).max().item()
        assert err <= rtol, (shape, factor, err)
    with pytest.raises(ValueError, match="divisible"):
        tc.weighted_block_average(x, w, 4)
