"""The grouped block average (``ops.coarsen.weighted_block_average_many``)
on the CPU, and the pipelines that call it: a group's averages equal the
per-variable plain calls, and the restart, sfc_data, surface-shard and
diagnostics coarsenings, with K5's wrapper replaced by its plain version
that counts launches, make one launch per group of variables that share a
weight and still match fv3net_tpu to the tolerances of
``test_torch_offline_pipelines.py`` and ``test_torch_coarsen.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_offline_pipelines import (  # noqa: F401  (the fixture)
    DTYPES,
    NPX,
    RTOL,
    _sfc_fields,
    _state_fields,
    _write_shards,
    assert_close,
    seeded_state,
)
from torch_port_util import jax_state

from fv3net_torch.core import netcdfio as tnc
from fv3net_torch.core import zarrio as tz
from fv3net_torch.core.dataset import Dataset as TDataset
from fv3net_torch.core.quantity import Quantity as TQuantity
from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.grid.geometry import make_grid
from fv3net_torch.ops import coarsen as tc
from fv3net_torch.ops import coarsen_cuda
from fv3net_torch.pipelines import coarsen_diagnostics as tcd
from fv3net_torch.pipelines import coarsen_restarts as tcr
from fv3net_torch.pipelines import coarsen_surface as tcs


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_many_on_cpu_equals_per_variable_plain_calls(dtype):
    """Three variables of other leading shapes under one weight, a block
    of zero weights among them: the group gives, in order, each
    variable's plain block average, NaN where its weights are 0; a group
    of one is ``weighted_block_average``."""
    rng = np.random.default_rng(5)
    w = torch.tensor(rng.random((2, 1, 8, 8)) + 0.1, dtype=dtype)
    w[1, 0, :4, 4:] = 0.0
    xs = [torch.tensor(rng.standard_normal(s), dtype=dtype)
          for s in ((2, 3, 8, 8), (2, 1, 8, 8), (4, 2, 5, 8, 8))]
    for impl in (None, "torch"):
        got = tc.weighted_block_average_many(xs, w, 4, impl=impl)
        assert len(got) == 3
        for x, g in zip(xs, got):
            _same(g, tc.weighted_block_average_plain(x, w, 4))
            _same(g, tc.weighted_block_average(x, w, 4))
            assert torch.isnan(g).any()
    assert tc.weighted_block_average_many([], w, 4) == []
    with pytest.raises(ValueError, match="impl"):
        tc.weighted_block_average_many(xs, w, 4, impl="tpu")
    with pytest.raises(ValueError, match="CUDA"):
        tc.weighted_block_average_many(xs, w, 4, impl="cuda")


@pytest.fixture
def launches(monkeypatch):
    """K5's grouped dispatcher sent to the kernel's wrapper on CPU
    tensors, and the wrapper replaced by the plain version; returns the
    list of the groups' sizes, one entry a launch."""
    sizes = []

    def plain_many(xs, w, factor):
        sizes.append(len(xs))
        return tc.weighted_block_average_many_plain(xs, w, factor)

    monkeypatch.setattr(coarsen_cuda, "weighted_block_average_many_cuda",
                        plain_many)
    orig = tc.weighted_block_average_many

    def forced(xs, w, factor, impl=None):
        return orig(xs, w, factor, impl="cuda" if impl is None else impl)

    monkeypatch.setattr(tc, "weighted_block_average_many", forced)
    monkeypatch.setattr(tcd, "weighted_block_average_many", forced)
    return sizes


@pytest.mark.parametrize("method,factor", [("sigma", 2), ("pressure", 4),
                                           ("blended", 2)])
def test_regrouped_restart_coarsening_matches_reference(
        seeded_state, launches, method, factor):  # noqa: F811
    """Through the grouped launch, float64: the sigma, pressure and
    blended coarsenings within 1e-12 of fv3net_tpu's; pt, the tracers
    and the winds go in one launch."""
    from fv3net_tpu.pipelines import coarsen_restarts as jcr

    st, area = seeded_state
    tdt, jdt = DTYPES["float64"]
    fn = f"coarsen_state_{'on_' if method != 'blended' else ''}{method}"
    got = getattr(tcr, fn)(state_from_numpy(st, tdt),
                           torch.tensor(area, dtype=tdt), factor)
    nt = len(st["tracers"])
    groups = {"sigma": [1, nt + 4, 1], "pressure": [1, nt + 4, 1, 1]}
    groups["blended"] = groups["pressure"] + groups["sigma"] + [1]
    assert sorted(launches) == sorted(groups[method])
    want = getattr(jcr, fn)(jax_state(st, jdt), jnp.asarray(area, jdt),
                            factor)
    g, w = _state_fields(got), _state_fields(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert_close(g[k], w[k], RTOL["float64"], f"{method} {k}")


def test_regrouped_sfc_data_matches_reference(launches):
    """coarsen_sfc_data_complex through the grouped launch, float64: the
    area-weighted fields (tsea, t2m and a field without a rule) in one
    launch, sheleg and hice (their own weights) in one each; every field
    within 1e-12 of fv3net_tpu's."""
    import jax

    from fv3net_tpu.pipelines import coarsen_restarts as jcr

    fields = _sfc_fields()
    area = make_grid(NPX).area
    tdt, jdt = DTYPES["float64"]
    got = tcr.coarsen_sfc_data_complex(
        {k: torch.tensor(v, dtype=tdt) for k, v in fields.items()},
        torch.tensor(area, dtype=tdt), 2)
    assert sorted(launches) == [1, 1, 3]
    want = jax.jit(jcr.coarsen_sfc_data_complex, static_argnums=2)(
        {k: jnp.asarray(v, jdt) for k, v in fields.items()},
        jnp.asarray(area, jdt), 2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], RTOL["float64"], k)


def test_regrouped_surface_shards_match_reference(tmp_path, launches):
    """coarsen_surface through the grouped launch: one launch a shard
    for its two variables; the files equal fv3net_tpu's."""
    from fv3net_tpu.core import netcdfio as jnc
    from fv3net_tpu.pipelines import coarsen_surface as jcs

    src = tmp_path / "in"
    src.mkdir()
    _write_shards(str(src))
    got = tcs.coarsen_surface(str(src), str(tmp_path / "torch"),
                              coarsening=2, max_workers=3, device="cpu")
    assert [r.ok for r in got] == [True] * 6
    assert launches == [2] * 24  # 6 tiles x 4 shards
    jcs.coarsen_surface(str(src), str(tmp_path / "jax"), coarsening=2,
                        max_workers=3)
    for t in range(1, 7):
        for v in ("PRATEsfc", "TMP2m"):
            f = f"{v}.tile{t}.nc"
            a = tnc.open_netcdf(str(tmp_path / "torch" / "C4" / f))
            b = jnc.open_netcdf(str(tmp_path / "jax" / "C4" / f))
            assert_close(a[v].values, b[v].values, 0.0, f)


def test_regrouped_diagnostics_match_reference(tmp_path, launches):
    """coarsen_diagnostics through the grouped launch: one launch a time
    index and weight shape (a 2-D and two 3-D variables: 2 a time); the
    store within 1e-6 of fv3net_tpu's."""
    from fv3net_tpu.core import zarrio as jz
    from fv3net_tpu.pipelines import coarsen_diagnostics as jpipe

    rng = np.random.default_rng(9)
    nt, n = 2, 16
    ds = TDataset({
        "PRATEsfc": TQuantity(rng.random((nt, 6, n, n)).astype(np.float32),
                              ("time", "tile", "y", "x")),
        "air_temperature": TQuantity(
            (250 + 30 * rng.random((nt, 6, 3, n, n))).astype(np.float32),
            ("time", "tile", "z", "y", "x")),
        "specific_humidity": TQuantity(
            1e-2 * rng.random((nt, 6, 3, n, n)).astype(np.float32),
            ("time", "tile", "z", "y", "x")),
    }, coords={"time": np.arange(nt, dtype=np.int64)})
    src = str(tmp_path / "fine.zarr")
    tz.to_zarr(ds, src, chunks={"time": 1})
    tcd.coarsen_diagnostics(src, str(tmp_path / "port.zarr"), 2,
                            device="cpu")
    assert sorted(launches) == [1, 1, 2, 2]
    jpipe.coarsen_diagnostics(src, str(tmp_path / "ref.zarr"), 2)
    got = tz.open_zarr(str(tmp_path / "port.zarr"))
    want = jz.open_zarr(str(tmp_path / "ref.zarr"))
    assert sorted(got) == sorted(want) == sorted(ds)
    for name in want:
        assert got[name].dims == tuple(want[name].dims)
        np.testing.assert_allclose(got[name].values, want[name].values,
                                   rtol=1e-6)
