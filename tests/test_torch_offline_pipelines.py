"""fv3net_torch's offline pipelines held against fv3net_tpu's on shared
seeded inputs: the three restart coarsenings (sigma, pressure, blended),
the complex surface coarsening, the fine-resolution budget; the
``coarsen_restarts`` CLI of each package on one Fortran-layout restart
directory, each output read by both packages; the subtile surface
coarsening, ``diagnostics_to_zarr``, ``restarts_to_zarr`` and
``post_process`` with ``regrid_zarr_to_latlon`` against the reference's
files and stores; the runner's retries and dead letters; and the host
modules copied into the port, held equal to their originals.

Float64 outputs agree within 1e-12 of each output's scale, float32
within 1e-5, with NaN at the same positions.
"""
import datetime
import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

import torch_port_util  # noqa: F401,E402  (torch threads under xdist)
from torch_port_util import jax_state, make_state_numpy  # noqa: E402

from fv3net_torch import post_process as tpost  # noqa: E402
from fv3net_torch import post_process_cli as tpost_cli  # noqa: E402
from fv3net_torch.core import netcdfio as tnc  # noqa: E402
from fv3net_torch.core import zarrio as tz  # noqa: E402
from fv3net_torch.core.dataset import Dataset as TDataset  # noqa: E402
from fv3net_torch.core.quantity import Quantity as TQuantity  # noqa: E402
from fv3net_torch.dycore.state import state_from_numpy  # noqa: E402
from fv3net_torch.grid.geometry import make_grid  # noqa: E402
from fv3net_torch.pipelines import coarsen_restarts as tcr  # noqa: E402
from fv3net_torch.pipelines import coarsen_surface as tcs  # noqa: E402
from fv3net_torch.pipelines import diagnostics_to_zarr as td2z  # noqa: E402
from fv3net_torch.pipelines import fine_res_budget as tbud  # noqa: E402
from fv3net_torch.pipelines import restarts_to_zarr as tr2z  # noqa: E402
from fv3net_torch.pipelines import runner as trun  # noqa: E402
from fv3net_torch.runtime import checkpoint as tck  # noqa: E402
from fv3net_torch.runtime.derived_state import ModelState  # noqa: E402
from fv3net_tpu import post_process as jpost  # noqa: E402
from fv3net_tpu.core import netcdfio as jnc  # noqa: E402
from fv3net_tpu.core import zarrio as jz  # noqa: E402
from fv3net_tpu.pipelines import coarsen_restarts as jcr  # noqa: E402
from fv3net_tpu.pipelines import coarsen_surface as jcs  # noqa: E402
from fv3net_tpu.pipelines import diagnostics_to_zarr as jd2z  # noqa: E402
from fv3net_tpu.pipelines import fine_res_budget as jbud  # noqa: E402
from fv3net_tpu.pipelines import restarts_to_zarr as jr2z  # noqa: E402
from fv3net_tpu.pipelines import runner as jrun  # noqa: E402
from fv3net_tpu.runtime import checkpoint as jck  # noqa: E402

RTOL = {"float64": 1e-12, "float32": 1e-5}
DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32)}
NPX, NPZ = 8, 10


def assert_close(got, want, rtol, label=""):
    """NaN at the same positions, and the other values within ``rtol`` of
    the output's scale (its largest finite magnitude)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), f"{label}: NaN positions"
    if (~nan).any():
        scale = max(np.abs(want[~nan]).max(), 1e-300)
        err = np.abs(got[~nan] - want[~nan]).max() / scale
        assert err <= rtol, f"{label}: {err} > {rtol} of scale"


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want))


def _state_fields(state):
    out = {"delp": state.delp, "pt": state.pt, "wind": state.wind,
           "phis": state.phis}
    out.update({f"tracer_{k}": v for k, v in state.tracers.items()})
    return out


@pytest.fixture(scope="module")
def seeded_state():
    """A C8 state on 10 levels whose surface pressure varies by hPa from
    cell to cell, with three tracers, and distorted cell areas."""
    st, grid, _, _ = make_state_numpy(NPX, NPZ, seed=3, moist=True)
    rng = np.random.default_rng(11)
    st["tracers"]["o3mr"] = 1e-6 * rng.random(st["delp"].shape)
    st["delp"] = st["delp"] * (1 + 0.05 * rng.standard_normal(
        st["delp"].shape[:1] + (1,) + st["delp"].shape[2:]))
    st["phis"] = 500.0 * rng.random(st["phis"].shape)
    area = grid.area * (1 + 0.3 * rng.random(grid.area.shape))
    return st, area


# ------------------------------------------------------------ restarts
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method,factor", [("sigma", 2), ("pressure", 4),
                                           ("blended", 2)])
def test_restart_coarsening_matches_reference(seeded_state, method, factor,
                                              dtype):
    st, area = seeded_state
    tdt, jdt = DTYPES[dtype]
    fn = f"coarsen_state_{'on_' if method != 'blended' else ''}{method}"
    got = getattr(tcr, fn)(state_from_numpy(st, tdt),
                           torch.tensor(area, dtype=tdt), factor)
    want = getattr(jcr, fn)(jax_state(st, jdt), jnp.asarray(area, jdt),
                            factor)
    g, w = _state_fields(got), _state_fields(want)
    assert sorted(g) == sorted(w)
    if method == "blended" and dtype == "float32":
        # the blending weights divide differences of surface pressures
        # near 1e5 Pa: the reference's own float32 weights err by ~4e-5
        # against its float64 ones, and its blended fields by ~1e-5, so
        # each float32 output is held within twice the reference's own
        # float32 error (at least 1e-5) of both of its runs
        w64 = _state_fields(jcr.coarsen_state_blended(
            jax_state(st, jnp.float64), jnp.asarray(area), factor))
        triples = {k: (g[k], w[k], w64[k]) for k in w}
        triples["weights"] = (
            tcr.compute_blending_weights(torch.tensor(st["delp"], dtype=tdt),
                                         torch.tensor(area, dtype=tdt),
                                         factor),
            jcr.compute_blending_weights(jnp.asarray(st["delp"], jdt),
                                         jnp.asarray(area, jdt), factor),
            jcr.compute_blending_weights(jnp.asarray(st["delp"]),
                                         jnp.asarray(area), factor))
        assert ((triples["weights"][0] > 0)
                & (triples["weights"][0] < 1)).any()
        for k, (x, y, z) in triples.items():
            bound = max(RTOL[dtype], 2 * _scaled_err(y, z))
            assert_close(x, y, bound, f"{method} {k} against float32")
            assert_close(x, z, bound, f"{method} {k} against float64")
        return
    for k in w:
        assert g[k].dtype == tdt
        assert_close(g[k], w[k], RTOL[dtype], f"{method} {k}")
    if method == "blended":
        b_got = tcr.compute_blending_weights(
            torch.tensor(st["delp"], dtype=tdt), torch.tensor(area,
                                                              dtype=tdt),
            factor)
        b_want = jcr.compute_blending_weights(
            jnp.asarray(st["delp"], jdt), jnp.asarray(area, jdt), factor)
        assert_close(b_got, b_want, RTOL[dtype], "blending weights")
        assert ((b_got > 0) & (b_got < 1)).any()


def test_pressure_coarsening_keeps_the_reference_nan(seeded_state):
    """A coarse level with no weight in its block (here: a block whose
    area is 0) is NaN on the pressure path, and the blend keeps it NaN,
    as in the reference."""
    st, area = seeded_state
    area = area.copy()
    area[0, :4, :4] = 0.0
    tdt, jdt = DTYPES["float64"]
    for fn, factor in (("coarsen_state_on_pressure", 4),
                       ("coarsen_state_blended", 2)):
        got = getattr(tcr, fn)(state_from_numpy(st, tdt),
                               torch.tensor(area, dtype=tdt), factor)
        want = getattr(jcr, fn)(jax_state(st, jdt), jnp.asarray(area),
                                factor)
        assert np.isnan(np.asarray(want.pt)).any()
        for k, w in _state_fields(want).items():
            assert_close(_state_fields(got)[k], w, RTOL["float64"],
                         f"{fn} {k}")


def _sfc_fields(n=NPX, seed=12):
    """GFS-named sfc_data fields with every coarsening rule's inputs,
    blocks without snow or ice (zero weights) among them."""
    rng = np.random.default_rng(seed)
    s2 = (6, n, n)

    def u(lo, hi, s=s2):
        return lo + (hi - lo) * rng.random(s)

    slmsk = rng.choice([0.0, 1.0, 2.0], s2, p=[0.5, 0.35, 0.15])
    fields = {
        "slmsk": slmsk, "vtype": rng.integers(0, 16, s2).astype(float),
        "stype": rng.integers(0, 17, s2).astype(float),
        "vfrac": np.where(rng.random(s2) > 0.3, u(0, 1), 0.0),
        "sncovr": np.where(rng.random(s2) > 0.6, u(0, 1), 0.0),
        "fice": np.where(slmsk == 2.0, u(0.2, 1), 0.0),
        "tsea": u(260, 300), "tg3": u(260, 290), "canopy": u(0, 1),
        "zorl": u(0, 100), "sheleg": u(0, 50), "hice": u(0, 3),
        "tisfc": u(250, 290), "srflag": rng.integers(0, 2, s2).astype(float),
        "slope": rng.integers(1, 9, s2).astype(float),
        "shdmin": u(0, 0.05), "t2m": u(260, 300), "unknown": u(-1, 1),
        "smc": u(0.1, 0.5, (6, 4, n, n)), "stc": u(260, 300, (6, 4, n, n)),
    }
    fields["sncovr"][0, :2, :2] = 0.0  # whole blocks without snow
    fields["fice"][1, :4, :4] = 0.0
    return fields


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sfc_data_complex_matches_reference(dtype):
    fields = _sfc_fields()
    area = make_grid(NPX).area
    tdt, jdt = DTYPES[dtype]
    got = tcr.coarsen_sfc_data_complex(
        {k: torch.tensor(v, dtype=tdt) for k, v in fields.items()},
        torch.tensor(area, dtype=tdt), 2)
    want = jax.jit(jcr.coarsen_sfc_data_complex, static_argnums=2)(
        {k: jnp.asarray(v, jdt) for k, v in fields.items()},
        jnp.asarray(area, jdt), 2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], RTOL[dtype], k)
    simple = tcr.coarsen_surface_complex(
        {"t2m": torch.tensor(fields["t2m"], dtype=tdt)},
        {"slmsk": torch.tensor(fields["slmsk"], dtype=tdt)},
        torch.tensor(area, dtype=tdt), 4)
    ref = jcr.coarsen_surface_complex(
        {"t2m": jnp.asarray(fields["t2m"], jdt)},
        {"slmsk": jnp.asarray(fields["slmsk"], jdt)}, jnp.asarray(area, jdt),
        4)
    for k in ref:
        assert_close(simple[k], ref[k], RTOL[dtype], f"complex {k}")


def test_hydrostatic_balance_matches_reference():
    rng = np.random.default_rng(13)
    T, q = 250 + 40 * rng.random((3, 8)), 1e-3 * rng.random((3, 8))
    delp = 1000 + 500 * rng.random((3, 8))
    assert_close(tcr.impose_hydrostatic_balance(*map(torch.tensor,
                                                     (T, q, delp))),
                 jcr.impose_hydrostatic_balance(*map(jnp.asarray,
                                                     (T, q, delp))),
                 RTOL["float64"], "dz")


# ------------------------------------------------------------ the budget
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fine_res_budget_matches_reference(seeded_state, dtype):
    st, area = seeded_state
    rng = np.random.default_rng(14)
    zlast = np.moveaxis(st["delp"], 1, -1)
    T0 = 250 + 40 * rng.random(zlast.shape)
    q0 = 1e-2 * rng.random(zlast.shape)
    args = [T0, T0 + rng.standard_normal(zlast.shape), q0,
            q0 * (1 + 0.1 * rng.standard_normal(zlast.shape)),
            1e-4 * rng.standard_normal(zlast.shape),
            1e-7 * rng.standard_normal(zlast.shape), zlast, area]
    tdt, jdt = DTYPES[dtype]
    got = tbud.compute_budget(*[torch.tensor(a, dtype=tdt) for a in args],
                              factor=2, time_step=900.0)
    want = jbud.compute_budget(*[jnp.asarray(a, jdt) for a in args],
                               factor=2, time_step=900.0)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], RTOL[dtype], k)


# ------------------------------------------------------------ the CLI
def _fortran_restart_dir(path, st):
    rng = np.random.default_rng(15)
    surface = {"surface_temperature": torch.tensor(
        280 + 20 * rng.random((6, NPX, NPX))),
        "land_sea_mask": torch.tensor(
            (rng.random((6, NPX, NPX)) > 0.6).astype(float)),
        "soil_temperature": torch.tensor(280 + rng.random((4, 6, NPX,
                                                           NPX)))}
    tck.save_fortran_restarts(
        ModelState(dycore=state_from_numpy(st), surface=surface),
        datetime.datetime(2016, 8, 1, 3), str(path), make_grid(NPX))


def test_coarsen_restarts_cli_matches_reference(tmp_path, seeded_state,
                                                capsys):
    st, _ = seeded_state
    src = tmp_path / "src"
    _fortran_restart_dir(src, st)
    out = {}
    for name, main, extra in (("torch", tcr.main, ["--device", "cpu"]),
                              ("jax", jcr.main, [])):
        out[name] = str(tmp_path / name)
        assert main([str(src), out[name], "--factor", "4", "--method",
                     "pressure"] + extra) == 0
    assert '"resolution": 2' in capsys.readouterr().out
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"]))
    for reader in (tck, jck):
        got, t_got = reader.load_fortran_restarts(out["torch"])
        want, t_want = reader.load_fortran_restarts(out["jax"])
        assert t_got == t_want == datetime.datetime(2016, 8, 1, 3)
        g, w = _state_fields(got.dycore), _state_fields(want.dycore)
        assert sorted(g) == sorted(w)
        for k in w:
            assert_close(g[k], w[k], 1e-5, f"{reader.__name__} {k}")
        assert sorted(got.surface) == sorted(want.surface)
        for k in want.surface:
            assert_close(got.surface[k], want.surface[k], 1e-5, k)


def test_device_taking_clis_default_to_the_card(tmp_path, monkeypatch):
    """coarsen_restarts, coarsen_surface and post-process-run-torch
    (with --latlon) take ``--device``, the card by default; on a machine
    without a card the default raises instead of falling back."""
    seen = []
    monkeypatch.setattr(tcr, "coarsen_restart_dir",
                        lambda *a, device: seen.append(device) or 4)
    monkeypatch.setattr(tcs, "coarsen_surface",
                        lambda *a, device: seen.append(device) or [])
    monkeypatch.setattr(tpost_cli, "post_process", lambda *a, **k: [])
    import fv3net_torch.pipelines as tpipelines

    real = tpipelines.resolve_device
    monkeypatch.setattr(tpipelines, "resolve_device",
                        lambda device: seen.append(device))
    assert tcr.main(["a", "b", "--factor", "2"]) == 0
    assert tcs.main(["--input-dir", "a", "--output-dir", "b"]) == 0
    assert tpost_cli.main(["a", "b", "--latlon"]) == 0
    assert seen == ["cuda"] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            real("cuda")
    assert real("cpu") == torch.device("cpu")


# ------------------------------------------------------------ surface
def _write_shards(root, n=8, sub=2, seed=16):
    """{prefix}.tile{t}.nc.{SSSS} data and grid_spec shards of C{n}, each
    tile cut into sub x sub subtiles with 1-D grid_xt/grid_yt."""
    rng = np.random.default_rng(seed)
    area = make_grid(n).area
    m = n // sub
    for t in range(6):
        for k in range(sub * sub):
            iy, ix = divmod(k, sub)
            ys, xs = slice(iy * m, (iy + 1) * m), slice(ix * m, (ix + 1) * m)
            coords = {"grid_xt": np.arange(ix * m, (ix + 1) * m) + 1.0,
                      "grid_yt": np.arange(iy * m, (iy + 1) * m) + 1.0}
            data = TDataset({
                "PRATEsfc": TQuantity(
                    rng.random((2, m, m)).astype(np.float32),
                    ("time", "grid_yt", "grid_xt"), units="kg/m2/s"),
                "TMP2m": TQuantity(
                    (270 + 20 * rng.random((2, m, m))).astype(np.float32),
                    ("time", "grid_yt", "grid_xt"), units="K"),
                "time": TQuantity(np.arange(2.0), ("t",)),
            }, coords=coords)
            tnc.write_netcdf(data, os.path.join(
                root, f"gfsphysics_15min_fine.tile{t + 1}.nc.{k:04d}"))
            tnc.write_netcdf(TDataset({"area": TQuantity(
                area[t, ys, xs], ("grid_yt", "grid_xt"))}, coords=coords),
                os.path.join(root, f"grid_spec.tile{t + 1}.nc.{k:04d}"))


def test_coarsen_surface_matches_reference(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    _write_shards(str(src))
    got = tcs.coarsen_surface(str(src), str(tmp_path / "torch"),
                              coarsening=2, max_workers=3, device="cpu")
    want = jcs.coarsen_surface(str(src), str(tmp_path / "jax"),
                               coarsening=2, max_workers=3)
    assert [r.ok for r in got] == [r.ok for r in want] == [True] * 6
    assert [r.attempts for r in got] == [1] * 6
    files = sorted(os.listdir(tmp_path / "jax" / "C4"))
    assert sorted(os.listdir(tmp_path / "torch" / "C4")) == files
    assert len(files) == 3 * 6
    for f in files:
        for reader in (tnc, jnc):
            a = reader.open_netcdf(str(tmp_path / "torch" / "C4" / f))
            b = reader.open_netcdf(str(tmp_path / "jax" / "C4" / f))
            assert list(a) == list(b) and sorted(a.coords) == sorted(
                b.coords)
            for k in b:
                assert a[k].dims == b[k].dims
                assert_close(a[k].values, b[k].values, 0.0, f"{f} {k}")
            for k in b.coords:
                np.testing.assert_array_equal(a.coords[k], b.coords[k])


# ------------------------------------------------------------ zarr stores
def _assert_stores_equal(a, b):
    for reader in (tz, jz):
        x, y = reader.open_zarr(a), reader.open_zarr(b)
        assert sorted(x) == sorted(y)
        for k in y:
            assert x[k].dims == y[k].dims
            np.testing.assert_array_equal(x[k].values, y[k].values, k)
        for k in y.coords:
            np.testing.assert_array_equal(x.coords[k], y.coords[k])


def test_diagnostics_to_zarr_matches_reference(tmp_path):
    rng = np.random.default_rng(17)
    rundir = tmp_path / "run"
    rundir.mkdir()
    for cat in ("sfc_dt_atmos", "atmos_8xdaily"):
        for t in range(6):
            tnc.write_netcdf(TDataset({
                "TMP": TQuantity(rng.random((3, 4, 4)).astype(np.float32),
                                 ("time", "grid_yt", "grid_xt"), units="K")},
                coords={"time": np.arange(3.0)}),
                str(rundir / f"{cat}.tile{t + 1}.nc"))
    got = td2z.diagnostics_to_zarr(str(rundir), str(tmp_path / "torch"))
    want = jd2z.diagnostics_to_zarr(str(rundir), str(tmp_path / "jax"))
    assert [r.ok for r in got] == [r.ok for r in want] == [True, True]
    for cat in ("sfc_dt_atmos", "atmos_8xdaily"):
        _assert_stores_equal(str(tmp_path / "torch" / f"{cat}.zarr"),
                             str(tmp_path / "jax" / f"{cat}.zarr"))
    assert td2z.main(["--rundir", str(rundir), "--diagnostic-dir",
                      str(tmp_path / "cli"), "--diagnostic-categories",
                      "nothing"]) == 1  # a failed category fails the CLI


def test_restarts_to_zarr_matches_reference(tmp_path, seeded_state):
    st, _ = seeded_state
    for i, seg in enumerate(("20160801.000000", "20160801.060000")):
        tck.save_state(ModelState(
            dycore=state_from_numpy({**st, "pt": st["pt"] + i}),
            surface={}), datetime.datetime(2016, 8, 1, 6 * i),
            str(tmp_path / "run" / "artifacts" / seg / "RESTART"))
    run = str(tmp_path / "run")
    assert tr2z.restarts_to_zarr(run, str(tmp_path / "torch.zarr")) == \
        jr2z.restarts_to_zarr(run, str(tmp_path / "jax.zarr"))
    _assert_stores_equal(str(tmp_path / "torch.zarr"),
                         str(tmp_path / "jax.zarr"))


def test_post_process_and_latlon_regrid_match_reference(tmp_path):
    rng = np.random.default_rng(18)
    rundir = tmp_path / "run"
    for i, seg in enumerate(("20160801.000000", "20160801.060000")):
        ds = TDataset({
            "PRATEsfc": TQuantity(rng.random((2, 6, 4, 4)),
                                  ("time", "tile", "y", "x")),
            "air_temperature": TQuantity(
                250 + rng.random((2, 6, 3, 4, 4)),
                ("time", "tile", "z", "y", "x")),
        }, coords={"time": np.arange(2.0) + 2 * i})
        tz.to_zarr(ds, str(rundir / "artifacts" / seg / "diags.zarr"))
    got = tpost.post_process(str(rundir), str(tmp_path / "torch"))
    want = jpost.post_process(str(rundir), str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["diags.zarr"]
    _assert_stores_equal(got[0], want[0])
    tpost.regrid_zarr_to_latlon(got[0], str(tmp_path / "t_ll.zarr"), 9, 18,
                                device="cpu")
    jpost.regrid_zarr_to_latlon(want[0], str(tmp_path / "j_ll.zarr"), 9, 18)
    for reader in (tz, jz):
        a = reader.open_zarr(str(tmp_path / "t_ll.zarr"))
        b = reader.open_zarr(str(tmp_path / "j_ll.zarr"))
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dims == b[k].dims
            assert_close(a[k].values, b[k].values, 1e-6, k)
    assert tpost_cli.main([str(rundir), str(tmp_path / "cli"), "--latlon",
                           "--device", "cpu"]) == 0
    tpost.regrid_zarr_to_latlon(got[0], str(tmp_path / "t_ll_full.zarr"),
                                device="cpu")
    _assert_stores_equal(str(tmp_path / "cli" / "diags.latlon.zarr"),
                         str(tmp_path / "t_ll_full.zarr"))


# ------------------------------------------------------------ the runner
def test_runner_retries_dead_letters_and_summary():
    calls = {}

    def transform(item):
        calls[item] = calls.get(item, 0) + 1
        if item == "bad" or (item == "flaky" and calls[item] < 2):
            raise ValueError(item)
        return item.upper()

    sunk = []
    results = trun.run_pipeline(["a", "flaky", "bad"], transform,
                                sink=lambda k, v: sunk.append((k, v)),
                                max_workers=2, num_retries=2,
                                base_delay=0.001)
    assert [(r.key, r.ok, r.attempts) for r in results] == [
        ("a", True, 1), ("flaky", True, 2), ("bad", False, 3)]
    assert results[2].error == "bad" and results[1].value == "FLAKY"
    assert sorted(sunk) == [("a", "A"), ("flaky", "FLAKY")]
    summary = trun.summarize(results)
    assert {k: summary[k] for k in ("n_items", "n_ok", "n_failed",
                                    "failed_keys")} == {
        "n_items": 3, "n_ok": 2, "n_failed": 1, "failed_keys": ["bad"]}
    wrapped = trun.with_exponential_backoff(transform, num_retries=1,
                                            base_delay=0.001)
    calls.clear()
    assert wrapped("flaky") == "FLAKY"
    with pytest.raises(ValueError):
        wrapped("bad")


# ------------------------------------------------------------ the copies
def _source(obj):
    return inspect.getsource(obj).replace("fv3net_tpu", "fv3net_torch")


def _body(module):
    src = inspect.getsource(module)
    return src[src.index("from __future__"):].replace("fv3net_tpu",
                                                      "fv3net_torch")


def test_copied_host_modules_equal_their_originals():
    """The host-only code copied into the port, held equal to the
    reference's with its package name swapped."""
    from fv3net_torch import grid as tgrid
    from fv3net_torch.core import convenience as tconv
    from fv3net_torch.grid import cross as tcross
    from fv3net_tpu import grid as jgrid
    from fv3net_tpu.core import convenience as jconv
    from fv3net_tpu.grid import cross as jcross

    for mine, ref in ((tconv, jconv), (trun, jrun), (td2z, jd2z),
                      (tr2z, jr2z)):
        assert _body(mine) == _body(ref), mine.__name__
    assert inspect.getsource(tcross) == inspect.getsource(jcross)
    assert inspect.getsource(tgrid) == _source(jgrid)
    for name in ("open_restarts_with_time_coordinates",
                 "standardize_metadata", "dump_nc", "_STANDARD_DIM_NAMES"):
        mine, ref = getattr(tnc, name), getattr(jnc, name)
        assert (mine == ref if isinstance(ref, dict)
                else _source(mine) == _source(ref)), name
    for name in ("cast_to_float32", "rechunk", "append_segment_to_store",
                 "post_process"):
        assert _source(getattr(tpost, name)) == _source(getattr(jpost,
                                                                name)), name
    assert _source(tcs.combine_subtiles) == _source(jcs.combine_subtiles)
    assert tcr.SFC_DATA_COARSENING_METHOD == jcr.SFC_DATA_COARSENING_METHOD


def test_copied_netcdf_helpers_behave_as_the_originals(tmp_path):
    from fv3net_torch.core import convenience as tconv
    from fv3net_tpu.core import convenience as jconv

    st, _ = make_state_numpy(4, 3, seed=1)[:2]
    run = tmp_path / "run"
    t = datetime.datetime(2016, 8, 1, 3)
    tck.save_fortran_restarts(ModelState(dycore=state_from_numpy(st),
                                         surface={}), t,
                              str(run / "RESTART"), make_grid(4))
    for name in os.listdir(run / "RESTART"):
        if name.endswith(".nc") and name.startswith("fv_core"):
            os.link(run / "RESTART" / name,
                    run / "RESTART" / f"20160801.060000.{name}")
    got = tnc.open_restarts_with_time_coordinates(str(run))
    want = jnc.open_restarts_with_time_coordinates(str(run))
    assert list(got) == list(want) == [t, datetime.datetime(2016, 8, 1, 6)]
    for time in want:
        assert sorted(got[time]) == sorted(want[time])
        for cat in want[time]:
            a = tnc.standardize_metadata(got[time][cat])
            b = jnc.standardize_metadata(want[time][cat])
            for k in b:
                assert a[k].dims == b[k].dims
                np.testing.assert_array_equal(a[k].values, b[k].values)
    ds = TDataset({"T": TQuantity(np.arange(6.0).reshape(2, 3), ("y", "x"))})
    with open(tmp_path / "a.nc", "wb") as f:
        tnc.dump_nc(ds, f)
    np.testing.assert_array_equal(jnc.open_netcdf(str(tmp_path / "a.nc"))[
        "T"].values, ds["T"].values)
    for fn in ("parse_timestep_str_from_path", "cast_to_datetime"):
        arg = "gs://x/20160801.003000/RESTART"
        assert getattr(tconv, fn)(arg) == getattr(jconv, fn)(arg)
