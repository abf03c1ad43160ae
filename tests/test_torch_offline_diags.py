"""fv3net_torch's offline, emulation and reservoir diagnostics held against
fv3net_tpu's on shared seeded numpy inputs: every diagnostic of the
offline registry (``diagnostics/offline/compute_diagnostics.py``), the
derived R2 / RMSE, snapshots and meridional transects, ``evaluate_cube``
and the ``offline-diags-torch`` CLI against the reference's CLI on a
dense model the reference built and saved, the stacked-sample
evaluation and its CLI, the emulation skill and drift, and the
reservoir validation rollout of pure, hybrid and subdomain models (with
and without a PCA latent space) read from the reference's artifacts.

The cube data are C12 with 8 levels and 4 times, float64, a 2-D target
NaN over land (a masked field), a 3-D target with its delp; float64
outputs agree within 1e-12 of each output's scale with NaN at the same
positions, the reservoir rollouts (float32, as the reference casts
them) within 1e-5.
"""
import importlib
import json
import os
import re

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

import torch_port_util  # noqa: F401,E402  (torch threads under xdist)

from fv3net_torch.core import zarrio as tzarr  # noqa: E402
from fv3net_torch.core.dataset import Dataset as TDataset  # noqa: E402
from fv3net_torch.core.quantity import Quantity as TQuantity  # noqa: E402
from fv3net_torch.diagnostics import emulation as temu  # noqa: E402
from fv3net_torch.diagnostics import offline as toff  # noqa: E402
from fv3net_torch.diagnostics import reservoir as tresd  # noqa: E402
from fv3net_torch.diagnostics.offline import compute as tocomp  # noqa: E402
from fv3net_torch.diagnostics.transform import (  # noqa: E402
    grid_on,
    on_device,
)
from fv3net_torch.fit import io as tio  # noqa: E402
from fv3net_torch.fit import reservoir as tres  # noqa: E402
from fv3net_tpu import fit as jfit  # noqa: E402
from fv3net_tpu.core.dataset import Dataset as JDataset  # noqa: E402
from fv3net_tpu.core.quantity import Quantity as JQuantity  # noqa: E402
from fv3net_tpu.diagnostics import emulation as jemu  # noqa: E402
from fv3net_tpu.diagnostics import offline as joff  # noqa: E402
from fv3net_tpu.diagnostics import reservoir as jresd  # noqa: E402
from fv3net_tpu.diagnostics.offline import compute as jocomp  # noqa: E402
from fv3net_tpu.fit import reservoir as jres  # noqa: E402

# the modules (their packages export a function of the same name)
tcd = importlib.import_module(
    "fv3net_torch.diagnostics.offline.compute_diagnostics")
jcd = importlib.import_module(
    "fv3net_tpu.diagnostics.offline.compute_diagnostics")

N, NZ, NT = 12, 8, 4
RTOL = 1e-12
RESERVOIR_RTOL = 1e-5
DIMS2 = ("time", "tile", "y", "x")
DIMS3 = ("time", "tile", "z", "y", "x")
DELP = "pressure_thickness_of_atmospheric_layer"
HOURS = np.arange(NT) * 3.0


def _catalog_grid():
    from fv3net_tpu import catalog

    g = catalog.get(f"grid/c{N}")
    lsm = catalog.get(f"landseamask/c{N}")
    return {"lat": np.asarray(g["lat"].data), "lon": np.asarray(g["lon"].data),
            "area": np.asarray(g["area"].data),
            "land_sea_mask": np.asarray(lsm["land_sea_mask"].data)}


def _cube(seed, lsm):
    """name -> (data, dims, units): the model's inputs, the targets and
    delp."""
    rng = np.random.RandomState(seed)
    precip = 1e-4 * rng.rand(NT, 6, N, N)
    precip[:, np.round(lsm) == 1] = np.nan  # masked over land
    return {
        "air_temperature": (250.0 + 30.0 * rng.rand(NT, 6, NZ, N, N), DIMS3,
                            "K"),
        "TMP2m": (280.0 + 20.0 * rng.rand(NT, 6, N, N), DIMS2, "K"),
        "dQ1": (1e-5 * rng.randn(NT, 6, NZ, N, N), DIMS3, "K/s"),
        "PRATEsfc": (precip, DIMS2, "kg/m^2/s"),
        DELP: (1e5 / NZ * (0.9 + 0.2 * rng.rand(NT, 6, NZ, N, N)), DIMS3,
               "Pa"),
    }


def _pair(fields, names=None):
    names = list(fields) if names is None else names
    coords = {"time": HOURS}
    return (JDataset({k: JQuantity(*fields[k]) for k in names},
                     dict(coords)),
            TDataset({k: TQuantity(*fields[k]) for k in names},
                     dict(coords)))


def _reference_dense():
    """A dense model of the reference built from seeded float32 weights
    (nothing compiles): air_temperature and TMP2m in, dQ1 and PRATEsfc
    out."""
    from fv3net_tpu.fit import dense as jdense
    from fv3net_tpu.fit.normalize import StandardScaler as JScaler
    from fv3net_tpu.fit.packer import PackingInfo as JInfo

    rng = np.random.RandomState(12)
    sizes = [NZ + 1, 16, NZ + 1]
    params = [{"w": jnp.asarray(rng.randn(a, b) / np.sqrt(a), jnp.float32),
               "b": jnp.asarray(0.1 * rng.randn(b), jnp.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]

    def scaler(mean, std):
        return JScaler(jnp.asarray(mean, jnp.float32),
                       jnp.asarray(std, jnp.float32))

    return jdense.DenseModel(
        ["air_temperature", "TMP2m"], ["dQ1", "PRATEsfc"], params,
        JInfo(["air_temperature", "TMP2m"], [NZ, 1]),
        JInfo(["dQ1", "PRATEsfc"], [NZ, 1]),
        scaler(np.r_[np.full(NZ, 265.0), 290.0],
               np.r_[np.full(NZ, 9.0), 6.0]),
        scaler(np.r_[np.zeros(NZ), 5e-5], np.r_[np.full(NZ, 1e-5), 3e-5]))


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    grid = _catalog_grid()
    tgt = _cube(0, grid["land_sea_mask"])
    pred = _cube(1, grid["land_sea_mask"])
    root = tmp_path_factory.mktemp("offline")
    jmodel = _reference_dense()
    model_path = str(root / "model")
    jfit.dump(jmodel, model_path)
    return {"grid": grid, "target": tgt, "pred": pred, "root": root,
            "jmodel": jmodel, "model_path": model_path}


def _host(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, label, rtol=RTOL):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    g, w = got.astype(np.float64), want.astype(np.float64)
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), f"{label}: NaN positions"
    inf = np.isinf(w)
    assert np.array_equal(g[inf], w[inf]), f"{label}: infinities"
    fin = ~(nan | inf)
    if fin.any():
        scale = max(np.abs(w[fin]).max(), 1e-300)
        err = np.abs(g[fin] - w[fin]).max() / scale
        assert err <= rtol, f"{label}: {err} > {rtol} of scale"


def assert_diags_equal(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dims == w.dims, k
        assert g.units == w.units, k
        # the density's edges: jnp.linspace's, up to XLA's contraction
        # of its a (1 - s) + b s
        assert {a: v for a, v in g.attrs.items() if a != "edges"} == {
            a: v for a, v in w.attrs.items() if a != "edges"}, k
        if "edges" in w.attrs:
            assert_close(np.asarray(g.attrs["edges"]),
                         np.asarray(w.attrs["edges"]), f"{k} edges")
        assert_close(g.data, w.data, k, rtol)


def _args(cube):
    names = ["TMP2m", "PRATEsfc", "dQ1"]
    jp, tp = _pair(cube["pred"], names)
    jt, tt = _pair(cube["target"], names)
    delp = cube["target"][DELP][0]
    return (jcd.DiagArg(jp, jt, cube["grid"], delp),
            tcd.DiagArg(on_device(tp, "cpu"), on_device(tt, "cpu"),
                        grid_on(cube["grid"], "cpu"), torch.tensor(delp)))


OFFLINE = list(jcd.diagnostics_registry.funcs)


def test_offline_registry_holds_the_references_diagnostics():
    assert list(tcd.diagnostics_registry.funcs) == OFFLINE
    assert tcd.diagnostics_registry is not jcd.diagnostics_registry
    assert len(OFFLINE) == 49


@pytest.mark.parametrize("name", OFFLINE)
def test_offline_diagnostic_matches_reference(cube, name):
    jarg, targ = _args(cube)
    want = jcd.diagnostics_registry.funcs[name](jarg)
    got = tcd.diagnostics_registry.funcs[name](targ)
    assert want
    assert_diags_equal(got, want)


def test_offline_diagnostics_need_delp_as_the_reference():
    """Without delp the pressure-level families fail, and are skipped, in
    both packages."""
    jarg, targ = _args({"pred": _cube(1, np.zeros((6, N, N))),
                        "target": _cube(0, np.zeros((6, N, N))),
                        "grid": _catalog_grid()})
    want = jcd.compute_diagnostics(jarg.prediction, jarg.verification,
                                   jarg.grid)
    got = tcd.compute_diagnostics(targ.prediction, targ.verification,
                                  targ.grid)
    assert not any("pressure_level" in k for k in want)
    assert_diags_equal(got, want)


def test_derived_diagnostics_match_reference(cube):
    jarg, targ = _args(cube)
    want = joff.insert_rmse(joff.insert_r2(jcd.compute_diagnostics(
        jarg.prediction, jarg.verification, jarg.grid, jarg.delp)))
    got = toff.insert_rmse(toff.insert_r2(tcd.compute_diagnostics(
        targ.prediction, targ.verification, targ.grid, targ.delp)))
    assert_diags_equal(got, want)
    assert any("_r2_" in k for k in want) and any("_rmse_" in k
                                                  for k in want)
    dw = joff.derived_registry.compute(want, allow_errors=True)
    dg = toff.derived_registry.compute(got, allow_errors=True)
    assert_diags_equal(dg, dw)


def _nearest_cells(grid, lon, n=180):
    """For each point of the transect ring, the cells at its least
    distance on the unit sphere, ties within roundoff included (a cell
    and its mirror image about the ring's meridian, the cells around a
    pole), in flat (tile, y, x) order; and the cell the port's formula
    picks (squared differences summed coordinate by coordinate, the
    first least one), evaluated here in numpy."""
    def xyz(lat, lon):
        lat, lon = np.deg2rad(lat), np.deg2rad(lon)
        return (np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                np.sin(lat))

    src = xyz(np.ravel(grid["lat"]), np.ravel(grid["lon"]))
    tgt = xyz(np.linspace(-90.0, 90.0, n), np.full(n, lon))
    d2 = None
    for a, b in zip(src, tgt):
        d = a[:, None] - b[None, :]
        d2 = d * d if d2 is None else d2 + d * d
    least = d2.min(0)
    return ([np.nonzero(d2[:, j] <= least[j] * (1 + 1e-9) + 1e-15)[0]
             for j in range(n)], np.argmin(d2, axis=0))


def assert_transects_equal(got, want, grid, lon):
    """Transect datasets: equal (to RTOL) at the ring points with one
    nearest cell; where cells tie, the reference's pick rests on its
    matmul's rounding (the port's on its own formula, the same on every
    device: test_meridional_transect_takes_a_nearest_cell)."""
    untied = np.array([len(c) == 1 for c in _nearest_cells(grid, lon)[0]])
    assert untied.sum() >= 100
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dims == want[k].dims and got[k].dims[-1] == "transect"
        assert_close(_host(got[k].data)[..., untied],
                     _host(want[k].data)[..., untied], k)


@pytest.mark.parametrize("lon", [0.0, 40.0])
def test_meridional_transect_takes_a_nearest_cell(cube, lon):
    """Each transect point takes its nearest cell's value: the port the
    cell its formula picks (so the same cell on every device), the
    reference one of the cells tied within roundoff."""
    field = np.random.RandomState(30).permutation(6 * N * N).reshape(
        1, 6, N, N).astype(np.float64)
    ds = (JDataset({"f": JQuantity(field, ("z", "tile", "y", "x"))}),
          TDataset({"f": TQuantity(torch.tensor(field),
                                   ("z", "tile", "y", "x"))}))
    want = np.asarray(joff.meridional_transect(ds[0], cube["grid"],
                                               lon=lon)["f"].data)[0]
    got = toff.meridional_transect(ds[1], grid_on(cube["grid"], "cpu"),
                                   lon=lon)["f"].data.numpy()[0]
    flat = field.reshape(-1)
    cells, picks = _nearest_cells(cube["grid"], lon)
    assert any(len(c) > 1 for c in cells)  # the poles at least
    for j, c in enumerate(cells):
        assert got[j] == flat[picks[j]] and picks[j] in c, j
        assert want[j] in flat[c], j


def test_snapshot_and_transect_match_reference(cube):
    jarg, targ = _args(cube)
    for time in (4.0, 100.0):
        sw = joff.select_snapshot(jarg.prediction, time)
        sg = toff.select_snapshot(targ.prediction, time)
        assert sg.coords == sw.coords
        assert_diags_equal(dict(sg.items()), dict(sw.items()))
    tw = joff.meridional_transect(sw, cube["grid"], lon=40.0)
    tg = toff.meridional_transect(sg, grid_on(cube["grid"], "cpu"),
                                  lon=40.0)
    assert_transects_equal(tg, tw, cube["grid"], 40.0)
    for k in ("transect_lat", "transect_lon"):
        assert np.array_equal(tg.coords[k], tw.coords[k])


def test_evaluate_cube_matches_reference(cube):
    """predict_on_cube with the reference's model, read from its artifact
    by the port, then every diagnostic, the scalars, the snapshot and
    the transect."""
    jdata, tdata = _pair(cube["target"])
    want = jocomp.evaluate_cube(cube["jmodel"], jdata, cube["grid"],
                                transect_lon=40.0)
    tmodel = tio.load(cube["model_path"])
    tmodel = toff._sample.model_on(tmodel, "cpu", torch.float64)
    got = tocomp.evaluate_cube(tmodel, on_device(tdata, "cpu"),
                               grid_on(cube["grid"], "cpu"),
                               transect_lon=40.0)
    for key in ("diagnostics", "snapshot"):
        assert_diags_equal(got[key], want[key])
    for key in ("prediction", "target"):
        assert_diags_equal(dict(got[key].items()), dict(want[key].items()))
    assert_transects_equal(got["transect"], want["transect"], cube["grid"],
                           40.0)
    assert sorted(got["scalar_metrics"]) == sorted(want["scalar_metrics"])
    for k, v in want["scalar_metrics"].items():
        assert_close(np.float64(got["scalar_metrics"][k]), np.float64(v), k)


def _items(path):
    with open(path) as f:
        text = f.read()
    return re.findall(r"<h2>.*?</h2>|<figcaption>.*?</figcaption>|"
                      r"<tr><td>.*?</td>", text)


@pytest.fixture(scope="module")
def cli_outputs(cube):
    """Both packages' offline CLI on one data config and model."""
    root = cube["root"]
    data = TDataset({k: TQuantity(*v) for k, v in cube["target"].items()},
                    {"time": HOURS})
    tzarr.to_zarr(data, str(root / "data.zarr"))
    config = str(root / "data.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"path": str(root / "data.zarr"), "grid": f"c{N}"},
                       f)
    from fv3net_torch.diagnostics.offline import views as tviews
    from fv3net_tpu.diagnostics.offline import views as jviews

    out = {}
    for label, main, extra, views in (
            ("ref", jocomp.main, [], jviews),
            ("port", tocomp.main, ["--device", "cpu"], tviews)):
        reports = []
        saved = views.create_offline_report
        # the report's drawing (a host copy, held to the original's
        # source) costs seconds a figure: its inputs are compared instead
        views.create_offline_report = lambda *a, **kw: reports.append(
            (a, kw))
        try:
            assert main([cube["model_path"], config, str(root / label),
                         "--snapshot-time", "3.5", "--transect-lon", "40"]
                        + extra) == 0
        finally:
            views.create_offline_report = saved
        out[label] = root / label
        out[f"{label} report"] = reports
    return out


def test_offline_cli_writes_the_references_files(cube, cli_outputs):
    ref, port = cli_outputs["ref"], cli_outputs["port"]
    name = jocomp.DIAGS_ZARR_NAME
    want = tzarr.open_zarr(str(ref / name))
    got = tzarr.open_zarr(str(port / name))
    assert sorted(got) == sorted(want) and want, name
    for k in want:
        assert got[k].dims == want[k].dims, k
        assert got[k].attrs == want[k].attrs, k
        assert_close(got[k].values, want[k].values, f"{name} {k}")
    assert_transects_equal(
        tzarr.open_zarr(str(port / jocomp.TRANSECT_ZARR_NAME)),
        tzarr.open_zarr(str(ref / jocomp.TRANSECT_ZARR_NAME)),
        cube["grid"], 40.0)
    with open(ref / jocomp.METRICS_JSON_NAME) as f:
        want = json.load(f)
    with open(port / tocomp.METRICS_JSON_NAME) as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert_close(np.float64(got[k]), np.float64(want[k]), k)
    with open(ref / jocomp.METADATA_JSON_NAME) as f:
        want = json.load(f)
    with open(port / tocomp.METADATA_JSON_NAME) as f:
        assert json.load(f) == want


def test_offline_cli_reports_what_the_reference_reports(cli_outputs):
    """The report is handed the reference's evaluation (host arrays)
    and Jacobians."""
    [(wargs, wkw)] = cli_outputs["ref report"]
    [(gargs, gkw)] = cli_outputs["port report"]
    want, got = wargs[0], gargs[0]
    assert gargs[1:] == (str(cli_outputs["port"]),)
    for key in ("diagnostics", "snapshot"):
        assert all(isinstance(q.data, np.ndarray) for q in got[key].values())
        assert_diags_equal(got[key], want[key])
    assert_transects_equal(got["transect"], want["transect"],
                           _catalog_grid(), 40.0)
    ws, gs = wkw["sensitivities"], gkw["sensitivities"]
    assert sorted(gs) == sorted(ws) and ws
    for k in ws:
        assert_close(gs[k], ws[k], k)


def test_offline_cli_without_matplotlib_writes_the_files(cube, cli_outputs,
                                                        monkeypatch,
                                                        tmp_path):
    """Without matplotlib (as on the card's machine) the CLI writes its
    stores and JSON files and no report; without a card its default
    device raises."""
    config = str(cube["root"] / "data.yaml")
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    out = tmp_path / "out"
    assert tocomp.main([cube["model_path"], config, str(out),
                        "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == sorted([
        tocomp.DIAGS_ZARR_NAME, tocomp.TRANSECT_ZARR_NAME,
        tocomp.METRICS_JSON_NAME, tocomp.METADATA_JSON_NAME])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tocomp.main([cube["model_path"], config, str(tmp_path / "x")])


def test_predict_on_cube_matches_reference(cube):
    jdata, tdata = _pair(cube["target"])
    want = jocomp.predict_on_cube(cube["jmodel"], jdata)
    tmodel = toff._sample.model_on(tio.load(cube["model_path"]), "cpu",
                                   torch.float64)
    got = tocomp.predict_on_cube(tmodel, on_device(tdata, "cpu"))
    assert_diags_equal(dict(got.items()), dict(want.items()))
    assert got["dQ1"].dims == DIMS3 and got["PRATEsfc"].dims == DIMS2


# --------------------------------------------------- stacked samples
@pytest.fixture(scope="module")
def batches_config(cube):
    """A zarr batches config of the cube store: a batch of columns a
    time."""
    root = cube["root"]
    data = TDataset({k: TQuantity(*v) for k, v in cube["target"].items()
                     if k != "PRATEsfc"}, {"time": HOURS})
    tzarr.to_zarr(data, str(root / "columns.zarr"))
    config = str(root / "batches.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"kind": "zarr", "path": str(root / "columns.zarr"),
                        "variables": ["air_temperature", "TMP2m", "dQ1",
                                      DELP]}, f)
    return config


def test_stacked_sample_diags_match_reference(cube, batches_config,
                                              tmp_path):
    """compute_offline_diags, input_sensitivity and offline_report on
    the config's float64 batches."""
    from fv3net_torch.loaders import batches_from_config as tbatches
    from fv3net_tpu.loaders import batches_from_config as jbatches

    with open(batches_config) as f:
        config = yaml.safe_load(f)
    jb, tb = jbatches(config), tbatches(config)
    tmodel = toff._sample.model_on(tio.load(cube["model_path"]), "cpu",
                                   torch.float64)
    want = joff.compute_offline_diags(cube["jmodel"], jb)
    got = toff.compute_offline_diags(tmodel, tb)
    assert "dQ1_density" in want and "column_integrated_dQ1_r2" in want
    assert_diags_equal(got, want)
    sw = joff.input_sensitivity(cube["jmodel"], jb[0])
    sg = toff.input_sensitivity(tmodel, tb[0])
    assert sorted(sg) == sorted(sw) and sw
    for k in sw:
        assert_close(sg[k], sw[k], k)
    # the report of a few of them (it draws each for a second or so)
    keep = ("dQ1_r2", "n_test_samples", "dQ1_rmse_profile", "dQ1_density")
    for label, mod, diags, sens in (("ref", joff, want, sw),
                                    ("port", toff, got, sg)):
        mod.offline_report({k: diags[k] for k in keep},
                           str(tmp_path / label), sensitivities={
                               k: sens[k] for k in sorted(sens)[:1]})
    assert (_items(tmp_path / "port" / "index.html")
            == _items(tmp_path / "ref" / "index.html"))


def test_stacked_sample_cli_matches_reference(cube, batches_config,
                                             tmp_path, monkeypatch):
    """The stacked-sample CLI on the batches config (the report's
    drawing, tested above, left out)."""
    from fv3net_tpu.diagnostics.offline import _sample as jsample

    for mod in (jsample, toff._sample):
        monkeypatch.setattr(mod, "offline_report",
                            lambda diags, out, **kw: None)
    assert jsample.main([cube["model_path"], batches_config,
                         str(tmp_path / "ref")]) == 0
    assert toff.main([cube["model_path"], batches_config,
                      str(tmp_path / "port"), "--device", "cpu"]) == 0
    with open(tmp_path / "ref" / "metrics.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "metrics.json") as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert_close(np.float64(got[k]), np.float64(want[k]), k)


def test_load_cube_from_config_matches_reference(cube, cli_outputs):
    """The data config's variables and timesteps."""
    root = cube["root"]
    config = {"path": str(root / "data.zarr"), "timesteps": [0, 1, 3],
              "variables": ["dQ1", "TMP2m", "missing"]}
    want = jocomp._load_cube_from_config(config)
    got = tocomp._load_cube_from_config(config)
    assert list(got) == list(want) == ["dQ1", "TMP2m"]
    assert np.array_equal(got.coords["time"], want.coords["time"])
    for k in want:
        assert np.array_equal(got[k].data, np.asarray(want[k].data))
    gw, gg = jocomp._grid_dict(f"c{N}"), tocomp._grid_dict(f"c{N}")
    for k in gw:
        assert np.array_equal(gg[k], gw[k]), k


# -------------------------------------------------------------- emulation
def _piggy(seed, nt=4):
    rng = np.random.RandomState(seed)
    shape = (nt, 6, NZ, N, N)
    out = {}
    for field in jemu.FIELDS:
        for stage in ("zhao_carr", "gscond"):
            phys = 1e-5 * rng.randn(*shape)
            out[f"tendency_of_{field}_due_to_{stage}_physics"] = phys
            out[f"tendency_of_{field}_due_to_{stage}_emulator"] = (
                phys + 1e-6 * rng.randn(*shape))
    for src in ("physics", "emulator"):
        out[f"surface_precipitation_due_to_zhao_carr_{src}"] = (
            1e-4 * rng.rand(nt, 6, N, N))
    return out


def _state(seed, nt=30):
    rng = np.random.RandomState(seed)
    return {"air_temperature": 280.0 + np.cumsum(0.1 * rng.randn(
                nt, 6, N, N), axis=0),
            "specific_humidity": 1e-2 * rng.rand(nt, 6, NZ, N, N)}


def _as(arrays, dims):
    return (JDataset({k: JQuantity(v, dims(v)) for k, v in arrays.items()}),
            TDataset({k: TQuantity(torch.tensor(v), dims(v))
                      for k, v in arrays.items()}))


def _dims(v):
    return DIMS3 if v.ndim == 5 else DIMS2


def assert_metrics_equal(got, want, rtol=RTOL, scale=None):
    """Each metric within ``rtol`` of its own size, or of ``scale``
    where given (a drift: a difference of two means of the field)."""
    assert sorted(got) == sorted(want) and want
    for k in want:
        if scale is None:
            assert_close(np.float64(got[k]), np.float64(want[k]), k, rtol)
        else:
            assert abs(got[k] - want[k]) <= rtol * scale, k


def test_emulation_skill_and_drift_match_reference():
    jd, td = _as(_piggy(8), _dims)
    for stage in ("zhao_carr", "gscond"):
        assert_metrics_equal(temu.emulation_skill(td, stage=stage),
                             jemu.emulation_skill(jd, stage=stage))
    for accessor in ("gscond_tendency", "total_tendency",
                     "precpd_tendency"):
        for field in jemu.FIELDS:
            for src in ("emulator", "physics"):
                assert_close(getattr(temu, accessor)(td, field, src),
                             getattr(jemu, accessor)(jd, field, src),
                             f"{accessor} {field} {src}")
    state = _state(9)
    js, ts = _as(state, _dims)
    area = _catalog_grid()["area"]
    # the drifts per day, held within 1e-12 of the fields' magnitude
    scale = max(np.abs(v).max() for v in state.values())
    assert_metrics_equal(temu.compute_drift(ts, 3600.0),
                         jemu.compute_drift(js, 3600.0), scale=scale)
    assert_metrics_equal(
        temu.compute_drift(ts, 3600.0, variables=("air_temperature",),
                           area=area),
        jemu.compute_drift(js, 3600.0, variables=("air_temperature",),
                           area=area), scale=scale)


def test_emulation_cli_matches_reference(tmp_path, capsys):
    for name, arrays in (("diags", _piggy(10)), ("state", _state(11))):
        tzarr.to_zarr(TDataset({k: TQuantity(v, _dims(v))
                                for k, v in arrays.items()}),
                      str(tmp_path / f"{name}.zarr"))
    args = [str(tmp_path / "diags.zarr"), "--state-zarr",
            str(tmp_path / "state.zarr"), "--dt-seconds", "3600"]
    assert jemu.main(args + ["--output", str(tmp_path / "ref.json")]) == 0
    assert temu.main(args + ["--output", str(tmp_path / "port.json"),
                             "--device", "cpu"]) == 0
    with open(tmp_path / "ref.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    drift = {k for k in want if k.startswith("drift/")}
    assert drift
    assert_metrics_equal({k: got[k] for k in got if k not in drift},
                         {k: want[k] for k in want if k not in drift})
    assert_metrics_equal({k: got[k] for k in drift},
                         {k: want[k] for k in drift}, scale=300.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            temu.main(args)


# -------------------------------------------------------------- reservoir
F, STATE, N_SYNC = 6, 24, 3
NR = 8  # the subdomain models' cube


def _hp(**kw):
    return jres.ReservoirHyperparameters(state_size=STATE, leakage=0.4,
                                         **kw)


def _reservoir_models(root):
    """The reference's pure, hybrid and subdomain models (and a
    PCA-latent subdomain one) from seeded float32 arrays, dumped; returns
    name -> (reference model, artifact path)."""
    from fv3net_tpu.fit.domain import CubeXYDivider
    from fv3net_tpu.fit.transformers import PCATransformer

    rng = np.random.RandomState(21)

    def f32(*shape, scale=1.0):
        return jnp.asarray(scale * rng.randn(*shape), jnp.float32)

    W = f32(STATE, STATE, scale=0.6 / np.sqrt(STATE))
    models = {
        "pure": jres.ReservoirComputingModel(
            ["inputs"], ["outputs"], f32(F, STATE, scale=0.3), W,
            f32(STATE, F, scale=0.2), f32(F, scale=0.1), _hp()),
        "hybrid": jres.HybridReservoirComputingModel(
            ["inputs"], ["outputs"], f32(F, STATE, scale=0.3), W,
            f32(STATE + F, F, scale=0.2), f32(F, scale=0.1), _hp(),
            hybrid=True),
    }
    divider = CubeXYDivider((2, 2), 1, (NR, NR))
    n_sub = divider.n_subdomains
    sy, sx = divider.subdomain_extent
    inner = (sy - 2) * (sx - 2)
    for name, nf, latent in (("subdomain", F, None),
                             ("subdomain_pca", 3, PCATransformer(
                                 f32(F), jnp.abs(f32(F)) + 1.0,
                                 f32(3, F, scale=0.4),
                                 original_feature_sizes=[F]))):
        hp = jres.SubdomainReservoirHyperparameters(
            input_variables=["inputs"], output_variables=["outputs"],
            subdomain_layout=(2, 2), overlap=1, reservoir=_hp(),
            hybrid=name == "subdomain")
        feats = STATE + (sy * sx * nf if hp.hybrid else 0)
        models[name] = jres.SubdomainReservoirModel(
            ["inputs"], ["outputs"], divider,
            f32(sy * sx * nf, STATE, scale=0.1), W,
            f32(n_sub, feats, inner * nf, scale=0.1),
            f32(n_sub, inner * nf, scale=0.1), hp, nf, transformer=latent)
    out = {}
    for name, model in models.items():
        path = str(root / name)
        jfit.dump(model, path)
        out[name] = (model, path)
    return out


@pytest.fixture(scope="module")
def reservoirs(tmp_path_factory):
    return _reservoir_models(tmp_path_factory.mktemp("reservoirs"))


def _series(nt, shape, seed):
    return np.random.RandomState(seed).randn(nt, *shape, F).astype(
        np.float32)


@pytest.mark.parametrize("name", ["pure", "hybrid"])
def test_reservoir_validation_matches_reference(reservoirs, name):
    """validation_prediction and compute_reservoir_diagnostics of a pure
    and a hybrid model, read from the reference's artifact and carried
    by reservoir_from_jax, against the reference's scan."""
    jmodel, path = reservoirs[name]
    u = _series(12, (5,), seed=22)
    wp, wt = jresd.validation_prediction(jmodel, u, N_SYNC)
    for tmodel in (tio.load(path), tres.reservoir_from_jax(jmodel)):
        gp, gt = tresd.validation_prediction(tmodel, u, N_SYNC)
        assert gp.dtype == torch.float32
        assert_close(gp, wp, f"{name} predictions", RESERVOIR_RTOL)
        assert_close(gt, wt, f"{name} targets", 0.0)
    jval = JDataset({"inputs": JQuantity(u, ("time", "sample", "f"))})
    tval = TDataset({"inputs": TQuantity(torch.tensor(u),
                                         ("time", "sample", "f"))})
    dw, mw = jresd.compute_reservoir_diagnostics(jmodel, jval, N_SYNC)
    dg, mg = tresd.compute_reservoir_diagnostics(tio.load(path), tval,
                                                 N_SYNC)
    assert_diags_equal(dict(dg.items()), dict(dw.items()), RESERVOIR_RTOL)
    assert_metrics_equal(mg, mw, RESERVOIR_RTOL)
    with pytest.raises(ValueError, match="no validation steps"):
        tresd.validation_prediction(tmodel, u[:N_SYNC + 1], N_SYNC)


@pytest.mark.parametrize("name", ["subdomain", "subdomain_pca"])
def test_subdomain_reservoir_validation_matches_reference(reservoirs,
                                                          name):
    """A subdomain model (hybrid; and one in a PCA latent space) read
    from the reference's artifact: the validation rollout against the
    reference's own rollout (its ``predict``), the inputs one step ahead
    and a paired target series."""
    jmodel, path = reservoirs[name]
    u = _series(6, (6, NR, NR), seed=23)
    dims = ("time", "tile", "y", "x", "f")
    want = np.asarray(jmodel.predict(JDataset({"inputs": JQuantity(
        u, dims)}))["outputs"].data)
    tmodel = tio.load(path)
    gp, gt = tresd.validation_prediction(tmodel, u, N_SYNC)
    assert_close(gp, want[N_SYNC:-1], f"{name} predictions", RESERVOIR_RTOL)
    assert_close(gt, u[N_SYNC + 1:], f"{name} targets", 0.0)
    y = 2.0 * u
    gp2, gt2 = tresd.validation_prediction(tmodel, u, N_SYNC, targets=y)
    assert_close(gp2, want[N_SYNC:], f"{name} paired", RESERVOIR_RTOL)
    assert_close(gt2, y[N_SYNC:], f"{name} paired targets", 0.0)


def test_reservoir_cli_matches_reference(reservoirs, tmp_path, capsys):
    _, path = reservoirs["hybrid"]
    u = _series(12, (5,), seed=24)
    tzarr.to_zarr(TDataset({"inputs": TQuantity(u, ("time", "sample",
                                                    "f"))}),
                  str(tmp_path / "val.zarr"))
    args = [path, None, str(tmp_path / "val.zarr"), str(N_SYNC)]
    for label, main, extra in (("ref", jresd.main, []),
                               ("port", tresd.main, ["--device", "cpu"])):
        args[1] = str(tmp_path / label)
        assert main(args + extra) == 0
    with open(tmp_path / "ref" / "metrics.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "metrics.json") as f:
        assert_metrics_equal(json.load(f), want, RESERVOIR_RTOL)
    dw = tzarr.open_zarr(str(tmp_path / "ref" / "diags.zarr"))
    dg = tzarr.open_zarr(str(tmp_path / "port" / "diags.zarr"))
    assert sorted(dg) == sorted(dw)
    for k in dw:
        assert dg[k].dims == dw[k].dims
        assert_close(dg[k].values, dw[k].values, k, RESERVOIR_RTOL)
