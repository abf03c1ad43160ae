"""fv3net_torch's prognostic-run diagnostics held against fv3net_tpu's on
shared seeded numpy inputs: every diagnostic of both registries of
``diagnostics/prognostic/compute.py`` (under the default transform chain
and under one that takes daily means and drops the last time), the
input transforms, the scalar metrics, ``computed.py``, the
``prognostic-run-diags-torch`` CLI against the reference's CLI on one
run directory, and the host copies (report, viz, movies, iterm, the log
viewer, the offline views).

The data are C12 with 8 levels and 8 hourly times: a 3-D field with its
delp, a precipitation rate holding values on interior and outer bin
edges, outside the bins and NaN, a field NaN over land (a masked field),
a rate NaN over one whole time, and the joint-histogram pair; the
streamfunction diagnostics take a 90-level wind (their latitude and
level axes broadcast against each other in the reference).  Float64
outputs agree within 1e-12 of each output's scale with NaN at the same
positions; histogram counts are equal.
"""
import dataclasses
import inspect
import json
import os
import re

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import torch_port_util  # noqa: F401,E402  (torch threads under xdist)

from fv3net_torch.core import zarrio as tzarr  # noqa: E402
from fv3net_torch.core.dataset import Dataset as TDataset  # noqa: E402
from fv3net_torch.core.quantity import Quantity as TQuantity  # noqa: E402
from fv3net_torch.diagnostics import cli as tcli  # noqa: E402
from fv3net_torch.diagnostics import computed as tcomputed  # noqa: E402
from fv3net_torch.diagnostics import transform as ttf  # noqa: E402
from fv3net_torch.diagnostics.prognostic import compute as tcomp  # noqa: E402
from fv3net_torch.diagnostics.prognostic import metrics as tmet  # noqa: E402
from fv3net_tpu.core.dataset import Dataset as JDataset  # noqa: E402
from fv3net_tpu.core.quantity import Quantity as JQuantity  # noqa: E402
from fv3net_tpu.diagnostics import cli as jcli  # noqa: E402
from fv3net_tpu.diagnostics import computed as jcomputed  # noqa: E402
from fv3net_tpu.diagnostics import transform as jtf  # noqa: E402
from fv3net_tpu.diagnostics.prognostic import compute as jcomp  # noqa: E402
from fv3net_tpu.diagnostics.prognostic import metrics as jmet  # noqa: E402
from fv3net_tpu.grid.geometry import make_grid  # noqa: E402

N, NZ, NT, NT_VERIF = 12, 8, 8, 10
NZ_WIND = 90  # the streamfunction's levels: as many as its latitudes
RTOL = 1e-12
BINS = np.logspace(-10, -2, 51)  # the precipitation histograms' edges
DIMS2 = ("time", "tile", "y", "x")
DIMS3 = ("time", "tile", "z", "y", "x")
DELP = "pressure_thickness_of_atmospheric_layer"
# a chain with daily means after 3 h, 2 h windows and the last time
# dropped: the transforms' other branches
DAILY_CHAIN = {"resample_freq_hours": 2.0, "daily_mean_split_hours": 3.0,
               "time_slice": slice(None, -1)}


def _grid():
    g = make_grid(N)
    lsm = np.zeros((6, N, N))
    lsm[0] = 1.0  # tile 0 is land
    lsm[1, : N // 3] = 2.0  # sea ice on part of tile 1
    return {"lat": np.rad2deg(g.lat), "lon": np.rad2deg(g.lon),
            "area": g.area, "land_sea_mask": lsm}


def _fields(nt, seed, lsm):
    """name -> (numpy data, dims, units) of the run's variables."""
    rng = np.random.RandomState(seed)
    shape2 = (nt, 6, N, N)
    prate = 10.0 ** rng.uniform(-11.0, -1.5, shape2)
    flat = prate.reshape(-1)
    flat[:5] = [BINS[10], BINS[-1], BINS[0], -1.0, np.nan]
    flat[5:8] = [BINS[25], 2e-2, 1e-11]
    total = 10.0 ** rng.uniform(-9.0, -3.0, shape2)
    total[2] = np.nan  # an all-NaN time
    sst = 290.0 + 10.0 * rng.rand(*shape2)
    sst[:, np.round(lsm) == 1] = np.nan  # masked over land
    wvp = rng.uniform(-5.0, 90.0, shape2)
    wvp.reshape(-1)[:3] = [40.0, 80.0, np.nan]
    dq2 = rng.uniform(-3e-3, 3e-3, shape2)
    dq2.reshape(-1)[:2] = [0.0, -2e-3]
    delp = 1e5 / NZ * (0.9 + 0.2 * rng.rand(nt, 6, NZ, N, N))
    return {
        "PRATEsfc": (prate, DIMS2, "kg/m^2/s"),
        "total_precipitation_rate": (total, DIMS2, "kg/m^2/s"),
        "ocean_surface_temperature": (sst, DIMS2, "K"),
        "TMP2m": (280.0 + 20.0 * rng.rand(*shape2), DIMS2, "K"),
        "water_vapor_path": (wvp, DIMS2, "mm"),
        "column_integrated_dQ2": (dq2, DIMS2, "kg/m^2/s"),
        "air_temperature": (250.0 + 30.0 * rng.rand(nt, 6, NZ, N, N),
                            DIMS3, "K"),
        DELP: (delp, DIMS3, "Pa"),
    }


def _wind_fields(nt, seed):
    rng = np.random.RandomState(seed)
    shape = (nt, 6, NZ_WIND, N, N)
    return {
        "northward_wind": (10.0 * rng.randn(*shape), DIMS3, "m/s"),
        DELP: (1e5 / NZ_WIND * (0.9 + 0.2 * rng.rand(*shape)), DIMS3, "Pa"),
    }


def _datasets(fields, times):
    """The same arrays as a reference and a port Dataset."""
    coords = {"time": times}
    return (JDataset({k: JQuantity(a, d, u) for k, (a, d, u) in
                      fields.items()}, dict(coords)),
            TDataset({k: TQuantity(a, d, u) for k, (a, d, u) in
                      fields.items()}, dict(coords)))


@pytest.fixture(scope="module")
def data():
    grid = _grid()
    hours = np.arange(NT, dtype=np.float64)
    jpred, tpred = _datasets(_fields(NT, 0, grid["land_sea_mask"]), hours)
    jver, tver = _datasets(_fields(NT_VERIF, 1, grid["land_sea_mask"]),
                           np.arange(NT_VERIF, dtype=np.float64))
    verif8 = _datasets(_fields(NT, 1, grid["land_sea_mask"]), hours)
    jwind, twind = _datasets(_wind_fields(4, 2), np.arange(4.0))
    jwind_v, twind_v = _datasets(_wind_fields(4, 3), np.arange(4.0))
    return {"grid": grid, "pred": (jpred, tpred), "verif": (jver, tver),
            "verif8": verif8, "wind": (jwind, twind),
            "wind_verif": (jwind_v, twind_v)}


def _host(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, label, exact=False):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert got.dtype == want.dtype, (label, got.dtype, want.dtype)
    if exact:
        assert np.array_equal(got, want, equal_nan=True), label
        return
    g, w = got.astype(np.float64), want.astype(np.float64)
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), f"{label}: NaN positions"
    inf = np.isinf(w)
    assert np.array_equal(g[inf], w[inf]), f"{label}: infinities"
    fin = ~(nan | inf)
    if fin.any():
        scale = max(np.abs(w[fin]).max(), 1e-300)
        err = np.abs(g[fin] - w[fin]).max() / scale
        assert err <= RTOL, f"{label}: {err} > {RTOL} of scale"


def _counted(name):
    """Histogram outputs: frequencies of counts, held exactly."""
    return "hist" in name


def assert_diags_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dims == w.dims, k
        assert g.units == w.units, k
        assert g.attrs == w.attrs, k
        assert_close(g.data, w.data, k, exact=_counted(k))


def _chain(settings):
    """Set both packages' transform chains; returns a restoring call."""
    saved = dict(jcomp.TRANSFORM_CHAIN)
    jcomp.set_transform_chain(**settings)
    tcomp.set_transform_chain(**settings)

    def restore():
        jcomp.set_transform_chain(**saved)
        tcomp.set_transform_chain(**saved)

    return restore


def _args(data, wind):
    """(reference DiagArg, port DiagArg on the CPU)."""
    key = ("wind", "wind_verif") if wind else ("pred", "verif")
    (jp, tp), (jv, tv) = data[key[0]], data[key[1]]
    grid = data["grid"]
    return (jcomp.DiagArg(jp, jv, grid),
            tcomp.DiagArg(ttf.on_device(tp, "cpu"),
                          ttf.on_device(tv, "cpu"),
                          ttf.grid_on(grid, "cpu")))


REGISTERED = ([("2d", n) for n in jcomp.registry_2d.funcs]
              + [("3d", n) for n in jcomp.registry_3d.funcs])


def test_registries_hold_the_references_diagnostics():
    assert list(tcomp.registry_2d.funcs) == list(jcomp.registry_2d.funcs)
    assert list(tcomp.registry_3d.funcs) == list(jcomp.registry_3d.funcs)
    assert tcomp.registry_2d is not jcomp.registry_2d
    assert tcomp.TRANSFORM_CHAIN == jcomp.TRANSFORM_CHAIN


@pytest.mark.parametrize("registry,name", REGISTERED,
                         ids=[n for _, n in REGISTERED])
def test_prognostic_diagnostic_matches_reference(data, registry, name):
    """One registered diagnostic, with and without verification, under
    the default chain and the daily-mean chain."""
    jreg = getattr(jcomp, f"registry_{registry}").funcs[name]
    treg = getattr(tcomp, f"registry_{registry}").funcs[name]
    jarg, targ = _args(data, name.startswith("mass_streamfunction"))
    for settings in ({}, DAILY_CHAIN):
        restore = _chain(settings)
        try:
            for verified in (True, False):
                ja = jarg if verified else dataclasses.replace(
                    jarg, verification=None)
                ta = targ if verified else dataclasses.replace(
                    targ, verification=None)
                want = jreg(ja)
                assert_diags_equal(treg(ta), want)
        finally:
            restore()
    if name in ("histogram", "hist_2d", "spatial_min_global",
                "mass_streamfunction_value"):
        assert want, f"{name} computed nothing on the test data"


def test_histogram_counts_edges_and_nan():
    """The counts themselves: a value on an interior edge counts in the
    bin it opens, the last edge in the last bin, values outside and NaN
    nowhere; an all-NaN field counts nothing."""
    from fv3net_torch.ops import statistics as tstats
    from fv3net_tpu.ops import statistics as jstats

    x = np.array([BINS[10], BINS[-1], BINS[0], -1.0, np.nan, 2e-2,
                  BINS[25], 1e-11])
    got, _ = tstats.histogram(torch.tensor(x), BINS)
    want, _ = jstats.histogram(jax.numpy.asarray(x), BINS)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.sum().item() == 4 and got[10] == 1 and got[-1] == 1
    nan = torch.full((5,), torch.nan, dtype=torch.float64)
    assert tstats.histogram(nan, BINS)[0].sum().item() == 0


def test_nanmin_nanmax_all_nan_slice():
    x = np.array([[np.nan, np.nan], [1.0, np.nan], [-2.0, 3.0]])
    for mine, ref in ((tcomp.nanmin, jax.numpy.nanmin),
                      (tcomp.nanmax, jax.numpy.nanmax)):
        got = mine(torch.tensor(x), 1).numpy()
        want = np.asarray(ref(jax.numpy.asarray(x), axis=1))
        assert np.array_equal(got, want, equal_nan=True)


TRANSFORMS = [
    ("resample_time", (3.0,), {}),
    ("resample_time", (2.0,), {"inner_join": True, "method": "mean"}),
    ("daily_mean", (2.0,), {}),
    ("subset_variables", (["TMP2m", "nope", "air_temperature"],), {}),
    ("select_2d_variables", (), {}),
    ("select_3d_variables", (), {}),
    ("mask_to_sfc_type", ("land",), {}),
    ("mask_to_sfc_type", ("seaice",), {}),
    ("mask_area", ("tropics",), {}),
    ("mask_area", ("tropics15",), {}),
    ("mask_area", ("sea",), {}),
    ("regrid_zdim_to_pressure_levels", (), {}),
]


@pytest.mark.parametrize("name,args,kwargs", TRANSFORMS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(TRANSFORMS)])
def test_transform_matches_reference(data, name, args, kwargs):
    """One input transform on the run and its verification: variables,
    dims, time coordinates, data and the grid's area."""
    from fv3net_tpu.diagnostics.offline.compute_diagnostics import (
        DiagArg as JOffArg,
    )
    from fv3net_torch.diagnostics.offline.compute_diagnostics import (
        DiagArg as TOffArg,
    )

    # the pressure-level regrid takes the run's delp for both sides
    (jp, tp), (jv, tv) = data["pred"], data[
        "verif8" if name.startswith("regrid") else "verif"]
    grid = data["grid"]
    delp = np.asarray(jp[DELP].data)
    jarg = JOffArg(jp, jv, grid, delp=delp)
    targ = TOffArg(ttf.on_device(tp, "cpu"), ttf.on_device(tv, "cpu"),
                   ttf.grid_on(grid, "cpu"), delp=torch.tensor(delp))
    want = jtf._TRANSFORM_FNS[name](*args, jarg, **kwargs)
    got = ttf._TRANSFORM_FNS[name](*args, targ, **kwargs)
    for side in ("prediction", "verification"):
        w, g = getattr(want, side), getattr(got, side)
        assert list(g) == list(w), side
        for key in ("time",):
            assert np.array_equal(np.asarray(g.coords.get(key)),
                                  np.asarray(w.coords.get(key))), side
        for k in w:
            assert g[k].dims == w[k].dims, k
            assert_close(g[k].data, w[k].data, f"{side} {k}")
    assert_close(got.grid["area"], np.asarray(want.grid["area"]), "area")


def test_transform_errors_match_reference(data):
    (jp, tp), (jv, tv) = data["pred"], data["verif"]
    grid = data["grid"]
    jarg = jcomp.DiagArg(jp, jv, grid)
    targ = tcomp.DiagArg(tp, tv, ttf.grid_on(grid, "cpu"))
    for fn, args in (("mask_area", ("mars",)),
                     ("mask_to_sfc_type", ("glacier",)),
                     ("regrid_zdim_to_pressure_levels", ())):
        with pytest.raises(ValueError) as jerr:
            jtf._TRANSFORM_FNS[fn](*args, jarg)
        with pytest.raises(ValueError) as terr:
            ttf._TRANSFORM_FNS[fn](*args, targ)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="resample"):
        ttf._resample(tp, 2.0, "median")


def test_metrics_match_reference(data):
    """compute_metrics over the diagnostics of compute_all."""
    (jp, tp), (jv, tv) = data["pred"], data["verif"]
    want_diags = jcomp.compute_all(jp, data["grid"], jv)
    got_diags = tcomp.compute_all(tp, data["grid"], tv, device="cpu")
    assert_diags_equal(got_diags, want_diags)
    want = jmet.compute_metrics(want_diags)
    got = tmet.compute_metrics(got_diags)
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert got[k]["units"] == want[k]["units"]
        assert_close(np.float64(got[k]["value"]),
                     np.float64(want[k]["value"]), k)


# -------------------------------------------------------------- the CLI
def _write_run(path, fields, times):
    ds = TDataset({k: TQuantity(a, d, u) for k, (a, d, u) in fields.items()
                   if k in CLI_VARIABLES}, {"time": times})
    tzarr.to_zarr(ds, path)


CLI_VARIABLES = ("PRATEsfc", "TMP2m", "ocean_surface_temperature",
                 "air_temperature", DELP)


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory, data):
    """Both packages' ``compute`` (with --verification), ``metrics`` and
    ``report`` on one run."""
    root = tmp_path_factory.mktemp("prognostic_cli")
    lsm = data["grid"]["land_sea_mask"]
    run = str(root / "run.zarr")
    verif = str(root / "verif.zarr")
    _write_run(run, _fields(NT, 0, lsm), np.arange(NT, dtype=np.float64))
    _write_run(verif, _fields(NT_VERIF, 1, lsm),
               np.arange(NT_VERIF, dtype=np.float64))
    out = {}
    for label, main, extra in (("ref", jcli.main, []),
                               ("port", tcli.main, ["--device", "cpu"])):
        d = root / label
        d.mkdir()
        diags = str(d / "diags.zarr")
        assert main(["compute", run, diags, "--verification", verif]
                    + extra) == 0
        metrics = str(d / "metrics.json")
        assert main(["metrics", diags, metrics] + extra) == 0
        assert main(["report", diags, str(d / "report")]) == 0
        out[label] = d
    return out


def test_cli_compute_writes_the_references_store(cli_outputs):
    want = tzarr.open_zarr(str(cli_outputs["ref"] / "diags.zarr"))
    got = tzarr.open_zarr(str(cli_outputs["port"] / "diags.zarr"))
    assert sorted(got) == sorted(want) and len(want) > 50
    for k in want:
        assert got[k].dims == want[k].dims, k
        assert got[k].attrs == want[k].attrs, k
        assert_close(got[k].values, want[k].values, k, exact=_counted(k))


def test_cli_metrics_write_the_references_json(cli_outputs):
    with open(cli_outputs["ref"] / "metrics.json") as f:
        want = json.load(f)
    with open(cli_outputs["port"] / "metrics.json") as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert got[k]["units"] == want[k]["units"]
        assert_close(np.float64(got[k]["value"]),
                     np.float64(want[k]["value"]), k)


def _items(path):
    """The report's section headings, figure captions and metric names
    in order."""
    with open(path) as f:
        text = f.read()
    return re.findall(r"<h2>.*?</h2>|<figcaption>.*?</figcaption>|"
                      r"<tr><td>.*?</td>", text)


def test_cli_report_writes_the_references_items(cli_outputs):
    want = _items(cli_outputs["ref"] / "report" / "index.html")
    got = _items(cli_outputs["port"] / "report" / "index.html")
    assert got == want and any("figcaption" in i for i in want)


def test_cli_defaults_to_the_card(tmp_path):
    """Without a card the default device raises; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["compute", str(tmp_path / "x.zarr"),
                   str(tmp_path / "o.zarr")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["metrics", str(tmp_path / "x.zarr"),
                   str(tmp_path / "m.json")])


def test_cli_load_run_and_grid_match_reference(tmp_path, data):
    """_load_run over a segmented run's artifacts (two segments,
    concatenated in time) and _grid_for with its all-zero mask."""
    fields = _fields(3, 4, data["grid"]["land_sea_mask"])
    for seg in ("20160101.000000", "20160101.030000"):
        _write_run(str(tmp_path / "artifacts" / seg / "diags.zarr"), fields,
                   np.arange(3.0))
    want = jcli._load_run(str(tmp_path))
    got = tcli._load_run(str(tmp_path))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dims == want[k].dims
        assert np.array_equal(got[k].data, np.asarray(want[k].data),
                              equal_nan=True)
    gw, gg = jcli._grid_for(want), tcli._grid_for(got)
    for k in ("lat", "lon", "area", "land_sea_mask"):
        assert np.array_equal(gg[k], gw[k]), k
    assert not gg["land_sea_mask"].any()
    with pytest.raises(FileNotFoundError):
        tcli._load_run(str(tmp_path / "nothing"))


def test_log_viewer_and_find_state_match_reference(tmp_path, capsys):
    log = tmp_path / "logs.json"
    log.write_text("\n".join(json.dumps({"time": f"t{i}", "a": float(i),
                                         "b": 2.0 ** -i})
                             for i in range(4)) + "\nnot json\n")
    jcli.log_viewer_cmd(str(log))
    want = capsys.readouterr().out
    tcli.log_viewer_cmd(str(log))
    assert capsys.readouterr().out == want and "4 steps" in want
    from fv3net_torch.diagnostics.prognostic.apps import log_viewer as tlv
    from fv3net_tpu.diagnostics.prognostic.apps import log_viewer as jlv

    seg = tmp_path / "artifacts" / "s1"
    seg.mkdir(parents=True)
    (seg / "logs.json").write_text(log.read_text())
    assert tlv.load_series(str(tmp_path)) == jlv.load_series(str(tmp_path))
    (seg / "state_after_timestep.zarr").mkdir()
    assert (tcli._find_state_zarr(str(tmp_path))
            == jcli._find_state_zarr(str(tmp_path)))


# ------------------------------------------------------------ computed.py
def test_computed_bucket_matches_reference(tmp_path, data):
    """detect_folders, load_diagnostics and load_metrics over a bucket of
    two runs (a variable missing from one, NaN-filled from the other),
    then the comparison report through ``report`` on the bucket."""
    rng = np.random.RandomState(5)
    for i, run in enumerate(("baseline", "ml")):
        d = tmp_path / run
        vars_ = {"TMP2m_spatial_mean_global": TQuantity(
            rng.rand(4), ("time",), "K"),
            "TMP2m_zonal_and_time_mean": TQuantity(
                rng.rand(90), ("latitude",), "K",
                attrs={"latitude": list(np.arange(-89.0, 90.0, 2.0))})}
        if i:
            vars_["PRATEsfc_rms_global"] = TQuantity(rng.rand(4), ("time",))
        tzarr.to_zarr(TDataset(vars_), str(d / "diags.zarr"))
        (d / "metrics.json").write_text(json.dumps({
            "rmse/TMP2m": {"value": float(i) + 0.5, "units": "K"},
            "drift/PRATEsfc": 0.25 * i}))
    (tmp_path / "not_a_run").mkdir()
    jf, tf = (jcomputed.detect_folders(str(tmp_path)),
              tcomputed.detect_folders(str(tmp_path)))
    assert list(tf) == list(jf) == ["baseline", "ml"]
    jd, td = (jcomputed.load_diagnostics(str(tmp_path)),
              tcomputed.load_diagnostics(str(tmp_path)))
    assert td.runs == jd.runs and td.variables == jd.variables
    assert td.long_names == jd.long_names
    for run in jd.runs:
        for v in sorted(jd.variables):
            g, w = td.get_variable(run, v), jd.get_variable(run, v)
            assert np.array_equal(g.data, np.asarray(w.data), equal_nan=True)
    assert (td.matching_variables("_global", ["TMP2m"])
            == jd.matching_variables("_global", ["TMP2m"]))
    jm, tm = (jcomputed.load_metrics(str(tmp_path)),
              tcomputed.load_metrics(str(tmp_path)))
    assert tm.runs == jm.runs and tm.types == jm.types
    for t in sorted(jm.types):
        assert tm.get_metric_variables(t) == jm.get_metric_variables(t)
        for v in jm.get_metric_variables(t):
            assert tm.get_metric_all_runs(t, v) == jm.get_metric_all_runs(t,
                                                                          v)
    for label, main in (("ref", jcli.main), ("port", tcli.main)):
        assert main(["report", str(tmp_path), str(tmp_path / label)]) == 0
    assert (_items(tmp_path / "port" / "index.html")
            == _items(tmp_path / "ref" / "index.html"))


# ------------------------------------------------------------ the copies
def _body(module):
    src = inspect.getsource(module)
    return src[src.index("from __future__"):].replace("fv3net_tpu",
                                                      "fv3net_torch")


COPIES = ("report.create_report", "viz.helpers", "viz.plot_cube",
          "diagnostics.movies", "diagnostics.prognostic.iterm",
          "diagnostics.prognostic.apps.log_viewer",
          "diagnostics.offline.views", "diagnostics.registry",
          "diagnostics.computed")


@pytest.mark.parametrize("name", COPIES + ("report", "viz"))
def test_copied_host_module_equals_its_original(name):
    """The host-only code copied into the port, held equal to the
    reference's with its package name swapped (below the module
    docstring, which names the original; a package's ``__init__``
    whole)."""
    import importlib

    mine = importlib.import_module(f"fv3net_torch.{name}")
    ref = importlib.import_module(f"fv3net_tpu.{name}")
    if name in COPIES:
        assert _body(mine) == _body(ref)
    else:
        assert inspect.getsource(mine) == inspect.getsource(ref).replace(
            "fv3net_tpu", "fv3net_torch")


def test_copied_plots_draw_as_the_originals(tmp_path, capsys):
    """The copies' drawing on the port's grid: the cube plot, the iTerm
    image (written to a file off a terminal) and the ``plot`` and
    ``movies`` subcommands on a small store."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fv3net_torch.grid.geometry import make_grid as tmake_grid
    from fv3net_torch.viz import infer_cmap_params, plot_cube

    field = np.random.RandomState(6).rand(6, 4, 4)
    fig, ax, mesh = plot_cube(tmake_grid(4), field, title="f")
    assert mesh is not None and infer_cmap_params(field)[0] is not None
    plt.close(fig)
    ds = TDataset({"TMP2m": TQuantity(np.random.RandomState(7).rand(
        2, 6, 4, 4), DIMS2, "K")}, {"time": np.arange(2.0)})
    tzarr.to_zarr(ds, str(tmp_path / "state.zarr"))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert tcli.main(["plot", str(tmp_path / "state.zarr"),
                          "TMP2m"]) == 0
        assert tcli.main(["movies", str(tmp_path / "state.zarr"),
                          str(tmp_path / "movies")]) == 0
    finally:
        os.chdir(cwd)
    printed = capsys.readouterr().out
    assert "TMP2m" in printed
    assert os.listdir(tmp_path / "movies")


def test_matplotlib_commands_raise_its_import_error(tmp_path, monkeypatch,
                                                    cli_outputs):
    """Where matplotlib is not installed (as on the card's machine),
    ``report`` raises its ImportError in both packages."""
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    diags = str(cli_outputs["port"] / "diags.zarr")
    for main in (jcli.main, tcli.main):
        with pytest.raises(ImportError):
            main(["report", diags, str(tmp_path / "r")])
