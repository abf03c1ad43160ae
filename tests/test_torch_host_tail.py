"""The port's host tail against ``fv3net_tpu``: ``artifacts``, the
filesystem helpers (with the ``FV3NET_FS_MIRROR`` redirection), the
testing digests, ``prepare_config.main``, the RRTMG table validator and
``synth``.  The host-only copies are held equal to the originals' source
with the package name swapped; the rest runs both packages on the same
inputs and holds the outputs equal."""
import datetime
import inspect
import io
import json
import os
import sys
import tarfile

import numpy as np
import pytest
import torch
import yaml

import torch_port_util  # noqa: F401  (torch threads under xdist)

from fv3net_torch import artifacts as tart
from fv3net_torch import synth as tsynth
from fv3net_torch.artifacts import cli as tart_cli
from fv3net_torch.artifacts import metadata as tmeta
from fv3net_torch.core import filesystem as tfs
from fv3net_torch.core import testing as ttesting
from fv3net_torch.core.dataset import Dataset as TDataset
from fv3net_torch.core.quantity import Quantity as TQuantity
from fv3net_torch.physics.radiation.rrtmg import io as trio
from fv3net_torch.physics.radiation.rrtmg import tables as ttables
from fv3net_torch.physics.radiation.rrtmg import validate as tvalidate
from fv3net_torch.runtime.segmented_run import prepare_config as tprep
from fv3net_torch.synth import cdl as tcdl
from fv3net_tpu import artifacts as jart
from fv3net_tpu import synth as jsynth
from fv3net_tpu.artifacts import cli as jart_cli
from fv3net_tpu.artifacts import metadata as jmeta
from fv3net_tpu.core import filesystem as jfs
from fv3net_tpu.core import testing as jtesting
from fv3net_tpu.physics.radiation.rrtmg import validate as jvalidate
from fv3net_tpu.runtime.segmented_run import prepare_config as jprep
from fv3net_tpu.synth import cdl as jcdl


# the packages' ``resolve_url`` names the function, not its module
tresolve = sys.modules["fv3net_torch.artifacts.resolve_url"]
jresolve = sys.modules["fv3net_tpu.artifacts.resolve_url"]


def _body(module):
    src = inspect.getsource(module)
    return src[src.index("from __future__"):].replace("fv3net_tpu",
                                                      "fv3net_torch")


COPIES = ((tmeta, jmeta), (tresolve, jresolve), (tart_cli, jart_cli),
          (tfs, jfs), (tvalidate, jvalidate), (tcdl, jcdl))


@pytest.mark.parametrize("pair", COPIES, ids=lambda p: p[0].__name__)
def test_copied_host_module_equals_its_original(pair):
    """Each host-only copy, below its docstring (which names the
    original), is the original with the package name swapped."""
    mine, ref = pair
    assert _body(mine) == _body(ref)


def test_copied_package_inits_equal_their_originals():
    for mine, ref in ((tart, jart), (tsynth, jsynth)):
        assert inspect.getsource(mine) == inspect.getsource(ref).replace(
            "fv3net_tpu", "fv3net_torch")


def test_prepare_config_body_equals_its_original():
    """The port's prepare_config module, ``main`` included, is the
    reference's with the package name swapped."""
    assert _body(tprep) == _body(jprep)


# ------------------------------------------------------------ artifacts
def test_artifacts_metadata_and_resolve_url(capsys):
    for pkg in (tart, jart):
        pkg.StepMetadata("training", "/out", args=["a"]).print_json()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1]
    assert json.loads(lines[0]) == {"step_metadata": {
        "job_type": "training", "url": "/out", "args": ["a"]}}
    when = datetime.date(2026, 1, 2)
    assert (tart.resolve_url("gs://b", "proj", "t", when)
            == jart.resolve_url("gs://b", "proj", "t", when)
            == "gs://b/proj/2026-01-02/t")
    for pkg in (tart, jart):
        with pytest.raises(ValueError, match="lowercase"):
            pkg.resolve_url("b", "Bad_Project", "t")


def test_artifacts_cli_both_packages(tmp_path, capsys):
    """``resolve-url`` and ``ls`` (text and JSON) print the same lines
    from both packages' CLIs; a missing workspace exits 1 in both."""
    for project, date, tag in (("p1", "2026-01-01", "a"),
                               ("p1", "2026-01-02", "b"),
                               ("p2", "2026-01-01", "c")):
        (tmp_path / project / date / tag).mkdir(parents=True)
    runs = (["resolve-url", "gs://b", "proj", "t", "--date", "2026-03-04"],
            ["ls", str(tmp_path)], ["ls", str(tmp_path), "-o", "json"],
            ["ls", str(tmp_path), "--project", "p2"])
    for argv in runs:
        outs = []
        for main in (tart_cli.main, jart_cli.main):
            assert main(argv) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and outs[0], argv
    for main in (tart_cli.main, jart_cli.main):
        assert main(["ls", str(tmp_path / "none")]) == 1


# ------------------------------------------------------------ filesystem
def test_filesystem_and_mirror_both_packages(tmp_path, monkeypatch):
    """The same calls through both packages: protocols, ls/glob/exists/
    isdir/cat/open/makedirs/get, to_url, a remote URL refused without the
    mirror and read through ``FV3NET_FS_MIRROR`` with it."""
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "a.txt").write_bytes(b"hello")
    for fs_mod in (tfs, jfs):
        assert fs_mod.get_protocol("gs://b/k") == "gs"
        assert fs_mod.get_protocol("/local") == "file"
        fs = fs_mod.get_fs(str(tmp_path))
        assert fs.ls(str(tmp_path / "d")) == [str(tmp_path / "d" / "a.txt")]
        assert fs.glob(str(tmp_path / "d" / "*.txt")) == [
            str(tmp_path / "d" / "a.txt")]
        assert fs.exists("file://" + str(tmp_path / "d" / "a.txt"))
        assert fs.isdir(str(tmp_path / "d"))
        assert fs.cat(str(tmp_path / "d" / "a.txt")) == b"hello"
        with fs.open(str(tmp_path / "w" / fs_mod.__name__), "w") as f:
            f.write("x")
        fs.makedirs(str(tmp_path / "m"))
        fs.get(str(tmp_path / "d" / "a.txt"), str(tmp_path / "m" / "b"))
        assert (tmp_path / "m" / "b").read_bytes() == b"hello"
        assert fs_mod.to_url(fs, "/p") == "/p"

        class Remote:
            protocol = ("gs", "gcs")

        assert fs_mod.to_url(Remote(), "b/k") == "gs://b/k"
        monkeypatch.delenv("FV3NET_FS_MIRROR", raising=False)
        with pytest.raises(OSError, match="FV3NET_FS_MIRROR"):
            fs.cat("gs://bucket/a.txt")
    monkeypatch.setenv("FV3NET_FS_MIRROR", str(tmp_path))
    (tmp_path / "bucket").mkdir()
    (tmp_path / "bucket" / "a.txt").write_bytes(b"remote")
    for fs_mod in (tfs, jfs):
        fs = fs_mod.get_fs("gs://bucket")
        assert fs.cat("gs://bucket/a.txt") == b"remote"
        assert fs.ls("gs://bucket") == [str(tmp_path / "bucket" / "a.txt")]


def test_open_remote_nc_and_tarball_both_packages(tmp_path, monkeypatch):
    """A netCDF the port writes, read through both packages'
    ``open_remote_nc`` from a mirrored remote URL; a tarball extracted
    by both."""
    from fv3net_torch.core.netcdfio import write_netcdf

    arr = np.arange(12.0).reshape(3, 4)
    (tmp_path / "bkt").mkdir()
    write_netcdf(TDataset({"T": TQuantity(arr, ("y", "x"), "K")}),
                 str(tmp_path / "bkt" / "f.nc"))
    monkeypatch.setenv("FV3NET_FS_MIRROR", str(tmp_path))
    got = tfs.open_remote_nc(tfs.LocalFileSystem(), "gs://bkt/f.nc")
    want = jfs.open_remote_nc(jfs.LocalFileSystem(), "gs://bkt/f.nc")
    np.testing.assert_array_equal(got["T"].values, np.asarray(
        want["T"].data))
    np.testing.assert_array_equal(got["T"].values, arr)
    assert got["T"].units == want["T"].units == "K"
    src = tmp_path / "x.txt"
    src.write_text("data")
    tar = tmp_path / "archive.tar"
    with tarfile.open(tar, "w") as t:
        t.add(src, arcname="x.txt")
    for fs_mod, name in ((tfs, "port"), (jfs, "ref")):
        out = fs_mod.extract_tarball_to_path(tar, tmp_path / name)
        assert (out / "x.txt").read_text() == "data"
    assert tfs.extract_tarball_to_path(tar) == tmp_path / "archive"


# ------------------------------------------------------------ testing
def test_checksums_equal_across_packages():
    """The same values digest the same in both packages: numpy arrays,
    torch tensors (of every dtype numpy has), JAX arrays, a Dataset of
    the port's tensors and the reference's Dataset of the same values."""
    import jax.numpy as jnp

    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    rng = np.random.RandomState(0)
    for dtype in (np.float32, np.float64, np.int32, np.int64, np.uint8,
                  np.bool_, np.float16):
        a = (rng.rand(3, 4, 5) * 10).astype(dtype)
        want = jtesting.checksum_array(a)
        assert ttesting.checksum_array(a) == want
        assert ttesting.checksum_array(torch.from_numpy(a)) == want
        # a non-contiguous view hashes as its contiguous copy
        t = torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1)))
        assert (ttesting.checksum_array(t.permute(1, 2, 0))
                == jtesting.checksum_array(a))
    a = rng.rand(4, 6).astype(np.float32)
    assert (ttesting.checksum_array(torch.from_numpy(a))
            == jtesting.checksum_array(jnp.asarray(a)))
    tds = TDataset({"b": TQuantity(torch.from_numpy(a), ("y", "x")),
                    "a": TQuantity(torch.from_numpy(a[::2]), ("y", "x"))})
    jds = JDataset({"b": JQuantity(jnp.asarray(a), ("y", "x")),
                    "a": JQuantity(jnp.asarray(a[::2]), ("y", "x"))})
    assert ttesting.checksum_dataset(tds) == jtesting.checksum_dataset(jds)
    assert ttesting.checksum_dataset({"a": a}) == jtesting.checksum_dataset(
        {"a": a})


def test_no_warning_both_packages():
    import warnings

    for mod in (ttesting, jtesting):
        with mod.no_warning():
            pass
        with mod.no_warning("other"):
            warnings.warn("this one")
        with pytest.raises(AssertionError, match="unexpected warnings"):
            with mod.no_warning("this"):
                warnings.warn("this one")


# ------------------------------------------------------------ prepare-config
def test_prepare_config_main_same_yaml(tmp_path, capsys):
    """``prepare-config`` of both packages prints the same lowered YAML
    for a base preset with an overlay, and both refuse an invalid one."""
    user = {"base_version": "v0.1/aquaplanet_c12_test",
            "namelist": {"npz": 8}, "duration_seconds": 900.0}
    path = tmp_path / "user.yaml"
    path.write_text(yaml.safe_dump(user))
    outs = []
    for main in (tprep.main, jprep.main):
        assert main([str(path)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    lowered = yaml.safe_load(outs[0])
    assert lowered["namelist"] == {"npx": 12, "npz": 8, "dt_atmos": 900.0,
                                   "n_split": 2}
    bad = tmp_path / "bad.yaml"
    bad.write_text(yaml.safe_dump({"no_such_key": 1}))
    for main in (tprep.main, jprep.main):
        with pytest.raises(Exception):
            main([str(bad)])


# ------------------------------------------------------------ validate
@pytest.fixture(scope="module")
def table_dirs(tmp_path_factory):
    """An intact lookup directory and three corrupted ones, written by
    the port's ``rrtmg/io.py`` from its ``tables.py``: negative and
    non-finite coefficients, a Planck fraction above 1, a warm tref, a
    reordered preflog and a resized table; one file missing; a file that
    does not load."""
    lw = ttables.make_lw_tables(seed=0)
    sw = ttables.make_sw_tables(seed=1)
    root = tmp_path_factory.mktemp("rrtmg")
    intact = str(root / "intact")
    trio.dump_lw(lw, intact)
    trio.dump_sw(sw, intact)

    bad_lw = {k: (dict(v) if isinstance(v, dict) else np.array(v))
              for k, v in lw.items()}
    bad_sw = {k: (dict(v) if isinstance(v, dict) else np.array(v))
              for k, v in sw.items()}
    kgb = bad_lw["radlw_kgb05"]
    kgb["absa"] = np.array(kgb["absa"])
    kgb["absa"][3, 7] = -1.0
    kgb["selfref"] = np.array(kgb["selfref"])
    kgb["selfref"][0, 0] = np.nan
    kgb["fracrefa"] = np.array(kgb["fracrefa"]) + 1.0
    bad_lw["tref"] = np.array(bad_lw["tref"]) + 200.0
    bad_lw["preflog"] = np.array(bad_lw["preflog"])[::-1].copy()
    bad_sw["radsw_kgb20"] = dict(bad_sw["radsw_kgb20"])
    key = sorted(k for k, v in bad_sw["radsw_kgb20"].items()
                 if np.ndim(v) == 2)[0]
    bad_sw["radsw_kgb20"][key] = np.array(bad_sw["radsw_kgb20"][key])[:, :-1]
    corrupted = str(root / "corrupted")
    trio.dump_lw(bad_lw, corrupted)
    trio.dump_sw(bad_sw, corrupted)

    missing = str(root / "missing")
    trio.dump_lw(lw, missing)
    trio.dump_sw(sw, missing)
    os.remove(os.path.join(missing, "radsw_kgb22_data.nc"))

    unreadable = str(root / "unreadable")
    trio.dump_lw(lw, unreadable)
    trio.dump_sw(sw, unreadable)
    with open(os.path.join(unreadable, "totplnk.nc"), "wb") as f:
        f.write(b"not a netCDF file")
    return {"intact": intact, "corrupted": corrupted, "missing": missing,
            "unreadable": unreadable}


@pytest.mark.parametrize("which", ("intact", "corrupted", "missing",
                                   "unreadable"))
def test_validate_lookup_dir_same_problems(table_dirs, which, capsys):
    """Both packages' validators find the same problem list (none for the
    intact directory), and their CLIs print the same lines and exit
    codes."""
    path = table_dirs[which]
    got = tvalidate.validate_lookup_dir(path)
    want = jvalidate.validate_lookup_dir(path)
    assert got == want
    assert (got == []) == (which == "intact")
    if which == "corrupted":
        text = "\n".join(got)
        for part in ("negative coefficients", "non-finite",
                     "fractions outside", "tref outside", "preflog",
                     "shape"):
            assert part in text, part
    codes = []
    outs = []
    for main in (tvalidate.main, jvalidate.main):
        codes.append(main([path]))
        outs.append(capsys.readouterr().out)
    assert codes[0] == codes[1] == (0 if which == "intact" else 1)
    assert outs[0] == outs[1]
    assert tvalidate.main([]) == jvalidate.main([]) == 2


# ------------------------------------------------------------ synth
def test_synth_generators_equal_the_reference():
    """Each generator of the port on the CPU: the reference's values,
    dims and dtypes; deterministic."""
    for name, kw in (("generate_nudging", dict(nt=2, nz=4, n=4)),
                     ("generate_restart_data", dict(nz=4, n=4)),
                     ("generate_fine_res", dict(nz=3, n=4))):
        got = getattr(tsynth, name)(device="cpu", **kw)
        want = getattr(jsynth, name)(**kw)
        assert sorted(got) == sorted(want), name
        for v in want:
            assert torch.is_tensor(got[v].data)
            assert got[v].dims == tuple(want[v].dims)
            np.testing.assert_array_equal(got[v].values,
                                          np.asarray(want[v].values))
            assert got[v].values.dtype == np.asarray(want[v].values).dtype
        again = getattr(tsynth, name)(device="cpu", **kw)
        for v in want:
            assert torch.equal(again[v].data, got[v].data)


def test_synth_schema_json_and_stores_both_ways(tmp_path):
    """Schemas dumped by one package load in the other and generate the
    same data; each package reads the other's zarr store back into the
    same schema and values."""
    from fv3net_torch.core import zarrio as tz
    from fv3net_tpu.core import zarrio as jz

    ds_t = tsynth.generate_nudging(nt=2, nz=3, n=4, device="cpu")
    ds_j = jsynth.generate_nudging(nt=2, nz=3, n=4)
    schema_t = tsynth.read_schema_from_dataset(ds_t)
    schema_j = jsynth.read_schema_from_dataset(ds_j)
    assert tsynth.dumps(schema_t) == jsynth.dumps(schema_j)
    buf = io.StringIO()
    tsynth.dump(schema_t, buf)
    buf.seek(0)
    back_j = jsynth.load(buf)
    buf = io.StringIO()
    jsynth.dump(schema_j, buf)
    buf.seek(0)
    back_t = tsynth.load(buf)
    gen_t = tsynth.generate(back_t, device="cpu")
    gen_j = jsynth.generate(back_j)
    for v in gen_j:
        np.testing.assert_array_equal(gen_t[v].values,
                                      np.asarray(gen_j[v].values))
    tz.to_zarr(ds_t, str(tmp_path / "port.zarr"))
    jz.to_zarr(ds_j, str(tmp_path / "ref.zarr"))
    for read, path, other in (
            (jsynth.read_schema_from_zarr, "port.zarr", schema_j),
            (tsynth.read_schema_from_zarr, "ref.zarr", schema_t)):
        schema = read(str(tmp_path / path))
        assert {k: (v.dims, v.shape, v.dtype)
                for k, v in schema.variables.items()} == {
            k: (list(v.dims), list(v.shape), v.dtype)
            for k, v in other.variables.items()}
    back = jz.open_zarr(str(tmp_path / "port.zarr"))
    for v in ds_j:
        np.testing.assert_array_equal(np.asarray(back[v].values),
                                      ds_t[v].values)


def test_synth_fine_res_files_and_cdl_both_packages(tmp_path):
    """generate_fine_res writes the per-time per-tile NetCDF files; the
    port's files equal the reference's; the CDL parser of both packages
    builds the same Dataset."""
    from fv3net_torch.core.netcdfio import open_tiles

    times = ["20160801.001500"]
    tsynth.generate_fine_res(str(tmp_path / "port"), times, nz=3, n=4,
                             device="cpu")
    jsynth.generate_fine_res(str(tmp_path / "ref"), times, nz=3, n=4)
    got = open_tiles(str(tmp_path / "port" / times[0]))
    want = open_tiles(str(tmp_path / "ref" / times[0]))
    assert sorted(got) == sorted(want)
    for v in want:
        np.testing.assert_array_equal(got[v].values, want[v].values)
    cdl = """
    netcdf x {
    dimensions:
        time = UNLIMITED ; // comment
        z = 3 ;
        y = 2 ;
    variables:
        double z(z) ;
        float T(z, y) ;
            T:units = "K" ;
            T:_FillValue = -9.f ;
        int n(y) ;
        :title = "synthetic" ;
    data:
        z = 1, 2, 3 ;
        T = 1, -9, _, 4, 5.5, NaN ;
        n = 7, 8 ;
    }
    """
    got = tsynth.cdl_to_dataset(cdl)
    want = jsynth.cdl_to_dataset(cdl)
    assert sorted(got) == sorted(want) == ["T", "n"]
    np.testing.assert_array_equal(got.coords["z"], want.coords["z"])
    for v in want:
        np.testing.assert_array_equal(got[v].values, np.asarray(
            want[v].values))
        assert got[v].attrs == want[v].attrs
    assert got.attrs == want.attrs == {"title": "synthetic"}
