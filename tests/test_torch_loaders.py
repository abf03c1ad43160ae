"""The port's training-data layer held against ``fv3net_tpu`` on seeded
float64 stores (C4, 6 levels, 4 times) that the port's zarrio writes and
both packages read: every mapper function and mapper class, the key
shuffle and subsample of ``batches_from_mapper``, the loader configs,
``to_local`` / ``Local`` and ``SerializedSequence`` both ways, the
``validate-batches-config`` CLIs, ``core/safe.py``, the ``fit/data.py``
loaders, every registered derived variable and every registered data
transform.  float64 throughout: equal values, or within RTOL where the
two packages compute in another order.  Below a subsample ratio of 1 the
reference's batches part their variables' columns (ROADMAP.md Queue 3),
so there the port is held against the reference's batches at ratio 1
cut to one draw of columns a batch."""
import datetime
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_port_util  # noqa: F401  (torch threads under xdist)

from fv3net_torch import data_transform as tdt
from fv3net_torch import derived as tderived
from fv3net_torch import loaders as tloaders
from fv3net_torch.core import safe as tsafe
from fv3net_torch.core import zarrio
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import data as tdata
from fv3net_torch.loaders import sequences as tseq
from fv3net_torch.loaders import validate as tvalidate

jax.config.update("jax_enable_x64", True)

N, NZ, NT = 4, 6, 4
D5, D4 = ("time", "tile", "z", "y", "x"), ("time", "tile", "y", "x")
# float64 arithmetic in another order (column sums, cumulative sums)
RTOL = 1e-12

SHIELD = ("DSWRFtoa_coarse", "DSWRFsfc_coarse", "USWRFtoa_coarse",
          "USWRFsfc_coarse", "DLWRFsfc_coarse", "ULWRFtoa_coarse",
          "ULWRFsfc_coarse", "SHTFLsfc_coarse", "LHTFLsfc_coarse",
          "PRATEsfc_coarse")


def _np(q):
    """A Quantity's data of either package as numpy."""
    data = q.data
    if torch.is_tensor(data):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def assert_same(got, want, rtol=0.0):
    """Two Datasets (port, reference): the same variables, dims and
    values (within ``rtol`` of each variable's scale)."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].dims) == tuple(want[k].dims), k
        g, w = _np(got[k]), _np(want[k])
        assert g.shape == w.shape, k
        if rtol == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            scale = max(np.nanmax(np.abs(w)), 1e-300)
            assert np.nanmax(np.abs(g - w)) <= rtol * scale, k
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))


def _field(rng, shape, lo, hi):
    return lo + (hi - lo) * rng.rand(*shape)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Seeded stores: a nudged run's state and its nudging tendencies (and
    a second state), a fine-res budget, SHiELD diagnostics and a SCREAM
    run; returns their paths."""
    d = tmp_path_factory.mktemp("stores")
    rng = np.random.RandomState(14)
    s3, s2 = (NT, 6, NZ, N, N), (NT, 6, N, N)

    def write(name, fields):
        zarrio.to_zarr(Dataset({
            k: Quantity(v, D5 if v.ndim == 5 else D4)
            for k, v in fields.items()}), str(d / name))
        return str(d / name)

    def state(seed):
        r = np.random.RandomState(seed)
        return {
            "air_temperature": _field(r, s3, 220, 300),
            "specific_humidity": _field(r, s3, 0, 0.02),
            "pressure_thickness_of_atmospheric_layer": _field(r, s3, 500,
                                                              3000),
            "physics_precip": _field(r, s2, 0, 1e-3),
            "total_precipitation_rate": _field(r, s2, 0, 1e-3),
        }

    paths = {"state": write("state.zarr", state(1)),
             "state2": write("state2.zarr", state(2))}
    paths["nudge"] = write("nudge.zarr", {
        "air_temperature_tendency_due_to_nudging": 1e-4 * rng.randn(*s3),
        "specific_humidity_tendency_due_to_nudging": 1e-7 * rng.randn(*s3),
        "t_dt_nudge": 1e-4 * rng.randn(*s3),
        "q_dt_nudge": 1e-7 * rng.randn(*s3),
        "u_dt_nudge": 1e-4 * rng.randn(*s3),
        "v_dt_nudge": 1e-4 * rng.randn(*s3),
    })
    paths["budget"] = write("budget.zarr", {k: scale * rng.randn(*s3) for k,
                                            scale in (
        ("Q1", 1e-4), ("Q2", 1e-7), ("dQ1", 1e-4), ("dQ2", 1e-7),
        ("T_storage", 1e-4), ("sphum_storage", 1e-7),
        ("tendency_of_air_temperature_due_to_dynamics", 1e-4),
        ("tendency_of_specific_humidity_due_to_dynamics", 1e-7),
        ("t_dt_nudge_coarse", 1e-5),
        ("tendency_of_air_temperature_due_to_fv3_physics", 1e-4),
        ("tendency_of_specific_humidity_due_to_fv3_physics", 1e-7),
        ("x_wind_tendency_due_to_nudging", 1e-4),
        ("y_wind_tendency_due_to_nudging", 1e-4))})
    paths["diags"] = write("diags.zarr", {
        k: _field(rng, s2, 0, 400) for k in SHIELD})
    paths["scream"] = write("scream.zarr", {
        "T_mid": _field(rng, s3, 220, 300), "qv": _field(rng, s3, 0, 0.02),
        "U": rng.randn(*s3), "V": rng.randn(*s3),
        "T_mid_tendency_due_to_nudging": 1e-4 * rng.randn(*s3),
        "qv_tendency_due_to_nudging": 1e-7 * rng.randn(*s3),
        "tendency_of_T_mid_due_to_scream_physics": 1e-4 * rng.randn(*s3)})
    paths["dir"] = str(d)
    return paths


MAPPERS = {
    "nudge_to_fine": ("open_nudge_to_fine", {
        "state_zarr": "state", "nudging_zarr": "nudge"}),
    "nudge_to_obs": ("open_nudge_to_obs", {
        "state_zarr": "state", "nudging_zarr": "nudge"}),
    "fine_res": ("open_fine_resolution", {"budget_zarr": "budget"}),
    "fine_res_plus_nudging": ("open_fine_resolution", {
        "budget_zarr": "budget", "nudging_zarr": "nudge",
        "approach": "apparent_sources_plus_nudging_tendencies"}),
    "fine_res_extend_lower": ("open_fine_resolution", {
        "budget_zarr": "budget",
        "approach": "apparent_sources_extend_lower"}),
    "fine_res_dynamics_difference": ("open_fine_resolution", {
        "budget_zarr": "budget", "approach": "dynamics_difference"}),
    "scream": ("open_nudge_to_fine_scream", {"state_zarr": "scream"}),
    "multiple_datasets": ("open_nudge_to_fine_multiple_datasets", {
        "data_path": "state", "additional_paths": ["state2"],
        "nudging_zarr": "nudge"}),
    "high_res_diags": ("open_high_res_diags", {"data_path": "diags"}),
    "hybrid": ("open_fine_resolution_nudging_hybrid", {
        "budget_zarr": "budget"}),
}


def _kwargs(stores, kwargs):
    def path(v):
        if isinstance(v, list):
            return [path(x) for x in v]
        return stores.get(v, v) if isinstance(v, str) else v

    return {k: path(v) for k, v in kwargs.items()}


@pytest.mark.parametrize("case", list(MAPPERS))
def test_mapper_functions_match_reference(stores, case):
    """Each registered mapper function through MapperConfig in both
    packages: the same keys, and at each key the same variables."""
    from fv3net_tpu import loaders as jloaders

    function, kwargs = MAPPERS[case]
    kwargs = _kwargs(stores, kwargs)
    got = tloaders.MapperConfig(function, kwargs).load_mapper()
    want = jloaders.MapperConfig(function, kwargs).load_mapper()
    assert list(got) == list(want) and len(got) == len(want) == NT
    for key in want:
        assert_same(got[key], want[key], RTOL)


def test_registries_and_mapper_classes_match_reference(stores):
    """The function registries hold the same names; SubsetTimes, KeyMap,
    ValMap, MergedMapper and MultiDatasetMapper over the port's
    ZarrMapper as over the reference's."""
    from fv3net_tpu import loaders as jloaders

    assert sorted(tloaders.mapper_functions) == sorted(
        jloaders.mapper_functions)
    assert sorted(tloaders.batches_functions) == sorted(
        jloaders.batches_functions)
    assert (tloaders.SAMPLE_DIM_NAME, tloaders.TIME_FMT) == (
        jloaders.SAMPLE_DIM_NAME, jloaders.TIME_FMT)
    for pkg in (tloaders, jloaders):
        with pytest.raises(ValueError):
            pkg.MapperConfig("open_nothing")
    built = []
    for pkg in (tloaders, jloaders):
        base = pkg.ZarrMapper(stores["state"])
        other = pkg.ZarrMapper(stores["nudge"])
        subset = pkg.SubsetTimes(1, 2, base)
        keyed = pkg.KeyMap(lambda k: f"t{k}", base)
        valued = pkg.ValMap(lambda ds: ds.rename({"physics_precip": "P"}),
                            base)
        merged = pkg.MergedMapper(base, other)
        multi = pkg.MultiDatasetMapper([base, base])
        built.append((subset, keyed, valued, merged, multi))
    for got, want in zip(*built):
        assert list(got) == list(want)
        for key in want:
            assert_same(got[key], want[key])
    with pytest.raises(KeyError):
        built[0][0]["0"]


def test_extend_lower_matches_reference():
    """_extend_lower: the lowest two levels take the value above them;
    too few levels raise in both."""
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.loaders import mappers as jmappers

    from fv3net_torch.loaders import mappers as tmappers

    x = np.random.RandomState(3).rand(6, NZ, N, N)
    got = tmappers._extend_lower(Quantity(torch.tensor(x), D5[1:]))
    want = jmappers._extend_lower(JQuantity(jnp.asarray(x), D5[1:]))
    np.testing.assert_array_equal(_np(got), np.asarray(want.data))
    assert (_np(got)[:, -2:] == x[:, -3:-2]).all()
    for pkg, Q, arr in ((tmappers, Quantity, torch.tensor(x[:, :2])),
                        (jmappers, JQuantity, jnp.asarray(x[:, :2]))):
        with pytest.raises(ValueError):
            pkg._extend_lower(Q(arr, D5[1:]))


def test_shuffle_and_sequences_match_reference():
    """shuffle draws the reference's order from RandomState(seed); Map,
    Take and OneAheadIterator."""
    from fv3net_tpu.loaders import sequences as jseq

    items = list(range(17))
    for seed in (0, 5, 11):
        assert list(tseq.shuffle(items, seed=seed)) == list(
            jseq.shuffle(items, seed=seed))
    m = tseq.Map(lambda x: x * 2, items)
    m.attrs["a"] = 1
    assert list(m[2:5]) == [4, 6, 8] and m[2:5].attrs == {"a": 1}
    assert list(m.take(3)) == [0, 2, 4]
    assert list(tseq.OneAheadIterator(items[:5], lambda x: x + 1)) == [
        1, 2, 3, 4, 5]
    with pytest.raises(TypeError):
        tseq.Map(lambda x: x, iter(items))


VARIABLES = ["air_temperature", "specific_humidity", "dQ1", "dQ2",
             "pressure_thickness_of_atmospheric_layer", "physics_precip",
             "total_precipitation_rate"]


def _nudged_mappers(stores):
    from fv3net_tpu import loaders as jloaders

    return (tloaders.open_nudge_to_fine(stores["state"], stores["nudge"]),
            jloaders.open_nudge_to_fine(stores["state"], stores["nudge"]))


def subsampled(full, ratio, seed, n_keys):
    """The reference's batches at ratio 1 (``full``, from ``n_keys`` keys
    shuffled with ``seed``) subsampled as upstream fv3fit does: after the
    key shuffle, one sorted draw of columns a batch from the same
    ``RandomState``, taken from every variable.  The reference draws a
    set for each variable, so its inputs and targets part (ROADMAP.md
    Queue 3): below ratio 1 the port is held against this."""
    rng = np.random.RandomState(seed)
    if seed is not None:
        rng.shuffle(list(range(n_keys)))
    out = []
    for batch in full:
        n = next(iter(batch.values())).shape[0]
        idx = np.sort(rng.choice(n, size=max(1, int(n * ratio)),
                                 replace=False))
        out.append(Dataset({k: Quantity(torch.as_tensor(_np(q)[idx]),
                                        q.dims) for k, q in batch.items()}))
    return out


@pytest.mark.parametrize("per_batch,ratio,seed", [(1, 1.0, None),
                                                  (2, 0.5, 3),
                                                  (1, 0.3, 0)])
def test_batches_from_mapper_matches_reference(stores, per_batch, ratio,
                                               seed):
    """The same keys in the same shuffled order: each batch equal to the
    reference's at ratio 1, and below it to the reference's batches at
    ratio 1 cut to one draw of columns a batch (``subsampled``)."""
    from fv3net_tpu import loaders as jloaders

    tm, jm = _nudged_mappers(stores)
    got = tloaders.batches_from_mapper(tm, VARIABLES, None, per_batch,
                                       ratio, seed)
    want = jloaders.batches_from_mapper(jm, VARIABLES, None, per_batch,
                                        1.0, seed)
    if ratio < 1.0:
        want = subsampled(want, ratio, seed, NT)
    assert len(got) == len(want) == -(-NT // per_batch)
    for g, w in zip(got, want):
        assert_same(g, w)
        assert torch.is_tensor(g["dQ1"].data)
    n = 6 * N * N * per_batch
    assert got[0]["dQ1"].shape[0] == (max(1, int(n * ratio)) if ratio < 1
                                      else n)


@pytest.mark.parametrize("per_batch,ratio", [(1, 0.5), (2, 0.25)])
def test_batches_from_mapper_subsample_keeps_columns_paired(per_batch,
                                                           ratio):
    """Below ratio 1 every variable of a batch keeps the same columns: a
    row of each input and of each target is one column, each column at
    most once, in the stacked order."""
    n = 6 * N * N
    column = np.arange(n, dtype=np.float64).reshape(6, N, N)
    level = np.arange(NZ, dtype=np.float64)[None, :, None, None]
    mapper = {}
    for t in range(NT):
        ident = column + 1000.0 * t
        mapper[str(t)] = Dataset({
            "x": Quantity(torch.as_tensor(100.0 * ident[:, None] + level),
                          D5[1:]),
            "y": Quantity(torch.as_tensor(-100.0 * ident[:, None] - level),
                          D5[1:]),
            "p": Quantity(torch.as_tensor(ident), D4[1:])})
    batches = tloaders.batches_from_mapper(mapper, ["x", "y", "p"], None,
                                           per_batch, ratio, 5)
    assert len(batches) == NT // per_batch
    for b in batches:
        x, y, p = (_np(b[k]) for k in ("x", "y", "p"))
        assert x.shape == (int(n * per_batch * ratio), NZ)
        np.testing.assert_array_equal(x[:, 0], 100.0 * p)
        np.testing.assert_array_equal(y, -x)
        np.testing.assert_array_equal(x - x[:, :1], np.broadcast_to(
            np.arange(NZ, dtype=np.float64), x.shape))
        # the stacked order: each time of the group in one run of rows,
        # its columns ascending, none twice
        times = np.floor(p / 1000.0)
        assert np.count_nonzero(np.diff(times)) == len(np.unique(times)) - 1
        for t in np.unique(times):
            assert np.all(np.diff(p[times == t]) > 0)


def test_batches_configs_match_reference(stores, tmp_path):
    """BatchesLoader.from_dict of a BatchesFromMapperConfig (variable
    names merged with the trainer's) and of a BatchesConfig over netCDF
    files; duplicated timesteps and unknown functions refuse; the legacy
    {kind, path, variables} dict."""
    from fv3net_tpu import loaders as jloaders

    from fv3net_torch.core.netcdfio import write_netcdf

    cfg = {"mapper_config": {"function": "open_nudge_to_fine", "kwargs": {
        "state_zarr": stores["state"], "nudging_zarr": stores["nudge"]}},
        "variable_names": VARIABLES[:3], "timesteps": ["2", "0", "3"],
        "subsample_ratio": 0.5, "shuffle_seed": 7}
    t = tloaders.BatchesLoader.from_dict(cfg)
    j = jloaders.BatchesLoader.from_dict(dict(cfg, subsample_ratio=1.0))
    assert type(t).__name__ == type(j).__name__ == "BatchesFromMapperConfig"
    got = t.load_batches(VARIABLES[2:])
    want = subsampled(j.load_batches(VARIABLES[2:]), 0.5, 7, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same(g, w)
    for bad in (dict(cfg, timesteps=["1", "1"]),
                dict(cfg, mapper_config={"function": "open_nothing"})):
        for pkg in (tloaders, jloaders):
            with pytest.raises(ValueError):
                pkg.BatchesLoader.from_dict(bad)

    rng = np.random.RandomState(2)
    for i in range(2):
        write_netcdf(Dataset({
            "air_temperature": Quantity(rng.rand(6, NZ, N, N), D5[1:]),
            "physics_precip": Quantity(rng.rand(6, N, N), D4[1:])}),
            str(tmp_path / f"{i:02d}.nc"))
    cfg = {"function": "batches_from_netcdf",
           "kwargs": {"path": str(tmp_path)}}
    t = tloaders.BatchesLoader.from_dict(cfg).load_batches(
        ["air_temperature"])
    j = jloaders.BatchesLoader.from_dict(cfg).load_batches(
        ["air_temperature"])
    assert len(t) == len(j) == 2
    for g, w in zip(t, j):
        assert_same(g, w)
    legacy = {"kind": "zarr", "path": stores["state"],
              "variables": VARIABLES[:2], "shuffle_seed": 1,
              "subsample_ratio": 0.5}
    want = subsampled(jloaders.batches_from_config(
        dict(legacy, subsample_ratio=1.0)), 0.5, 1, NT)
    got = tloaders.batches_from_config(legacy)
    assert len(got) == len(want) == NT
    for g, w in zip(got, want):
        assert_same(g, w)


def test_local_and_serialized_both_ways(stores, tmp_path):
    """to_local (threads) writes what the reference's Local reads and
    the other way round; SerializedSequence over a store chunked one
    time a chunk, items and flatten."""
    from fv3net_tpu import loaders as jloaders

    tm, jm = _nudged_mappers(stores)
    tb = tloaders.batches_from_mapper(tm, VARIABLES, shuffle_seed=1)
    jb = jloaders.batches_from_mapper(jm, VARIABLES, shuffle_seed=1)
    mine = tseq.to_local(tb, str(tmp_path / "port"), n_jobs=3)
    theirs = jloaders.Local(str(tmp_path / "port"))
    assert len(mine) == len(theirs) == NT
    jloaders.to_local(jb, str(tmp_path / "ref"), n_jobs=2)
    back = tloaders.Local(str(tmp_path / "ref"))
    for i in range(NT):
        assert_same(mine[i], theirs[i])
        assert_same(back[i], jb[i])

    path = str(tmp_path / "capture.zarr")
    zarrio.to_zarr(zarrio.open_zarr(stores["state"]), path,
                   chunks={"time": 1})
    got = tloaders.SerializedSequence(path, ["air_temperature",
                                             "physics_precip", "missing"])
    want = jloaders.SerializedSequence(path, ["air_temperature",
                                              "physics_precip", "missing"])
    assert len(got) == len(want) == NT
    assert_same(got[-1], want[-1])
    assert_same(got.flatten(), want.flatten())
    with pytest.raises(IndexError):
        got[NT]


VALIDATE_CASES = {
    "mapper": {"mapper_config": {"function": "open_nudge_to_fine",
                                 "kwargs": {"state_zarr": "state",
                                            "nudging_zarr": "nudge"}},
               "variable_names": ["dQ1"]},
    "unknown_function": {"mapper_config": {"function": "open_nothing"}},
    "legacy": {"kind": "zarr", "path": "state",
               "variables": ["air_temperature"]},
    "legacy_without_path": {"kind": "zarr", "variables": ["x"]},
    "open_fails": {"kind": "zarr", "path": "state", "variables": ["x"]},
}


@pytest.mark.parametrize("case", list(VALIDATE_CASES))
def test_validate_cli_matches_reference(stores, tmp_path, capsys, case):
    """Both packages' validate CLIs, with and without --open: the same
    verdict, problems and exit code."""
    from fv3net_tpu.loaders import validate as jvalidate

    cfg = VALIDATE_CASES[case]
    cfg = json.loads(json.dumps(cfg))
    if "path" in cfg:
        cfg["path"] = stores[cfg["path"]]
    if "mapper_config" in cfg and "kwargs" in cfg["mapper_config"]:
        cfg["mapper_config"]["kwargs"] = _kwargs(
            stores, cfg["mapper_config"]["kwargs"])
    path = tmp_path / "data.yaml"
    path.write_text(yaml.safe_dump(cfg))
    for extra in ([], ["--open"]):
        rc_t = tvalidate.main([str(path)] + extra)
        out_t = json.loads(capsys.readouterr().out)
        rc_j = jvalidate.main([str(path)] + extra)
        out_j = json.loads(capsys.readouterr().out)
        assert (rc_t, out_t["valid"]) == (rc_j, out_j["valid"]), extra
        assert len(out_t["problems"]) == len(out_j["problems"])
    assert out_t["valid"] == (case in ("mapper", "legacy"))


def test_safe_matches_reference():
    """get_variables (its error names every missing variable),
    stack_once, sample, train_test_split_sample, combine_array_sequence,
    warn_if_intersecting."""
    from fv3net_tpu.core import safe as jsafe
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    rng = np.random.RandomState(0)
    x = rng.rand(6, NZ, N, N)
    y = rng.rand(6, N, N)
    tds = Dataset({"x": Quantity(torch.tensor(x), D5[1:]),
                   "y": Quantity(torch.tensor(y), D4[1:])})
    jds = JDataset({"x": JQuantity(jnp.asarray(x), D5[1:]),
                    "y": JQuantity(jnp.asarray(y), D4[1:])})
    assert_same(tsafe.get_variables(tds, ["y"]),
                jsafe.get_variables(jds, ["y"]))
    with pytest.raises(KeyError, match="'a', 'b'"):
        tsafe.get_variables(tds, ["a", "x", "b"])
    for dims in (("tile", "y", "x"), ("y", "x")):
        assert_same(tsafe.stack_once(tds, "sample", dims),
                    jsafe.stack_once(jds, "sample", dims))
    with pytest.raises(ValueError):
        tsafe.stack_once(tds, "sample", ("z",))
    seq = [f"t{i:02d}" for i in range(12)]
    assert tsafe.sample(seq, 4, 3, seed=2) == jsafe.sample(seq, 4, 3, seed=2)
    assert tsafe.train_test_split_sample(seq, "t07", 3, 2, seed=1) == \
        jsafe.train_test_split_sample(seq, "t07", 3, 2, seed=1)
    items = [("a", (k1, k2), rng.rand(3)) for k1 in (2, 1) for k2 in "qp"]
    items.append(("b", (1, "p"), rng.rand(2, 2)))
    got = tsafe.combine_array_sequence(items, ("n", "c"))
    want = jsafe.combine_array_sequence(items, ("n", "c"))
    assert_same(got, want)
    assert {k: list(v) for k, v in got.coords.items()} == \
        {k: list(v) for k, v in want.coords.items()}
    with pytest.warns(UserWarning):
        tsafe.warn_if_intersecting(["a", "b"], ["b"])


def test_fit_data_loaders_match_reference(stores):
    """WindowedZarrLoader (seeded windows and samples), SyntheticNoise,
    FromBatches and the dispatch of tfdataset_loader_from_dict."""
    from fv3net_tpu.fit import data as jdata

    win = {"data_path": stores["state"], "unstacked_dims": ["z"],
           "window_size": 2, "batch_size": 3, "n_windows": 3, "seed": 4}
    cases = [
        (win, ["air_temperature", "physics_precip"]),
        (dict(win, unstacked_dims=["tile", "z", "y", "x"], window_size=1,
              batch_size=1, time_stride=2), ["air_temperature"]),
        ({"nsamples": 2, "nbatch": 3, "ntime": 2, "nx": 4, "nz": 3,
          "seed": 6}, ["a", "b"]),
        ({"mapper_config": {"function": "open_nudge_to_fine", "kwargs": {
            "state_zarr": stores["state"], "nudging_zarr": stores["nudge"]}},
          "subsample_ratio": 0.5}, ["dQ1", "air_temperature"]),
    ]
    for cfg, names in cases:
        t = tdata.tfdataset_loader_from_dict(cfg)
        ratio = cfg.get("subsample_ratio", 1.0)
        j = jdata.tfdataset_loader_from_dict(
            dict(cfg, subsample_ratio=1.0) if ratio < 1.0 else cfg)
        assert type(t).__name__ == type(j).__name__
        got = t.open_tfdataset(None, names)
        want = j.open_tfdataset(None, names)
        if ratio < 1.0:  # the config's default shuffle_seed, 0
            want = subsampled(want, ratio, 0, NT)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    for pkg in (tdata, jdata):
        with pytest.raises(ValueError):
            pkg.tfdataset_loader_from_dict({"nothing": 1})
        with pytest.raises(ValueError):
            pkg.WindowedZarrLoader(stores["state"], ["z"], 9).open_tfdataset(
                None, ["air_temperature"])


# ----------------------------------------------------- derived variables
DELP = "pressure_thickness_of_atmospheric_layer"
FLUX_NAMES = (
    "total_sky_downward_shortwave_flux_at_top_of_atmosphere",
    "total_sky_upward_shortwave_flux_at_top_of_atmosphere",
    "total_sky_upward_longwave_flux_at_top_of_atmosphere",
    "total_sky_downward_shortwave_flux_at_surface",
    "total_sky_upward_shortwave_flux_at_surface",
    "total_sky_downward_longwave_flux_at_surface",
    "total_sky_upward_longwave_flux_at_surface",
    "override_for_time_adjusted_total_sky_downward_shortwave_flux_at_"
    "surface",
    "latent_heat_flux", "sensible_heat_flux",
    "surface_precipitation_rate",
    "storage_of_internal_energy_path_due_to_fine_res_temperature_nudging",
)


def _inputs(seed=0):
    """name -> (numpy array, dims) of every input the registered derived
    variables and data transforms read, on (tile, z, y, x)."""
    rng = np.random.RandomState(seed)
    s3, s2 = (6, NZ, N, N), (6, N, N)
    d3, d2, di = D5[1:], D4[1:], ("tile", "z_interface", "y", "x")
    out = {
        "air_temperature": (_field(rng, s3, 220, 300), d3),
        "specific_humidity": (_field(rng, s3, 1e-5, 0.02), d3),
        "eastward_wind": (rng.randn(*s3), d3),
        "northward_wind": (rng.randn(*s3), d3),
        DELP: (_field(rng, s3, 500, 3000), d3),
        "cloud_amount": (np.where(rng.rand(*s3) < 0.3, 1e-4,
                                  rng.rand(*s3)), d3),
        "cloud_water_mixing_ratio": (1e-4 * rng.rand(*s3), d3),
        "cloud_ice_mixing_ratio": (1e-5 * rng.rand(*s3), d3),
        "incloud_water_mixing_ratio": (1e-4 * rng.rand(*s3), d3),
        "incloud_ice_mixing_ratio": (1e-5 * rng.rand(*s3), d3),
        "lon": (_field(rng, s2, 0, 360), d2),
        "lat": (_field(rng, s2, -90, 90), d2),
        "land_sea_mask": (rng.randint(0, 3, s2).astype(np.float64), d2),
        "surface_diffused_shortwave_albedo": (rng.rand(*s2), d2),
        "Qm_flux": (100 * rng.randn(6, NZ + 1, N, N), di),
        "Q2_flux": (1e-4 * rng.randn(6, NZ + 1, N, N), di),
        "implied_downward_radiative_flux_at_surface": (
            _field(rng, s2, 0, 400), d2),
        "implied_surface_precipitation_rate": (_field(rng, s2, 0, 1e-3),
                                               d2),
    }
    for k, scale in (("dQ1", 1e-4), ("dQ2", 1e-7), ("Q1", 1e-4),
                     ("Q2", 1e-7), ("Qm", 1.0), ("dQu", 1e-4),
                     ("dQv", 1e-4), ("pQ1", 1e-4), ("pQ2", 1e-7)):
        out[k] = (scale * rng.randn(*s3), d3)
    for k in FLUX_NAMES:
        flux = _field(rng, s2, 0, 400)
        if k.startswith("total_sky_downward_shortwave_flux_at_top"):
            flux[0] = 0.0  # night: the transmissivity's other branch
        out[k] = (flux, d2)
    return out


def _both(arrays, names):
    """The named inputs as a dict of port and one of reference
    Quantities."""
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    t = {k: Quantity(torch.tensor(arrays[k][0]), arrays[k][1])
         for k in names}
    j = {k: JQuantity(jnp.asarray(arrays[k][0]), arrays[k][1])
         for k in names}
    return t, j


def test_derived_registry_matches_reference():
    from fv3net_tpu.derived import DerivedMapping as JDerived

    T = tderived.DerivedMapping
    assert sorted(T.VARIABLES) == sorted(JDerived.VARIABLES)
    assert T.REQUIRED_INPUTS == JDerived.REQUIRED_INPUTS
    assert T.USE_NONDERIVED_IF_EXISTS == JDerived.USE_NONDERIVED_IF_EXISTS
    for name in T.VARIABLES:
        assert T.find_all_required_inputs([name]) == \
            JDerived.find_all_required_inputs([name]), name


@pytest.mark.parametrize("name", sorted(tderived.DerivedMapping.VARIABLES))
def test_derived_variable_matches_reference(name):
    """Each registered derived variable on seeded inputs (the ones that
    may pass through computed, not passed through), and passed through
    where the mapping has it and may use it."""
    from fv3net_tpu.derived import DerivedMapping as JDerived

    arrays = _inputs()
    skip = {name} if name in tderived.DerivedMapping.USE_NONDERIVED_IF_EXISTS \
        and name not in ("dQu", "dQv") else set()
    if name == "Q1":
        skip |= {"pQ1"}
    if name == "Q2":
        skip |= {"pQ2"}
    t, j = _both(arrays, [k for k in arrays if k not in skip])
    when = datetime.datetime(2016, 8, 1, 6, 30)
    t["time"] = j["time"] = when
    got = tderived.DerivedMapping(t)[name]
    want = JDerived(j)[name]
    assert tuple(got.dims) == tuple(want.dims)
    g, w = _np(got), np.asarray(want.data)
    scale = max(np.abs(w).max(), 1e-300)
    assert np.abs(g - w).max() <= RTOL * scale, name
    assert set(tderived.DerivedMapping(t)) == set(JDerived(j))
    if name in tderived.DerivedMapping.USE_NONDERIVED_IF_EXISTS and \
            name in arrays:
        t, j = _both(arrays, list(arrays))
        np.testing.assert_array_equal(
            _np(tderived.DerivedMapping(t)[name]), arrays[name][0])


# --------------------------------------------------------- transforms
def test_transform_registry_matches_reference():
    from fv3net_tpu import data_transform as jdt

    assert sorted(tdt.DATA_TRANSFORM_REGISTRY) == sorted(
        jdt.DATA_TRANSFORM_REGISTRY)
    for name, entry in tdt.DATA_TRANSFORM_REGISTRY.items():
        ref = jdt.DATA_TRANSFORM_REGISTRY[name]
        assert (entry.inputs, entry.outputs) == (ref.inputs, ref.outputs)
    chain = [{"name": "Qm_from_Q1_Q2"},
             {"name": "Qm_flux_from_Qm_tendency",
              "kwargs": {"rectify_downward_radiative_flux": False}},
             {"name": "Qm_tendency_from_Qm_flux"}]
    t = tdt.ChainedDataTransform([tdt.DataTransform(**c) for c in chain])
    j = jdt.ChainedDataTransform([jdt.DataTransform(**c) for c in chain])
    assert t.input_variables == j.input_variables
    assert t.output_variables == j.output_variables
    np.testing.assert_array_equal(
        tdt.vertical_tapering_scale_factors(NZ, 3, 2.0),
        jdt.vertical_tapering_scale_factors(NZ, 3, 2.0))


TRANSFORM_KWARGS = {
    "tapered_dQ1": {"cutoff": 3, "rate": 2.0},
    "Qm_flux_from_Qm_tendency": {"rectify_downward_radiative_flux": True,
                                 "include_temperature_nudging": True},
    "Q2_flux_from_Q2_tendency": {"rectify_surface_precipitation_rate":
                                 False},
}


@pytest.mark.parametrize("name", sorted(tdt.DATA_TRANSFORM_REGISTRY))
def test_data_transform_matches_reference(name):
    """Each registered transform on seeded inputs: its outputs."""
    from fv3net_tpu import data_transform as jdt
    from fv3net_tpu.core.dataset import Dataset as JDataset

    arrays = _inputs(seed=1)
    entry = tdt.DATA_TRANSFORM_REGISTRY[name]
    t, j = _both(arrays, entry.inputs)
    kwargs = TRANSFORM_KWARGS.get(name, {})
    got = tdt.DataTransform(name, kwargs).apply(Dataset(t))
    want = jdt.DataTransform(name, kwargs).apply(JDataset(j))
    for k in entry.outputs:
        assert tuple(got[k].dims) == tuple(want[k].dims), k
        g, w = _np(got[k]), np.asarray(want[k].data)
        scale = max(np.abs(w).max(), 1e-300)
        assert np.abs(g - w).max() <= RTOL * scale, (name, k)


def test_flux_and_tendency_round_trip():
    """Q2 -> its flux form -> Q2 again (unrectified: exact inverse up to
    roundoff), in the port as in the reference."""
    arrays = _inputs(seed=2)
    names = ["Q2", DELP, "latent_heat_flux"]
    t, _ = _both(arrays, names)
    ds = tdt.ChainedDataTransform([
        tdt.DataTransform("Q2_flux_from_Q2_tendency",
                          {"rectify_surface_precipitation_rate": False}),
        tdt.DataTransform("Q2_tendency_from_Q2_flux")]).apply(
            Dataset(dict(t)))
    w = arrays["Q2"][0]
    assert np.abs(_np(ds["Q2"]) - w).max() <= 1e-9 * np.abs(w).max()
