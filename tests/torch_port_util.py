"""Shared inputs and comparisons for the ``tests/test_torch_*.py`` files,
which hold ``fv3net_torch`` against ``fv3net_tpu`` on the same numpy
inputs.  Every one of them imports this module, which gives torch's
intra-op pool of a pytest-xdist worker its share of the host's cores."""
import contextlib
import os

import numpy as np


def _share_torch_threads():
    """Under pytest-xdist, torch's intra-op threads of each worker: the
    usable cores over the workers (at least 1).  torch's default, every
    core in every worker, oversubscribes the host by the number of
    workers, and the port's many small CPU ops then wait on each other's
    threads: a C4 RRTMG chunk took 20 times as long so."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        import torch

        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // workers))


_share_torch_threads()


@contextlib.contextmanager
def serial_solves():
    """torch's intra-op pool at one thread inside the block.  Batched LU
    solves (``torch.linalg.solve`` over a batch of systems of a few
    hundred rows, as the subdomain reservoir's trainer makes) hang in
    torch 2.13.0+cpu with MKL 2024.2 and OpenMP once
    ``torch.set_num_threads`` has set the pool to 2-7 threads, as
    ``_share_torch_threads`` may (MKL reports DLASWP's parameter 6 as
    incorrect); at one thread, or at the default, they do not."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


class Float64Module(object):
    """A module (numpy or jax.numpy) with its ``float32`` read as
    float64: a reference module whose ``np``/``jnp`` are replaced by it
    casts to float64 where it casts to float32."""

    def __init__(self, module, f64):
        self._module = module
        self.float32 = f64

    def __getattr__(self, name):
        return getattr(self._module, name)


def handover(trees, dtype=None):
    """A stand-in for an init function of the port that returns the next
    of ``trees`` (reference pytrees of arrays) as tensors (in ``dtype``
    if given) on the device it is asked for, whatever else it is asked:
    the reference's initial weights."""
    import torch

    it = iter(trees)

    def convert(node, device):
        if isinstance(node, dict):
            return {k: convert(v, device) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v, device) for v in node)
        return torch.tensor(np.asarray(node), dtype=dtype, device=device)

    def init(*args, device=None, **kwargs):
        return convert(next(it), device)

    return init


def make_state_numpy(npx: int, npz: int, seed: int = 0, moist: bool = False):
    """A perturbed, moving numpy state on the hybrid coordinate, plus its
    grid and (ak, bk).

    Starts from the reference's isothermal rest state (or, with
    ``moist``, a lapse-rate profile near saturation that triggers
    convection), then adds smooth winds, surface-pressure and theta_v
    structure and seeded noise.
    """
    from fv3net_torch.core.constants import KAPPA, RDGAS, RVGAS
    from fv3net_torch.dycore.vertical import hybrid_coordinate
    from fv3net_torch.grid.geometry import make_grid

    rng = np.random.RandomState(seed)
    grid = make_grid(npx)
    ak, bk = hybrid_coordinate(npz)
    n = grid.n
    lat, lon = grid.lat, grid.lon
    ps = 1.0e5 + 800.0 * np.cos(2 * lat) * np.sin(lon) + 50.0 * rng.randn(6, n, n)
    pe = ak[None, :, None, None] + bk[None, :, None, None] * ps[:, None]
    delp = np.diff(pe, axis=1)
    pmid = delp / np.diff(np.log(pe), axis=1)
    if moist:
        T = np.maximum(300.0 * (pmid / 1.0e5) ** 0.22, 205.0)
        T = T - 10.0 * np.sin(lat[:, None]) ** 2
        es = 610.94 * np.exp(17.625 * (T - 273.15) / (T - 273.15 + 243.04))
        qsat = 0.622 * es / (pmid - 0.378 * es)
        q = 0.9 * qsat * (pmid / 1.0e5) ** 0.5 * (1 + 0.05 * rng.rand(*T.shape))
        q = np.minimum(q, 0.03)
    else:
        T = 280.0 + 8.0 * np.cos(lat[:, None]) ** 2 + 0.2 * rng.randn(6, npz, n, n)
        es = 610.94 * np.exp(17.625 * (280.0 - 273.15) / (280.0 - 273.15 + 243.04))
        q = 0.5 * 0.622 * es / (pmid - 0.378 * es) * (pmid / 1.0e5) ** 2
        q = q * (1 + 0.2 * rng.rand(*q.shape))
    tv = T * (1.0 + (RVGAS / RDGAS - 1.0) * q)
    pt = tv * (1.0e5 / pmid) ** KAPPA
    u = (15.0 * np.cos(lat) + rng.randn(6, n, n))[:, None] * np.linspace(0.3, 1.0, npz)[None, :, None, None]
    v = (3.0 * np.sin(2 * lon) * np.cos(lat))[:, None] + 0.5 * rng.randn(6, npz, n, n)
    east = np.moveaxis(grid.east, -1, 0)[:, :, None]
    north = np.moveaxis(grid.north, -1, 0)[:, :, None]
    wind = u[None] * east + v[None] * north
    state = {
        "delp": delp,
        "pt": pt,
        "wind": wind,
        "tracers": {
            "sphum": q,
            "cloud_water": 1e-5 * rng.rand(6, npz, n, n),
        },
        "phis": np.zeros((6, n, n)),
    }
    return state, grid, ak, bk


def jax_state(state, dtype):
    """The numpy state as the reference package's DycoreState."""
    import jax.numpy as jnp
    from fv3net_tpu.dycore.state import DycoreState

    def opt(name):
        x = state.get(name)
        return None if x is None else jnp.asarray(x, dtype)

    return DycoreState(
        delp=jnp.asarray(state["delp"], dtype),
        pt=jnp.asarray(state["pt"], dtype),
        wind=jnp.asarray(state["wind"], dtype),
        tracers={k: jnp.asarray(v, dtype) for k, v in state["tracers"].items()},
        phis=jnp.asarray(state["phis"], dtype),
        w=opt("w"),
        delz=opt("delz"),
    )


def flat_fields(state):
    """name -> numpy array for either package's state."""
    out = {
        "delp": np.asarray(state.delp),
        "pt": np.asarray(state.pt),
        "wind": np.asarray(state.wind),
    }
    for k, v in state.tracers.items():
        out[k] = np.asarray(v)
    for k in ("w", "delz"):  # the nonhydrostatic prognostics
        if getattr(state, k, None) is not None:
            out[k] = np.asarray(getattr(state, k))
    return out


def rel_diff(got, want):
    """max |got - want| / max |want| (the field's scale)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    return np.abs(got - want).max() / scale


def assert_states_close(got, want, rtol, fields=None):
    """Each field's max abs difference is within ``rtol`` of its scale."""
    g = flat_fields(got)
    w = flat_fields(want)
    assert set(g) == set(w), (sorted(g), sorted(w))
    diffs = {k: rel_diff(g[k], w[k]) for k in (fields or w)}
    bad = {k: d for k, d in diffs.items() if not d <= rtol}
    assert not bad, f"fields beyond rel {rtol}: {bad} (all: {diffs})"
    return diffs


def column_state(C, L, seed=0):
    """Radiation-driver inputs of C seeded columns of L levels on the
    hybrid coordinate (z index 0 = model top), with clouds in half the
    layers; returns ``(state, cosz)``."""
    from fv3net_torch.dycore.vertical import hybrid_coordinate

    rng = np.random.RandomState(seed)
    ak, bk = hybrid_coordinate(L)
    pe = ak[None] + bk[None] * (1e5 + 3000 * rng.randn(C))[:, None]
    pmid = 0.5 * (pe[:, 1:] + pe[:, :-1])
    T = np.maximum(290 * (pmid / 1e5) ** 0.2, 200) + 3 * rng.randn(C, L)
    lat = rng.uniform(-1.4, 1.4, C)
    lon = rng.uniform(0, 6.28, C)
    state = {
        "air_temperature": T,
        "pressure_thickness_of_atmospheric_layer": np.diff(pe, axis=1),
        "specific_humidity": 0.02 * (pmid / 1e5) ** 3 * rng.rand(C, L) ** 2,
        "cloud_water_mixing_ratio": 1e-4 * rng.rand(C, L) * (
            rng.rand(C, L) > 0.5),
        "surface_temperature": T[:, -1] + 1,
        "latitude": lat,
        "longitude": lon,
        "land_sea_mask": (rng.rand(C) > 0.7).astype(np.float64),
    }
    return state, np.clip(np.cos(lat) * np.cos(lon), -0.3, 1)


#: the fields of the microphysics emulator's state (physics_step's
#: emulation hook)
EMULATOR_FIELDS = ("air_temperature", "specific_humidity",
                   "cloud_water_mixing_ratio")


def _emulator_sample(npz):
    """A seeded batch of 256 columns of the emulator's fields and its
    packing."""
    from fv3net_torch.fit.packer import PackingInfo

    rng = np.random.RandomState(0)
    X = np.concatenate([260 + 30 * rng.rand(256, npz),
                        0.01 * rng.rand(256, npz),
                        1e-4 * rng.rand(256, npz)], axis=1)
    return rng, X, PackingInfo(list(EMULATOR_FIELDS), [npz] * 3)


def dry_emulator_model(npz, dtype, device="cpu"):
    """A port DenseModel of the emulator's fields that is exactly q ->
    0.99 q with T and cloud water passed through: one hidden ReLU layer
    [I, -I] (relu(x) - relu(-x) = x makes the map linear in normalized
    space), both scalers of zero mean and the sample's std, so that the
    map keeps each value's sign and q >= 0."""
    import torch

    from fv3net_torch.fit.dense import DenseModel
    from fv3net_torch.fit.normalize import StandardScaler

    _, X, info = _emulator_sample(npz)
    std = StandardScaler.fit(torch.tensor(X, dtype=dtype,
                                          device=device)).std
    m = np.ones(3 * npz)
    m[npz:2 * npz] = 0.99
    eye = np.eye(3 * npz)
    w = [np.concatenate([eye, -eye], axis=1),
         np.concatenate([np.diag(m), -np.diag(m)], axis=0)]
    params = [{"w": torch.tensor(wi, dtype=dtype, device=device),
               "b": torch.zeros(wi.shape[1], dtype=dtype, device=device)}
              for wi in w]
    return DenseModel(
        input_variables=info.names, output_variables=info.names,
        params=params, input_info=info, output_info=info,
        x_scaler=StandardScaler(torch.zeros_like(std), std),
        y_scaler=StandardScaler(torch.zeros_like(std), std.clone()))


def seeded_emulator_model(npz, dtype, device="cpu"):
    """A port DenseModel of the emulator's fields with one hidden layer of
    16, untrained He-normal weights from a ``torch.Generator`` seeded
    with 0, its scalers from the seeded sample."""
    import torch

    from fv3net_torch.fit.dense import DenseModel, init_mlp_params
    from fv3net_torch.fit.normalize import StandardScaler

    rng, X, info = _emulator_sample(npz)
    params = init_mlp_params(torch.Generator().manual_seed(0),
                             [3 * npz, 16, 3 * npz], dtype=dtype,
                             device=device)
    Y = X * (1.0 + 0.01 * rng.randn(*X.shape))
    return DenseModel(
        input_variables=info.names, output_variables=info.names,
        params=params, input_info=info, output_info=info,
        x_scaler=StandardScaler.fit(torch.tensor(X, dtype=dtype,
                                                 device=device)),
        y_scaler=StandardScaler.fit(torch.tensor(Y, dtype=dtype,
                                                 device=device)))


# ------------------------------------------------ the sharded layout
#: the halo-exchange cases of tests/test_torch_sharded.py: C12 so that h =
#: 3 fits the (4, 1) and (1, 4) layouts' 3-cell blocks
SHARDED_N = 12
SHARDED_LAYOUTS = ((2, 2), (4, 1), (1, 4))
SHARDED_HALOS = (1, 2, 3)


def sharded_field(h):
    """The seeded global field [6, 2, n, n] (float64) each exchange case
    appends an h-deep halo to."""
    rng = np.random.RandomState(100 + h)
    return rng.randn(6, 2, SHARDED_N, SHARDED_N)


def sharded_segment_config(layout):
    """A C8 production run (slab ocean, sea ice, RRTMG, 2-step chunks,
    two chunks) with per-chunk and interval-averaged diagnostics, on
    ``layout``."""
    return {
        "namelist": {"npx": 8, "npz": 8, "layout": list(layout),
                     "radiation": "rrtmg", "slab_ocean": True,
                     "sea_ice": True},
        "duration_seconds": 3600.0,
        "fused_chunk_steps": 2,
        "diagnostics": [
            {"name": "state.zarr",
             "variables": ["air_temperature", "specific_humidity",
                           "eastward_wind", "surface_pressure"],
             "times": {"kind": "every"}},
            {"name": "diags.zarr",
             "variables": ["total_precipitation", "ULWRFtoa", "DSWRFsfc",
                           "water_vapor_path"],
             "times": {"kind": "interval-average", "frequency": 3600.0}},
        ],
    }


def sharded_worker(out_dir, threads):
    """Run by each of 4 gloo CPU ranks (``parallel.sharded.launch``) with
    ``threads`` torch threads: the block halo exchange at every layout
    and halo width, the dry run in float32 and float64, a write_sharded /
    read_sharded round trip and a C8 ``run_segment`` on a (2, 2) layout
    (rank 0 then runs it on one process, into another directory).
    Returns this rank's readings."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)

    from fv3net_torch import entry
    from fv3net_torch.core import zarrio
    from fv3net_torch.core.sharded_io import read_sharded, write_sharded
    from fv3net_torch.parallel import sharded, shardmap_halo
    from fv3net_torch.parallel.halo import no_explicit_halo
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.segmented_run import api

    out = {"rank": dist.get_rank(), "halo": {}}
    for layout in SHARDED_LAYOUTS:
        mesh = sharded.make_mesh(layout=layout)
        for h in SHARDED_HALOS:
            block = sharded.shard_yx(torch.tensor(sharded_field(h)), mesh)
            out["halo"][layout, h] = (
                mesh.rc,
                shardmap_halo.halo_append_shardmap(block, h, mesh).numpy())
        blocks = shardmap_halo.halo_blocks_shardmap(block, 3, mesh)
        out["halo"][layout, "blocks"] = shardmap_halo.blocks_to_global(
            blocks, 3).numpy()

    out["dry32"] = entry.dryrun_multigpu(4, torch.float32, "cpu",
                                         c384=False)
    out["dry64"] = entry.dryrun_multigpu(4, torch.float64, "cpu",
                                         c384=False)

    mesh = sharded.make_mesh(layout=(2, 2))
    rng = np.random.RandomState(7)
    full = torch.tensor(rng.randn(6, 3, 8, 8))
    grp = zarrio.ZarrGroup.create(os.path.join(out_dir, "io.zarr"))
    write_sharded(grp, "x", sharded.shard_yx(full, mesh),
                  dims=("tile", "z", "y", "x"), mesh=mesh)
    out["io"] = {"whole": grp["x"].read(),
                 "block": read_sharded(grp, "x", mesh=mesh).numpy(),
                 "want_block": sharded.shard_yx(full, mesh).numpy(),
                 "chunks": grp["x"].chunks}

    seg = os.path.join(out_dir, "sharded")
    loop = api.run_segment(get_config(sharded_segment_config((2, 2))), seg,
                           device="cpu", dtype=torch.float64)
    out["segment_counts"] = (tuple(loop.state.dycore.delp.shape),
                             loop.mesh.layout)
    dist.barrier()
    if out["rank"] == 0:
        with no_explicit_halo():
            api.run_segment(get_config(sharded_segment_config((1, 1))),
                            os.path.join(out_dir, "single"), device="cpu",
                            dtype=torch.float64)
    return out


def group_probe(tag, hold=0.0):
    """Run by each rank of a small launch: what this rank sees of its
    process group, its size, its rank and every member's ``tag`` and
    process id; the group is then held ``hold`` seconds, so that launches
    started together overlap."""
    import os
    import time

    import torch.distributed as dist

    members = [None] * dist.get_world_size()
    dist.all_gather_object(members, (tag, os.getpid()))
    time.sleep(hold)
    dist.barrier()
    return {"world": dist.get_world_size(), "rank": dist.get_rank(),
            "members": members}


def foreign_token_worker():
    """Run by each rank of a launch: checks its group against a token of
    its own, which no other rank holds, as a rank that met another
    launch's ranks would see them."""
    import torch.distributed as dist

    from fv3net_torch.parallel import sharded

    sharded._check_group(dist.get_world_size(), f"token{dist.get_rank()}")


#: the rank whose step raises in ``sharded_failing_worker``
FAILING_RANK = 2


def sharded_failing_worker(out_dir, threads):
    """Run by each of 4 gloo CPU ranks: the C8 ``run_segment`` of
    ``sharded_worker`` on a (2, 2) layout, in which rank FAILING_RANK
    raises as its second chunk starts (its error first written to
    ``rank<r>.error``), while the others go into that chunk's halo
    exchanges."""
    import os

    import torch
    import torch.distributed as dist

    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.segmented_run import api

    torch.set_num_threads(threads)
    if dist.get_rank() == FAILING_RANK:
        orig, calls = TimeLoop.chunk_inputs, []

        def chunk_inputs(self, n):
            calls.append(n)
            if len(calls) == 2:
                msg = "injected failure in the second chunk"
                with open(os.path.join(out_dir, f"rank{FAILING_RANK}.error"),
                          "w") as f:
                    f.write(msg)
                raise RuntimeError(msg)
            return orig(self, n)

        TimeLoop.chunk_inputs = chunk_inputs
    api.run_segment(get_config(sharded_segment_config((2, 2))), out_dir,
                    device="cpu", dtype=torch.float64)


# ------------------------------------- steppers under the sharded layout
#: the per-step runs of ``stepper_worker``: C8, 8 levels, float64, two
#: steps on a (2, 1) layout
STEPPER_LAYOUT = (2, 1)


def stepper_config(out_dir, layout, kind):
    """A C8 per-step run of two steps with the steppers of ``kind``:
    "nudging" (the nudger and a prephysics tendency prescriber, their
    stores in ``out_dir``) or "reservoir" (the subdomain corrector of the
    model in ``out_dir``/model, predicting on the second step)."""
    import os

    cfg = {"namelist": {"npx": 8, "npz": 8, "layout": list(layout)},
           "duration_seconds": 1800.0}
    if kind == "nudging":
        cfg["nudging"] = {
            "restarts_path": os.path.join(out_dir, "nudge.zarr"),
            "timescale_hours": {"air_temperature": 3.0,
                                "specific_humidity": 3.0,
                                "eastward_wind": 3.0,
                                "pressure_thickness_of_atmospheric_layer":
                                    3.0}}
        cfg["prephysics"] = [{
            "kind": "tendency_prescriber",
            "dataset": os.path.join(out_dir, "tendencies.zarr"),
            "variables": ["dQ1", "dQ2"],
            "limit_quantiles": {"upper": 0.99, "lower": 0.01}}]
    else:
        cfg["reservoir_corrector"] = {
            "model_path": os.path.join(out_dir, "model"),
            "synchronize_steps": 1, "reservoir_timestep_seconds": 900.0}
    return cfg


def stepper_worker(out_dir, threads, kind):
    """Run by each of 2 gloo CPU ranks: ``stepper_config(kind)`` on the
    (2, 1) layout through the TimeLoop's per-step path; rank 0 then runs
    it on one process.  Returns this rank's block of the state fields,
    the block's slices, the reservoir state (for "reservoir") and rank
    0's one-process readings."""
    import torch
    import torch.distributed as dist

    from fv3net_torch.parallel.halo import no_explicit_halo
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop

    torch.set_num_threads(threads)
    fields = ("air_temperature", "specific_humidity", "eastward_wind",
              "northward_wind", "pressure_thickness_of_atmospheric_layer")

    def run(layout):
        loop = TimeLoop(get_config(stepper_config(out_dir, layout, kind)),
                        dtype=torch.float64, device="cpu")
        for _ in loop:
            pass
        st = loop._derived()
        out = {"state": {k: st[k].data.numpy() for k in fields}}
        if kind == "reservoir":
            out["reservoir_state"] = (
                loop._reservoir_predictor.model.state.numpy())
        return loop, out

    loop, out = run(STEPPER_LAYOUT)
    out["block"] = loop.mesh.block(8)
    dist.barrier()
    if dist.get_rank() == 0:
        with no_explicit_halo():
            _, single = run((1, 1))
        out["single"] = single["state"]
        out["single_reservoir_state"] = single.get("reservoir_state")
    return out


def reservoir_worker(out_dir, threads):
    return stepper_worker(out_dir, threads, "reservoir")


def column_reservoir_worker(out_dir, threads):
    """Run by each of 2 gloo CPU ranks: the column corrector of the model
    in ``out_dir``/column on the (2, 1) layout over two segments of two
    steps, the second warm-started from what ``save_reservoir_state``
    saved after the first; rank 0 then runs the same on one process from
    its own copy of the model (``out_dir``/column_single).  Returns this
    rank's block of the state after the second segment, the block's
    slices, the rank's reservoir state just after the warm start, the
    saved file's state and rank 0's one-process readings."""
    import os

    import torch
    import torch.distributed as dist

    from fv3net_torch.parallel.halo import no_explicit_halo
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.steppers.reservoir import save_reservoir_state

    torch.set_num_threads(threads)
    fields = ("air_temperature", "specific_humidity", "eastward_wind",
              "northward_wind", "pressure_thickness_of_atmospheric_layer")

    def run(layout, model):
        cfg = stepper_config(out_dir, layout, "reservoir")
        rc = cfg["reservoir_corrector"]
        rc["model_path"] = os.path.join(out_dir, model)
        loop = TimeLoop(get_config(cfg), dtype=torch.float64, device="cpu")
        for _ in loop:
            pass
        path = save_reservoir_state(loop._reservoir_predictor.model,
                                    rc["model_path"])
        rc["warm_start"] = True
        loop = TimeLoop(get_config(cfg), dtype=torch.float64, device="cpu")
        out = {"warm_state":
               loop._reservoir_predictor.model.state.numpy().copy()}
        for _ in loop:
            pass
        st = loop._derived()
        out["state"] = {k: st[k].data.numpy() for k in fields}
        with np.load(path) as z:
            out["saved"] = z["state"]
        return loop, out

    loop, out = run(STEPPER_LAYOUT, "column")
    out["block"] = loop.mesh.block(8)
    dist.barrier()
    if dist.get_rank() == 0:
        with no_explicit_halo():
            _, out["single"] = run((1, 1), "column_single")
    return out


def nudging_worker(out_dir, threads):
    return stepper_worker(out_dir, threads, "nudging")


def _fields(payload: bytes):
    """(field number, value) pairs of a protobuf message: varints as
    ints, fixed64/fixed32 and length-delimited fields as bytes."""
    out, i = [], 0
    while i < len(payload):
        key, i = _varint(payload, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(payload, i)
        elif wire == 1:
            value, i = payload[i:i + 8], i + 8
        elif wire == 5:
            value, i = payload[i:i + 4], i + 4
        else:
            n, i = _varint(payload, i)
            value, i = payload[i:i + n], i + n
        out.append((field, value))
    return out


def _varint(b: bytes, i: int):
    value, shift = 0, 0
    while True:
        value |= (b[i] & 0x7F) << shift
        i += 1
        if not b[i - 1] & 0x80:
            return value, i
        shift += 7


def event_summary(event: bytes):
    """An Event's step and its summary values as (tag, simple_value
    bytes, image bytes or None)."""
    fields = dict(_fields(event))
    values = []
    for field, value in _fields(fields.get(5, b"")):
        v = dict(_fields(value))
        values.append((v[1].decode(), v.get(2), v.get(4)))
    return fields.get(2), values
