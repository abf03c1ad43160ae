"""Entry points of the port: the flagship C48 hybrid chunk with RRTMG
radiation (counterpart of ``__graft_entry__._flagship``) and the
production chunk around it (the reference entry's production
configuration, ``__graft_entry__.py:293-408``).

    step, (state, ml_params, sst, cosz) = flagship(device="cuda")
    state = step(state, ml_params, sst, cosz)   # one 8-step chunk

    chunk, (dycore, surface, cosz, prescribed) = production(device="cuda")
    dycore, surface, diags = chunk(dycore, surface, cosz, prescribed)
"""
from __future__ import annotations

import numpy as np
import torch

from fv3net_torch.dycore.core import DycoreConfig, GridArrays
from fv3net_torch.dycore.state import init_state
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit.dense import (
    DenseHyperparameters,
    DenseModel,
    train_dense_model,
)
from fv3net_torch.grid.geometry import make_grid
from fv3net_torch.physics.driver import PhysicsConfig
from fv3net_torch.runtime.fused import (
    aquaplanet_sst,
    build_fused_multi_step,
    build_fused_step,
    ml_correction_fn,
)

#: the flagship dynamics configuration (hydrostatic PPM, kord=9, remap_te)
FLAGSHIP_DYCORE = DycoreConfig(
    dt=900.0, n_split=2, kord=9, advection_order=4, diff_coef=0.004,
    divergence_damp_coef=0.06, remap_te=True,
)


#: the production chunk's dynamics (the reference entry's ``prod_dyn``:
#: hydrostatic PPM, kord=9, without the energy-conserving remap)
PRODUCTION_DYCORE = DycoreConfig(
    dt=900.0, n_split=2, kord=9, advection_order=4, diff_coef=0.004,
    divergence_damp_coef=0.06,
)


def entry_batch(npz: int, dtype=torch.float32, device="cuda",
                seed: int = 0, n: int = 256,
                dq_scale=(1e-5, 1e-8)) -> Dataset:
    """The reference entries' training samples (``__graft_entry__.py:
    47-79``): ``n`` numpy samples from ``np.random.RandomState(seed)``
    (T, q and tendencies of the scales ``dq_scale``) on ``device`` in
    ``dtype``."""
    rng = np.random.RandomState(seed)
    columns = {
        "air_temperature": 260 + 30 * rng.rand(n, npz),
        "specific_humidity": 0.01 * rng.rand(n, npz),
        "dQ1": dq_scale[0] * rng.randn(n, npz),
        "dQ2": dq_scale[1] * rng.randn(n, npz),
    }
    return Dataset({
        k: Quantity(torch.tensor(v, dtype=dtype, device=device),
                    ("sample", "z"))
        for k, v in columns.items()
    })


def train_entry_model(npz: int, dtype=torch.float32, device="cuda",
                      seed: int = 0, hidden=(128, 128), n: int = 256,
                      dq_scale=(1e-5, 1e-8)) -> DenseModel:
    """The reference entries' dQ1/dQ2 dense model, trained as they train
    it (``__graft_entry__.py:47-79``, ``:313-348``): the samples of
    :func:`entry_batch`, ``hidden`` layers of one width, one epoch of
    :func:`~fv3net_torch.fit.dense.train_dense_model` on ``device`` in
    ``dtype``.  The initial weights are the port's He-normal draws
    seeded with ``seed``: the reference's distribution, not its
    numbers, so the trained model is not the reference's either."""
    hp = DenseHyperparameters(
        input_variables=["air_temperature", "specific_humidity"],
        output_variables=["dQ1", "dQ2"],
        hidden_layers=len(hidden), width=hidden[0], epochs=1, seed=seed,
    )
    return train_dense_model(
        hp, [entry_batch(npz, dtype, device, seed, n, dq_scale)])


def flagship(npx: int = 48, npz: int = 32, radiation: str = "rrtmg",
             chunk: int = 8, radiation_interval: int = 4,
             dtype=torch.float32, device="cuda", seed: int = 0,
             impl: str = None, lw_taumol: str = "ktable",
             rrtmg_options: dict = None):
    """The flagship hybrid configuration: PPM dynamics, GFS-style column
    physics with RRTMG LW+SW (or ``radiation="gray"``, or the synthetic
    band model ``"synthband"``) every ``radiation_interval`` steps, and
    the in-step dense ML correction.

    ``chunk=None`` returns a single step; ``chunk=N`` the N-step chunk.
    Returns ``(step, (state, ml_params, sst, cosz))``.  ``impl`` selects
    the kernels' versions, the vertical remap and the k-table selections
    (None: the CUDA kernels on a CUDA device).  RRTMG computes in
    ``dtype``; ``lw_taumol`` routes its LW gas optics: "ktable" through
    the k-table selections, "mega" through the one-launch kernel;
    ``rrtmg_options`` sets fields of its ``RRTMGConfig`` (for example
    the reference's accelerator settings, ``storage_dtype="bfloat16"``
    and ``compress_daylight=True``).
    """
    grid = make_grid(npx)
    g = GridArrays.from_grid(grid, dtype=dtype, device=device)
    state, ak, bk = init_state(grid, npz, dtype=dtype, device=device)
    phys_cfg = PhysicsConfig(radiation_scheme=radiation)

    ml_apply, ml_params = ml_correction_fn(
        train_entry_model(npz, dtype, device, seed)
    )

    akt = torch.tensor(ak, dtype=dtype, device=device)
    bkt = torch.tensor(bk, dtype=dtype, device=device)
    if chunk:
        step = build_fused_multi_step(
            g, akt, bkt, FLAGSHIP_DYCORE, phys_cfg, ml_apply,
            n_steps=chunk, radiation_interval=radiation_interval, impl=impl,
            lw_taumol=lw_taumol, rrtmg_options=rrtmg_options,
        )
    else:
        step = build_fused_step(g, akt, bkt, FLAGSHIP_DYCORE, phys_cfg,
                                ml_apply, impl=impl, lw_taumol=lw_taumol,
                                rrtmg_options=rrtmg_options)
    sst = aquaplanet_sst(g.lat)
    cosz = torch.tensor(np.cos(grid.lat) * np.cos(grid.lon), dtype=dtype,
                        device=device)
    return step, (state, ml_params, sst, cosz)


def production(npx: int = 48, npz: int = 32, radiation: str = "rrtmg",
               chunk: int = 8, radiation_interval: int = 4,
               land_model: str = "", land_mask=None, sgh=None,
               model: DenseModel = None, dtype=torch.float32,
               device="cuda", seed: int = 0, impl: str = None):
    """The reference entry's production configuration: the namelist's
    RRTMG (or ``radiation="gray"``), slab ocean and sea ice, hydrostatic;
    the dynamics of :data:`PRODUCTION_DYCORE`; radiation every
    ``radiation_interval`` steps; an aquaplanet SST that one "set"
    prephysics stepper resets every step; and a dense
    :class:`~fv3net_torch.runtime.steppers.machine_learning.PureMLStepper`
    (1 hidden layer of 16) trained as the reference entry trains it
    (:func:`train_entry_model`: 64 samples, one epoch); ``model`` takes
    another (for example one trained by the reference package, carried
    over by :func:`~fv3net_torch.fit.dense.params_from_jax`).

    The land variant: ``land_model`` ("bucket" or "noah"), a ``land_mask``
    [6, npx, npx] (1 on land; default all ocean) and ``sgh`` [6, npx,
    npx], the subgrid orography's standard deviation in m (default none:
    no gravity-wave drag), both numpy arrays; the land fields start as
    the reference's TimeLoop starts them.

    Returns ``(chunk, (dycore, surface, cosz, prescribed))``, with
    ``chunk(dycore, surface, cosz, prescribed) -> (dycore, surface,
    diags)`` the ``chunk``-step production chunk.  ``impl`` selects the
    kernels' versions (None: the CUDA kernels on a CUDA device).
    """
    from fv3net_torch.physics.land import BucketLandParams
    from fv3net_torch.physics.soil import SoilParams
    from fv3net_torch.runtime import names
    from fv3net_torch.runtime.config import NamelistConfig
    from fv3net_torch.runtime.fused import build_fused_production_chunk
    from fv3net_torch.runtime.steppers.machine_learning import PureMLStepper

    nml = NamelistConfig(
        npx=npx, npz=npz, dt_atmos=PRODUCTION_DYCORE.dt,
        n_split=PRODUCTION_DYCORE.n_split, radiation=radiation,
        slab_ocean=True, sea_ice=True, hydrostatic=True,
        land_model=land_model,
    )
    grid = make_grid(npx)
    g = GridArrays.from_grid(grid, dtype=dtype, device=device)
    dycore, ak, bk = init_state(grid, npz, dtype=dtype, device=device)
    if model is None:
        model = train_entry_model(npz, dtype, device, seed, hidden=(16,),
                                  n=64, dq_scale=(1e-6, 1e-9))
    step = build_fused_production_chunk(
        g, torch.tensor(ak, dtype=dtype, device=device),
        torch.tensor(bk, dtype=dtype, device=device), PRODUCTION_DYCORE,
        PhysicsConfig(radiation_scheme=radiation), nml,
        ml_stepper=PureMLStepper(model, timestep=PRODUCTION_DYCORE.dt),
        n_steps=chunk, radiation_interval=radiation_interval,
        prephysics_kinds=("set",), impl=impl,
    )

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    sst = aquaplanet_sst(g.lat)
    zeros = torch.zeros_like(sst)
    surface = {
        names.TSFC: sst,
        names.SST: sst.clone(),
        names.MASK: zeros if land_mask is None else t(land_mask),
        "ice_thickness": zeros,
        names.TOTAL_PRECIP: zeros,
    }
    if sgh is not None:
        surface["sgh"] = t(sgh)
    if nml.bucket_land:
        p = BucketLandParams(field_capacity_m=nml.bucket_capacity_m)
        surface["soil_moisture"] = torch.full_like(
            sst, p.initial_fraction * p.field_capacity_m)
    if nml.land_model == "noah":
        nl = len(SoilParams().dz)
        surface["soil_temperature"] = sst.expand(nl, *sst.shape).clone()
        surface["soil_moisture_layers"] = torch.full(
            (nl, *sst.shape), 0.25, dtype=dtype, device=device)
        surface["snow_water_equivalent"] = zeros
        surface["deep_soil_temperature"] = torch.clamp(sst, 271.0, 300.0)
    prescribed = ({names.SST: sst.expand(chunk, *sst.shape).clone()},)
    cosz = t(np.cos(grid.lat) * np.cos(grid.lon))
    return step, (dycore, surface, cosz, prescribed)


# ---------------------------------------------------------------------------
# the sharded dry run
# ---------------------------------------------------------------------------
#: the dry run's bounds by dtype: relative max differences against one
#: device.  float32: the reference dry run's (``__graft_entry__.py:240-244``,
#: ``:483-487``, ``:496-502``, ``:611-614``), but the training step's,
#: which is the port's (the reference checks only that its loss is
#: finite), float32 roundoff of one step.  float64: the tight control,
#: which a halo or collective fault cannot meet (as the reference's
#: ``test_production_chunk_f64_control_collapses_tolerance``).
DRYRUN_BOUNDS = {
    torch.float32: {"step": 2e-5, "chunk": 5e-3, "write": 0.0,
                    "train": 1e-5, "c384": 1e-3},
    torch.float64: {"step": 1e-10, "chunk": 1e-10, "write": 0.0,
                    "train": 1e-12, "c384": 1e-10},
}


def _maxrel(a: torch.Tensor, b: torch.Tensor, floor: float = 0.0):
    """(max |a - b|, that over max(max |b|, floor) (1 where b is 0))."""
    d = float((a.double() - b.double()).abs().max())
    scale = max(float(b.abs().max()), floor) or 1.0
    return d, d / scale


def dryrun_multigpu(world_size: int, dtype=torch.float32, device="cuda",
                    c384: bool = True) -> dict:
    """The counterpart of ``__graft_entry__.py::dryrun_multichip``, run on
    every rank of an initialised ``torch.distributed`` process group of
    ``world_size`` ranks: each rank computes its block on ``device`` in
    ``dtype``, and rank 0 also computes each case on its own device,
    holds the sharded result against it and shares the readings.

    The layout is the reference's: ``default_layout(world_size)``, turned
    to px > py where the two differ; C``max(8, 2 lcm(py, px))``, 32
    levels.  The checks, each against one device, relative to the
    field's scale:

    - step: one nonhydrostatic step with RRTMG (pt, delp, wind, w);
    - chunk: the 8-step production chunk (slab ocean, sea ice, an SST
      prescriber, the radiation cache, the trained 1 x 16 dense model);
    - write: ``write_sharded`` of the chunk's pt read back whole, and
      ``read_sharded`` of each block, exactly;
    - train: one data-parallel Adam step of a [2 npz, 64, 2 npz] MLP (a
      batch of 8 per rank; gradients all-reduced and averaged) against
      the step on the whole batch;
    - c384: the C384 case (8 levels, gray radiation, slab ocean, dt 300,
      n_split 1, one step); ``c384=False`` leaves it out, for the CPU,
      where its single-device step alone takes longer than the tests'
      time allows.

    The bounds are :data:`DRYRUN_BOUNDS` of ``dtype``.  Rank 0 prints the
    reference's JSON summary line; then every rank raises
    ``AssertionError`` if a reading exceeds its bound.  Returns the
    summary, with this rank's K1/K4/K3 launches in the sharded and (rank
    0) single-device cases."""
    import json
    import math
    import tempfile
    import time

    import torch.distributed as dist

    from fv3net_torch.core import zarrio
    from fv3net_torch.core.sharded_io import read_sharded, write_sharded
    from fv3net_torch.dycore.state import add_nonhydrostatic_fields
    from fv3net_torch.fit.config import OptimizerConfig
    from fv3net_torch.fit.dense import init_mlp_params, mlp_apply
    from fv3net_torch.ops import ktable_cuda, remap_cuda
    from fv3net_torch.parallel import sharded
    from fv3net_torch.parallel.halo import no_explicit_halo
    from fv3net_torch.runtime import names
    from fv3net_torch.runtime.config import NamelistConfig
    from fv3net_torch.runtime.fused import build_fused_production_chunk
    from fv3net_torch.runtime.steppers.machine_learning import PureMLStepper

    bounds = DRYRUN_BOUNDS[dtype]
    py0, px0 = sharded.default_layout(world_size)
    mesh = sharded.make_mesh(world_size, layout=(px0, py0))
    py, px = mesh.layout
    rank = mesh.rank
    npx, npz = max(8, 2 * math.lcm(py, px)), 32
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def launches():
        return (remap_cuda.LAUNCHES, ktable_cuda.SELECT_LAUNCHES,
                ktable_cuda.SPEC_LAUNCHES)

    def timed(fn):
        """(fn(), seconds, (K1, K4, K3) launches)."""
        sync()
        before = launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (out, time.perf_counter() - t0,
                tuple(a - b for a, b in zip(launches(), before)))

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def shared(obj):
        """rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        return box[0]

    def compare(sharded_fields, single_fields, floors=None):
        """rank 0: {name: (abs, rel)} of the gathered sharded fields
        against the single-device ones."""
        out = {}
        for k, x in sharded_fields.items():
            full = sharded.gather(x, mesh)
            if rank == 0:
                out[k] = _maxrel(full, single_fields[k],
                                 (floors or {}).get(k, 0.0))
        return out

    def single(fn):
        """rank 0: ``fn()`` on its own device, timed; None elsewhere."""
        if rank:
            return None, None, None
        with no_explicit_halo():
            return timed(fn)

    summary = {"n_devices": world_size, "mesh_layout": [py, px],
               "npx": npx, "npz": npz, "dtype": str(dtype).split(".")[-1],
               "rank": rank}
    readings, walls, counts = {}, {}, {}

    # ---- one nonhydrostatic RRTMG step ----------------------------------
    grid = make_grid(npx)
    g = GridArrays.from_grid(grid, dtype=dtype, device=device)
    state, ak, bk = init_state(grid, npz, dtype=dtype, device=device)
    state = add_nonhydrostatic_fields(state)
    akt, bkt = t(ak), t(bk)
    sst = aquaplanet_sst(g.lat)
    cosz = t(np.cos(grid.lat) * np.cos(grid.lon))
    dyn = DycoreConfig(dt=900.0, n_split=2, kord=9, advection_order=4,
                       diff_coef=0.004, divergence_damp_coef=0.06,
                       hydrostatic=False)
    phys = PhysicsConfig(radiation_scheme="rrtmg")
    gs = sharded.shard_grid(g, mesh)
    step_s = build_fused_step(gs, akt, bkt, dyn, phys)
    out_s, walls["sharded_step"], counts["sharded_step"] = timed(
        lambda: step_s(sharded.shard_state(state, mesh), 0,
                       sharded.shard_yx(sst, mesh),
                       sharded.shard_yx(cosz, mesh)))
    out_1, walls["single_step"], counts["single_step"] = single(
        lambda: build_fused_step(g, akt, bkt, dyn, phys)(state, 0, sst,
                                                         cosz))
    def fields(s):
        return {"pt": s.pt, "delp": s.delp, "wind": s.wind, "w": s.w}

    readings["step"] = compare(fields(out_s), out_1 and fields(out_1),
                               {"w": 1e-6})

    # ---- a data-parallel training step ----------------------------------
    params = init_mlp_params(torch.Generator().manual_seed(0),
                             [2 * npz, 64, 2 * npz], dtype, device)
    bs = 8 * world_size
    X = t(torch.randn((bs, 2 * npz), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1)))
    Y = t(torch.randn((bs, 2 * npz), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(2)))

    def train_step(xb, yb, reduce):
        leaves = [p[k].clone().requires_grad_(True)
                  for p in params for k in ("w", "b")]
        layers = [{"w": leaves[i], "b": leaves[i + 1]}
                  for i in range(0, len(leaves), 2)]
        with torch.enable_grad():
            loss = torch.mean((mlp_apply(layers, xb) - yb) ** 2)
            grads = torch.autograd.grad(loss, leaves)
        if reduce:  # the mean over the ranks' equal shares of the batch
            grads = [sharded.all_reduce(gr) / world_size for gr in grads]
        OptimizerConfig("adam", {"learning_rate": 1e-3}).instance.step(
            leaves, grads)
        return torch.cat([x.detach().reshape(-1) for x in leaves])

    mine = slice(rank * 8, (rank + 1) * 8)
    p_s, walls["dp_training_step"], _ = timed(
        lambda: train_step(X[mine], Y[mine], True))
    p_1, _, _ = single(lambda: train_step(X, Y, False))
    readings["train"] = ({"params": _maxrel(p_s, p_1)} if rank == 0
                         else {})

    # ---- the 8-step production chunk ------------------------------------
    n_steps = 8
    nml = NamelistConfig(npx=npx, npz=npz, dt_atmos=900.0, n_split=2,
                         radiation="rrtmg", slab_ocean=True, sea_ice=True,
                         hydrostatic=True)
    prod_state, pak, pbk = init_state(grid, npz, dtype=dtype, device=device)
    zeros = torch.zeros_like(sst)
    surface = {names.TSFC: sst, names.SST: sst.clone(), names.MASK: zeros,
               "ice_thickness": zeros, names.TOTAL_PRECIP: zeros}
    presc = {names.SST: sst.expand(n_steps, *sst.shape).clone()}
    stepper = PureMLStepper(
        train_entry_model(npz, dtype, device, 0, hidden=(16,), n=64,
                          dq_scale=(1e-6, 1e-9)), timestep=900.0)

    def chunk_on(gg, st, sfc, cz, pr):
        fn = build_fused_production_chunk(
            gg, t(pak), t(pbk), PRODUCTION_DYCORE, phys, nml,
            ml_stepper=stepper, n_steps=n_steps, radiation_interval=4,
            prephysics_kinds=("set",))
        return fn(st, sfc, cz, (pr,))

    (pd_s, ps_s, praw_s), walls["production_chunk_sharded"], \
        counts["production_chunk_sharded"] = timed(lambda: chunk_on(
            gs, sharded.shard_state(prod_state, mesh),
            {k: sharded.shard_yx(v, mesh) for k, v in surface.items()},
            sharded.shard_yx(cosz, mesh),
            {k: sharded.shard_yx(v, mesh) for k, v in presc.items()}))
    single_chunk, walls["production_chunk_single"], \
        counts["production_chunk_single"] = single(
            lambda: chunk_on(g, prod_state, surface, cosz, presc))
    fields_s = {"pt": pd_s.pt, "delp": pd_s.delp, "wind": pd_s.wind,
                "surface_temperature": ps_s[names.TSFC],
                "total_precipitation": praw_s[names.TOTAL_PRECIP]}
    fields_1 = None
    if single_chunk is not None:
        pd_1, ps_1, praw_1 = single_chunk
        fields_1 = {"pt": pd_1.pt, "delp": pd_1.delp, "wind": pd_1.wind,
                    "surface_temperature": ps_1[names.TSFC],
                    "total_precipitation": praw_1[names.TOTAL_PRECIP]}
    readings["chunk"] = compare(fields_s, fields_1)

    # ---- write_sharded / read_sharded -----------------------------------
    zdir = shared(tempfile.mkdtemp(prefix="dryrun_sharded_zarr_")
                  if rank == 0 else None)
    if rank == 0:
        zarrio.ZarrGroup.create(zdir)
    dist.barrier(group=mesh.group)
    grp = zarrio.ZarrGroup(zdir)
    write_sharded(grp, "air_temperature", pd_s.pt,
                  dims=("tile", "z", "y", "x"), mesh=mesh)
    mine_back = read_sharded(grp, "air_temperature", mesh=mesh,
                             device=device)
    full_pt = sharded.gather(pd_s.pt, mesh)
    back = torch.as_tensor(grp["air_temperature"].read(), device=device)
    readings["write"] = {
        k: (sharded.global_max((a - b).abs().max()).item(), 0.0)
        for k, (a, b) in {"air_temperature": (back, full_pt),
                          "read_sharded": (mine_back, pd_s.pt)}.items()}

    # ---- the C384 case ---------------------------------------------------
    if c384:
        readings["c384"], c384_walls, c384_counts = _dryrun_c384(
            mesh, dtype, device, timed, single, compare)
        walls.update(c384_walls)
        counts.update(c384_counts)

    readings = shared(readings)
    summary["counts"] = counts
    summary["wall_seconds"] = walls
    checks = {
        "multichip_numerics": "step", "production_chunk_numerics": "chunk",
        "write_sharded_roundtrip": "write", "dp_training_step": "train",
        "c384_production_chunk": "c384"}
    failures = []
    for key, case in checks.items():
        if case not in readings:
            continue
        summary[key] = {
            "max_abs_diff_vs_single_device": {
                k: v[0] for k, v in readings[case].items()},
            "max_rel_diff_vs_single_device": {
                k: v[1] for k, v in readings[case].items()},
            "bound": bounds[case],
        }
        for k, (d, r) in readings[case].items():
            if case == "chunk" and k == "total_precipitation":
                continue  # read, not bounded (as in the reference)
            if (d if case == "write" else r) > bounds[case]:
                failures.append(f"{case} {k}: {d:.3e} abs, {r:.3e} rel > "
                                f"{bounds[case]:.1e}")
    summary["failures"] = failures
    if rank == 0:
        print(json.dumps({k: v for k, v in summary.items()
                          if k not in ("rank", "counts")}))
    if failures:
        raise AssertionError("sharded-vs-single mismatch: "
                             + "; ".join(failures))
    return summary


def _dryrun_c384(mesh, dtype, device, timed, single, compare):
    """The reference dry run's C384 case (``__graft_entry__.py:503-620``):
    8 levels, gray radiation, slab ocean, dt 300 s, n_split 1, one step
    from a perturbed rest state, sharded against one device."""
    from fv3net_torch.parallel import sharded
    from fv3net_torch.runtime import names
    from fv3net_torch.runtime.config import NamelistConfig
    from fv3net_torch.runtime.fused import build_fused_production_chunk

    npx, npz = 384, 8
    grid = make_grid(npx)
    g = GridArrays.from_grid(grid, dtype=dtype, device=device)
    st, ak, bk = init_state(grid, npz, dtype=dtype, device=device,
                            perturbation=1.0)
    nml = NamelistConfig(npx=npx, npz=npz, slab_ocean=True,
                         radiation="gray")
    dyn = DycoreConfig(dt=300.0, n_split=1, kord=9, advection_order=4,
                       divergence_damp_coef=0.06)
    phys = PhysicsConfig(radiation_scheme="gray")
    sst = aquaplanet_sst(g.lat)
    zeros = torch.zeros_like(sst)
    sfc = {names.TSFC: sst, names.SST: sst.clone(), names.MASK: zeros,
           names.TOTAL_PRECIP: zeros}
    cz = torch.clamp(torch.cos(g.lat) * torch.cos(g.lon), 0.0, 1.0)
    akt = torch.tensor(ak, dtype=dtype, device=device)
    bkt = torch.tensor(bk, dtype=dtype, device=device)

    def run(gg, s, f, c):
        return build_fused_production_chunk(
            gg, akt, bkt, dyn, phys, nml, n_steps=1,
            radiation_interval=1)(s, f, c, ())

    walls, counts = {}, {}
    (d_s, _, _), walls["c384_sharded"], counts["c384_sharded"] = timed(
        lambda: run(sharded.shard_grid(g, mesh),
                    sharded.shard_state(st, mesh),
                    {k: sharded.shard_yx(v, mesh) for k, v in sfc.items()},
                    sharded.shard_yx(cz, mesh)))
    one, walls["c384_single"], counts["c384_single"] = single(
        lambda: run(g, st, sfc, cz))
    def fields(d):
        return {"pt": d.pt, "delp": d.delp, "wind": d.wind}

    return (compare(fields(d_s), one and fields(one[0])), walls, counts)
