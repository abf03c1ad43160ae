#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fv3net_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, and no result line is printed):

1. device: a CUDA card is required (there is no CPU path); prints the
   card's name and power limit and the torch / CUDA versions;
2. build: compiles the port's four CUDA sources for sm_90a from this
   checkout, one ``nvcc`` each, all at once: ``remap_apply.cu`` (K1),
   ``ktable.cu`` (K4 and K3), ``taumol_lw.cu`` (K2) and ``wavg.cu`` (K5),
   with nvcc's register and spill lines and how K3 and K2 launch (points
   per tile, shared memory, blocks an SM holds);
3. K1 against its plain PyTorch version on the card on the dycore
   step's three calls (C48, npz=32, F = 3, 2, 1 fields on one search;
   float32 and float64), with times, their sum per step beside the sum of
   their bounds, and one call at km=79;
4. gray main path: ``entry.flagship(radiation="gray")`` -- C48, npz=32,
   float32 on cuda:0 -- one warm-up and one timed 8-step chunk, with its
   K1 launch count;
5. RRTMG main path: ``entry.flagship()`` (RRTMG LW+SW every 4th step,
   dense ML 2x128, 8-step chunks, float32) and the same chunk with the
   LW gas optics through K2 (``entry.flagship(lw_taumol="mega")``),
   their chunks taken in turns -- one warm-up chunk each, then 5 timed
   chunks of each: ms per chunk, SYPD, finite
   fields, air-mass drift and the exact launch counts per chunk (K1, K4
   and K3; on the second route fewer K4 and K3 and 2 K2); then one chunk
   of each under ``torch.profiler`` with its device time split by the
   step's ranges (dynamics, radiation, physics, ml), each hand kernel
   counted in the range that launched it;
6. one RRTMG radiation call alone on the first route's state after its
   4th chunk: its time on both routes, OLR and the SW fluxes (the
   down-flux at the top from ``RRTMGDriver`` itself) inside physical
   ranges; then, on the states after its 3rd and its 4th chunk, the same
   float32 call on both routes against the plain versions beside two
   controls (the plain call in float64, and with bfloat16 tables): every
   heating rate and flux parts by at most twice what float32 itself errs
   there, the bfloat16 control by at least 3 times what the kernels do,
   and on the last state within absolute bounds; one LW call alone on
   each route;
7. K4 and K3 against their plain versions on every call that radiation
   call made, all of each kernel's calls timed together beside the sum of
   their bounds, then, on four of its calls (K4 on ``selfref_all`` and
   ``mtab_lo1``, K3 on an LW lower and an SW upper band), float32 and
   float64 times of the kernel, the plain version and
   ``torch.nn.functional.embedding_bag`` (the library-call yardstick,
   never used by the port), with the bytes each call must move;
8. the same state through one step with the kernels and with the plain
   versions: the float32 dynamics step and the float64 gray step within
   1e-5, the float64 RRTMG step (radiation in float64) on both routes
   within 1e-10 of each field's scale (the float32 RRTMG step is logged
   only);
9. K2 against its plain version on the arguments of that radiation call
   (N = 442,368 points): float32 within 2e-6 of each output's scale,
   float64 within 1e-12 (and each value within the same, relative to
   itself), NaN at the same points, with the times of K2,
   of the plain version and of the K3/K4 route beside the bound;
10. K5 against its plain version on the pipeline's two calls (x
    [6, 79, 384, 384] with a weight plane per tile [6, 1, 384, 384], and
    [6, 384, 384] with [6, 384, 384]; random weights), at
    [474, 384, 384] with [384, 384] weights, factor 8, and at
    [6, 12, 12], factor 2, with the times of K5, of the plain version and
    of ``avg_pool2d(x * w) / avg_pool2d(w)`` (the library-call yardstick,
    never used by the port);
11. the coarsening pipeline: a seeded C384 diagnostics zarr (a
    [time, tile, y, x] and a [time, tile, z=79, y, x] variable) through
    ``coarsen_diagnostics(..., 8)`` on the card: shapes, one K5 launch
    per variable and time, every value against the plain block average,
    area-weighted global means kept;
12. production main path: ``entry.production()`` -- C48, npz=32,
    float32: slab ocean and sea ice, the "set" SST prescriber, RRTMG every
    4th step and the dense ML stepper around the production dynamics
    (kord 9 without the energy remap, so K1 remaps theta_v with iv=2) --
    one warm-up, 5 timed chunks and one profiled chunk: ms per chunk,
    SYPD, device busy and idle share, the ranges' device busy (prephysics,
    dynamics, radiation, physics, ml) with the hand kernels in; gates:
    every field finite, the exact launches of K1, K4 and K3 per chunk and
    no K2, SST inside [200, 330] K, ice thickness >= 0, the chunk's
    TOTAL_PRECIP >= 0 and the dry-air budget (DRY_MASS_BUDGET_RTOL);
13. the production chunk, 2 float64 steps at C48 with radiation every
    second step, with the kernels and with the plain versions: the
    dycore fields, every surface field, TOTAL_PRECIP and the
    chunk-accumulated water within 1e-8 of each field's scale;
14. the production chunk's land variant (Noah soil on tile 0 under a
    seeded subgrid orography): one chunk with phase 12's gates, soil
    moisture inside [0, theta_sat] and the gravity-wave drag's launched
    stress >= 0, and > 0 over the land.

``--sw-columns PATH`` also saves, in phase 6, ``swrad``'s arguments on
the 8 columns where the float32 SW heating parts most from float64 on
the state after the ktable route's 3rd chunk (the input of
``tests/test_torch_rrtmg.py``'s float32 SW test).

Kernel times are device times (CUDA events around calls queued behind a
sleep kernel, so that the device runs them back to back, or the
profiler's sum of a call's device activities where the call waits on the
device; the host's work between launches is in neither).

    python3 chip_smoke.py --kernel-times [--tree DIR]

instead builds K1-K4 of DIR's ``fv3net_torch`` (default: the one
beside this script), logs the registers, stack, shared and local memory
of K3's and K2's instances (``cuobjdump``), and times them on one
yardstick, device time beside the CUDA events of one call with the
wrapper's host work in, with a digest of K3's and K2's outputs, so that
two trees (a change and its parent) compare call by call; see
:func:`kernel_times`.

The line before the last two is the ``kernels`` JSON line; then the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  In the ``kernels`` line, ``ms``,
``plain_ms`` and ``library_ms`` are device times of one call at the main
path's largest shape, ``bound_ms`` its bound; ``path_ms`` is the device
time of all of the kernel's calls in one pass of its path (K1: a dycore
step's three calls; K4, K3: one radiation call's; K2: its one call on the
mega route; K5: the pipeline's two calls of a time index) and
``path_bound_ms`` the sum of their bounds.  The script imports nothing of
jax or of ``fv3net_tpu``.
"""
import concurrent.futures
import json
import math
import os
import statistics
import subprocess
import sys
import time

DEVICE = "cuda:0"
NPX, NPZ = 48, 32  # the flagship's C48 cube and levels
DT = 900.0  # s, the flagship's dynamics interval
CHUNK = 8  # steps per chunk
GRAY_TIMED_CHUNKS = 1  # after one warm-up chunk
# the RRTMG chunks of both routes, in turns (each route's first is its
# warm-up, then 5 timed chunks: with 2 or 3 the host's spread from chunk
# to chunk hid the routes' difference)
RRTMG_SCHEDULE = ("ktable", "mega", "ktable", "mega", "mega", "ktable",
                  "ktable", "mega", "ktable", "mega", "mega", "ktable")
# phase 6 compares the float32 radiation call, kernels against plain, on
# the ktable route's states after these chunks (warm-up included); the
# rest of the phase (times, recorded kernel calls, the absolute bounds
# below) is on the last
RADIATION_STATES_AFTER = (3, 4)
REMAPS_PER_STEP = 3  # winds, tracers, total energy (dycore/core.py)
KM_DEEP = 79  # a K1 case of more than 32 levels (the diagnostics' 79)
RADIATION_CALLS_PER_CHUNK = CHUNK // 4  # every 4th step, from step 0
# K3 (spec_band_dot) per radiation call: one per species-interpolated
# band, LW 9 lower + 3 upper (lw.py taumol_lw), SW 8 lower + 3 upper
# (sw.py taumol_sw)
SPEC_PER_CALL = (9 + 3) + (8 + 3)
# K4 (weighted_select_dot) per radiation call, counted in the code:
#   LW 30 = setcoef_lw's Planck lerp 1 + cldprop_lw's liquid and ice
#     lerps 2 + taumol_lw 27 (merged single-species tables lower and
#     upper 2, self and foreign continua 2, 1-D minors 1, chi_mls rows
#     at jp and jp+1 2, and per band: 3: minor2 x2 + frac2 x2 = 4;
#     4: frac2 x2 = 2; 5: minor2 + frac2 x2 = 3; 7: minor2 + frac2 = 2;
#     9: minor2 + frac2 = 2; 12: frac2 = 1; 13: minor2 x2 + frac2 = 3;
#     15: minor2 + frac2 = 2; 16: frac2 = 1);
#   SW 14 = taumol_sw 12 (merged single-species tables 2, continua 2,
#     band 24's Rayleigh lerp 1, and _sfluxzen's lerp in the 7 bands
#     that interpolate the solar source) + cldprop_sw's liquid and ice
#     optics 2.
SELECT_PER_CALL = 30 + 14
# on the "mega" route K2 takes the whole of taumol_lw: its 27 K4 and 12
# K3 calls go, one K2 launch comes
MEGA_SELECT_PER_CALL = SELECT_PER_CALL - 27
MEGA_SPEC_PER_CALL = SPEC_PER_CALL - 12
F32_RTOL = 1e-5  # float32: summation order of the prefix and band sums
# K1 in float32 may part from plain by this times what the float32 plain
# version itself errs from the exact application (see remap_case)
K1_F32_CONTROL_FACTOR = 2.0
F64_RTOL = 1e-12
KTABLE_RTOL = {"float32": 2e-6, "float64": 1e-13}  # summation order only
RRTMG_STEP_RTOL = 1e-10  # float64 RRTMG step, kernels against plain
# K2 against its plain version, of each output's scale: it sums a point's
# terms in an order of its own
TAUMOL_RTOL = {"float32": 2e-6, "float64": 1e-12}
# and value by value: every term of a tau is positive, so the other order
# costs a few ulps of each value; a fault in one minor gas hides below
# 1e-12 of an output's scale but not below this
TAUMOL_VALUE_RTOL = {"float32": 2e-6, "float64": 1e-12}
WAVG_RTOL = 2e-6  # K5, float32 sums in another order (per value)
C384, NZ_DIAG, COARSEN_FACTOR = 384, 79, 8  # the diagnostics workload
PIPELINE_TIMES = 2  # time indices of the pipeline phase's store
PIPELINE_MEAN_RTOL = 1e-6
# float32 radiation call, kernels against plain.  Two absolute bounds,
# set from the readings on an H100 on the state after the ktable route's
# 4th chunk (max 1.348e-2 K/day of SW heating, in the top layer, and
# 1.025e-2 W/m2 of surface SW down-flux) and held on that state only: on
# the state one chunk earlier the SW heating parts by 6.5e-2 K/day while
# float32 itself errs by 1.9e-1 there.
RAD_F32_HEATING_K_DAY = 2e-2
RAD_F32_FLUX_W_M2 = 2e-2
# And two bounds relative to the same call's controls, held on every
# state of RADIATION_STATES_AFTER and in every quantity.  The controls
# use the plain versions and the same McICA draws: the call in float64
# (what float32 roundoff itself moves) and with every selection table
# rounded to bfloat16 (a precision fault the gate must catch).
#   Two float32 results that each err from the float64 one by e part by
# at most 2 e (RAD_F32_CONTROL_FACTOR; the control below
# RAD_F32_ULPS float32 ulps of the quantity's largest value counts as
# that many ulps).
#   The bfloat16-table control must part from plain by at least
# RAD_F32_FAULT_RATIO times what the kernels do, or the comparison could
# not tell a sound kernel from that fault.
RAD_F32_CONTROL_FACTOR = 2.0
RAD_F32_ULPS = 4
RAD_F32_FAULT_RATIO = 3.0
# the step's profiler ranges (runtime/fused.py; "prephysics" in the
# production chunk only)
RANGES = ("prephysics", "dynamics", "radiation", "physics", "ml")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
SLEEP_CYCLES_PER_S = 2e9  # torch.cuda._sleep cycles per second, at most
# H100 SXM peak rates outside the tensor cores (NVIDIA's data sheet)
PEAK_FLOP_PER_S = {"float32": 67e12, "float64": 34e12}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=3):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings
    (after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def interleaved_ms(fns, reps, warmup=3):
    """Each named function timed twice, in turns (a, b, ..., b, a); the
    lower of its two medians (ms) per name."""
    names = list(fns)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        out[n].append(cuda_ms(fns[n], reps, warmup))
    return {n: min(v) for n, v in out.items()}


def _profiled_us(fn, reps):
    """Microseconds of device activity (kernels, copies) that ``reps``
    calls of ``fn`` launch, summed by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    return sum(getattr(e, key) for e in events
               if getattr(e, key) > 0 and e.self_cpu_time_total == 0)


def device_ms(fns, reps, warmup=3):
    """Device milliseconds per call of each named function, timed twice in
    turns (a, b, ..., b, a), the lower of the two; the host's work between
    the launches (a wrapper's checks, the ctypes call) is not in it.

    CUDA events around ``reps`` calls that the host queued while a sleep
    kernel held the device, so that the device ran them back to back.  A
    function that waits on the device itself (a copy from pageable host
    memory in a plain version) cannot be queued ahead: its time is the sum
    of its device activities under ``torch.profiler`` instead.  (A
    profiler session that launches nothing but ctypes-bound kernels may
    record none of them, so the kernels are timed by the first way.)"""
    import torch

    names = list(fns)
    for n in names:
        for _ in range(warmup):
            fns[n]()
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fns[n]()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4 * SLEEP_CYCLES_PER_S * host_s) + 1000)
        start.record()
        for _ in range(reps):
            fns[n]()
        end.record()
        ahead = not start.query()  # the sleep outlasted the queuing
        end.synchronize()
        if not ahead:
            log(f"  ({n} waits on the device: its device time from the "
                "profiler)")
        ms = (start.elapsed_time(end) if ahead
              else _profiled_us(fns[n], reps) / 1e3) / reps
        check(ms > 0, f"timing {n}: no device time recorded")
        out[n].append(ms)
    return {n: min(v) for n, v in out.items()}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, dtype_name):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_kernels():
    """The four CUDA sources, one nvcc each, started together."""
    from fv3net_torch.ops import coarsen_cuda, ktable_cuda, remap_cuda
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda

    modules = (remap_cuda, ktable_cuda, taumol_cuda, coarsen_cuda)
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        futures = {m.SOURCE: pool.submit(m.build) for m in modules}
        for source, fut in futures.items():
            info = fut.result()
            log(f"  built {info.path.name} from {source} in "
                f"{info.seconds:.2f} s")
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"  nvcc: {line.strip()}")


def flagship_edges(device, dtype, seed=0, npz=NPZ):
    """pe1 / pe2 [6, 48, 48, npz+1]: the C48 hybrid coordinate over a
    varying surface pressure (pe2) and a Lagrangian perturbation of its
    interior edges by 0.3 layer thicknesses times a normal draw clipped to
    +-2.5, which keeps them inside the column (pe1)."""
    import numpy as np
    import torch
    from fv3net_torch.dycore.vertical import hybrid_coordinate
    from fv3net_torch.grid.geometry import make_grid

    rng = np.random.RandomState(seed)
    grid = make_grid(NPX)
    ak, bk = hybrid_coordinate(npz)
    ps = 1.0e5 + 1500.0 * np.cos(2 * grid.lat) * np.sin(grid.lon)
    pe2 = ak + bk * ps[..., None]
    pe1 = pe2.copy()
    pe1[..., 1:-1] += (
        0.3 * np.diff(pe2, axis=-1)[..., :-1] * np.clip(rng.randn(*ps.shape, npz - 1), -2.5, 2.5)
    )
    pe1.sort(-1)

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)

    return t(pe1), t(pe2), rng


def _to64(x):
    """``x`` with every floating tensor in it (dicts and lists walked) in
    float64."""
    import torch

    if isinstance(x, dict):
        return {k: _to64(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to64(v) for v in x)
    if torch.is_tensor(x) and x.is_floating_point():
        return x.double()
    return x


def remap_inputs(device, dtype, F, npz=NPZ):
    """K1's arguments for F fields over the C48 columns at npz levels:
    (search, q, al, ar, a6)."""
    import torch
    from fv3net_torch.ops import remap as rm

    pe1, pe2, rng = flagship_edges(device, dtype, npz=npz)
    search = rm.banded_search(pe1, pe2, window=2)
    q = torch.tensor(250.0 + 30.0 * rng.rand(F, 6, NPX, NPX, npz),
                     dtype=dtype, device=device)
    al, ar, a6 = rm.cs_profile(q, search["dp1"], 1, 9)
    return search, q, al, ar, a6


def remap_readings(args, got):
    """K1's output ``got`` on ``args`` against the plain version in the
    same dtype and, for float32, against the plain version in float64 on
    the same (float32) arguments, the exact application: returns
    ``(scale, |kernel - plain|, |kernel - exact|, |plain - exact|)``, the
    last two None in float64."""
    import torch
    from fv3net_torch.ops import remap as rm

    want = rm.remap_apply_plain(*args)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if got.dtype != torch.float32:
        return scale, err, None, None
    exact = rm.remap_apply_plain(*_to64(args))
    return (scale, err, (got.double() - exact).abs().max().item(),
            (want.double() - exact).abs().max().item())


def remap_case(device, dtype, F, npz=NPZ, reps=0):
    """K1 against its plain version on F fields over the C48 columns at
    npz levels: checks the difference and the column mass, logs them (with
    device times when ``reps``); returns (max |diff|, times, bytes moved,
    output values).

    Float32 is held to F32_RTOL of the output's scale, against plain and
    against the exact (float64) application of the same arguments.  Both
    versions difference prefix sums of the column's mass, whose rounding
    grows with the levels summed: at km=79 the float32 plain version errs
    by 1.27e-5 of the scale, the kernel by 1.14e-5 (NVIDIA H100 80GB HBM3,
    700.00 W; PERF.md).  So past the flagship's NPZ levels the bound is
    twice what the float32 plain version errs, where that is more
    (K1_F32_CONTROL_FACTOR: two float32 results that each err by e part by
    at most 2 e)."""
    import torch
    from fv3net_torch.ops import remap as rm
    from fv3net_torch.ops import remap_cuda

    name = str(dtype).replace("torch.", "")
    label = f"K1 {name} F={F} km={npz}"
    args = remap_inputs(device, dtype, F, npz)
    search, q = args[0], args[1]
    dp1 = search["dp1"]
    pe2 = search["pe2"]
    dp2 = pe2[..., 1:] - pe2[..., :-1]

    def kernel():
        return remap_cuda.remap_apply_cuda(*args)

    def plain():
        return rm.remap_apply_plain(*args)

    got = kernel()
    torch.cuda.synchronize()
    check(torch.isfinite(got).all().item(), f"{label}: non-finite output")
    scale, err, err_k, err_p = remap_readings(args, got)
    if dtype == torch.float32:
        rtol = (F32_RTOL if npz <= NPZ else
                max(F32_RTOL, K1_F32_CONTROL_FACTOR * err_p / scale))
        f32 = (f"; against the exact (float64) application: kernel "
               f"{err_k:.3e}, plain {err_p:.3e}")
        check(err_k <= rtol * scale, f"{label}: max|kernel-exact| {err_k} "
              f"> {rtol} * {scale}")
    else:
        rtol, f32 = F64_RTOL, ""
    check(err <= rtol * scale,
          f"{label}: max|kernel-plain| {err} > {rtol} * {scale}")
    m1 = (q * dp1).sum(-1)
    m2 = (got * dp2).sum(-1)
    cons = ((m2 - m1).abs() / m1.abs()).max().item()
    mass_rtol = F32_RTOL if dtype == torch.float32 else F64_RTOL
    check(cons <= mass_rtol,
          f"{label}: column mass rel error {cons} > {mass_rtol}")
    # each input read once, the output written once
    moved = nbytes(q, *args[2:], dp1, search["w"], search["p"],
                   search["pe1"], pe2, got)
    ms = device_ms({"plain": plain, "kernel": kernel}, reps) if reps else None
    log(f"  {label}: max|diff| {err:.3e} (scale {scale:.3e}, rtol "
        f"{rtol:.3e}){f32}, column-mass rel err {cons:.3e}; {moved} bytes "
        f"moved" + ("" if not reps else
                    f"; device time kernel {ms['kernel']:.4f} ms, plain "
                    f"{ms['plain']:.4f} ms (lower of two)"))
    return err, ms, moved, got.numel()


def phase_remap_kernel(device, reps=30):
    """K1 against its plain version: the step's three calls (F = 3, 2, 1
    on one search at C48, npz=32) in float32 and float64, timed, and one
    call at km=79; returns its kernel-line numbers (F=3, float32) and the
    step's sums."""
    import torch

    worst = 0.0
    line = {"path_ms": 0.0, "path_bound_ms": 0.0}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for F in (3, 2, 1):
            err, ms, moved, n_out = remap_case(device, dtype, F, reps=reps)
            # work is data-independent: ~60 flops per output value
            bound_ms, by = bound(moved, 60 * n_out, name)
            if dtype != torch.float32:
                continue
            worst = max(worst, err)
            line["path_ms"] += ms["kernel"]
            line["path_bound_ms"] += bound_ms
            if F == 3:
                line.update(ms=ms["kernel"], plain_ms=ms["plain"],
                            bound_ms=bound_ms, bound_by=by)
    log(f"  K1, the step's three calls (F = 3, 2, 1; float32): "
        f"{line['path_ms']:.4f} ms of device time against a bound of "
        f"{line['path_bound_ms']:.4f} ms "
        f"({100 * line['path_bound_ms'] / line['path_ms']:.1f}%)")
    for dtype in (torch.float32, torch.float64):
        remap_case(device, dtype, 3, npz=KM_DEEP)
    line["max_abs_err"] = worst
    return line


def air_mass(state, area):
    import torch

    return (state.delp.to(torch.float64).sum(dim=1)
            * area.to(torch.float64)).sum().item()


def fields(state):
    out = {"delp": state.delp, "pt": state.pt, "wind": state.wind}
    out.update(state.tracers)
    return out


KERNELS = ("remap_apply", "weighted_select_dot", "spec_band_dot",
           "taumol_lw", "weighted_block_average")
# the __global__ functions of the chunk's hand kernels (K1, K4, K3, K2),
# by the name of their wrapper's launch count
HAND_KERNELS = {"remap_apply_kernel": "remap_apply",
                "weighted_select_kernel": "weighted_select_dot",
                "spec_band_kernel": "spec_band_dot",
                "taumol_lw_kernel": "taumol_lw"}


def reset_counts():
    from fv3net_torch.ops import coarsen_cuda, ktable_cuda, remap_cuda
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda

    remap_cuda.LAUNCHES = 0
    ktable_cuda.SELECT_LAUNCHES = 0
    ktable_cuda.SPEC_LAUNCHES = 0
    taumol_cuda.TAUMOL_LAUNCHES = 0
    coarsen_cuda.WAVG_LAUNCHES = 0


def read_counts():
    from fv3net_torch.ops import coarsen_cuda, ktable_cuda, remap_cuda
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda

    return {"remap_apply": remap_cuda.LAUNCHES,
            "weighted_select_dot": ktable_cuda.SELECT_LAUNCHES,
            "spec_band_dot": ktable_cuda.SPEC_LAUNCHES,
            "taumol_lw": taumol_cuda.TAUMOL_LAUNCHES,
            "weighted_block_average": coarsen_cuda.WAVG_LAUNCHES}


def launches(**counts):
    """Expected launch counts: 0 for every kernel not named."""
    return {name: counts.get(name, 0) for name in KERNELS}


class Path:
    """One driven configuration: its step, its evolving state, the
    launches one chunk must make, and what its chunks counted and took."""

    def __init__(self, label, step, state, args, area, per_chunk):
        self.label, self.step, self.state = label, step, state
        self.args, self.area, self.per_chunk = args, area, per_chunk
        self.counts = launches()
        self.wall = []  # seconds of the chunks after the first (warm-up)
        self.chunks = 0

    def chunk(self):
        """One chunk from counts set to 0; gates the counts read after it
        against ``per_chunk``, the fields and the air-mass drift."""
        import torch

        m0 = air_mass(self.state, self.area)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.state = self.step(self.state, *self.args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        i, label = self.chunks, self.label
        check(counts == self.per_chunk, f"{label} chunk {i}: launches "
              f"{counts}, expected {self.per_chunk}")
        for name, x in fields(self.state).items():
            check(torch.isfinite(x).all().item(),
                  f"{label} chunk {i}: non-finite {name}")
        drift = abs(air_mass(self.state, self.area) - m0) / m0
        check(drift <= 1e-5, f"{label} chunk {i}: air-mass drift "
              f"{drift:.3e} > 1e-5")
        log(f"  {label} chunk {i} ({'warm-up' if i == 0 else 'timed'}): "
            f"{dt * 1e3:.1f} ms, air-mass drift {drift:.3e}, launches "
            f"{counts}")
        self.counts = {k: v + counts[k] for k, v in self.counts.items()}
        if i:
            self.wall.append(dt)
        self.chunks += 1

    def summary(self):
        """Logs and returns the median ms per timed chunk."""
        ms = statistics.median(self.wall) * 1e3
        sypd = (CHUNK * DT / (ms / 1e3)) / 365.0
        log(f"  {self.label} main path: {ms:.1f} ms per {CHUNK}-step chunk "
            f"(median of {len(self.wall)}), {sypd:.3f} SYPD; launches in "
            f"{self.chunks} chunks {self.counts}")
        for name, n in self.per_chunk.items():
            check(not n or self.counts[name] > 0,
                  f"{self.label} path: {name} never launched")
        return ms


def phase_gray(device):
    import torch
    from fv3net_torch import entry

    step, (state, ml_params, sst, cosz) = entry.flagship(
        npx=NPX, npz=NPZ, radiation="gray", chunk=CHUNK, device=device)
    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    path = Path("gray", step, state, (ml_params, sst, cosz), area,
                launches(remap_apply=CHUNK * REMAPS_PER_STEP))
    for _ in range(1 + GRAY_TIMED_CHUNKS):
        path.chunk()
    path.summary()


def rrtmg_path(device, lw_taumol):
    """The RRTMG flagship chunk on one route of the LW gas optics."""
    import torch
    from fv3net_torch import entry

    label = "rrtmg" if lw_taumol == "ktable" else f"rrtmg-{lw_taumol}"
    t0 = time.perf_counter()
    step, (state, ml_params, sst, cosz) = entry.flagship(
        npx=NPX, npz=NPZ, chunk=CHUNK, device=device, lw_taumol=lw_taumol)
    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    log(f"  built the {label} flagship chunk in "
        f"{time.perf_counter() - t0:.2f} s")
    calls = RADIATION_CALLS_PER_CHUNK
    mega = lw_taumol == "mega"
    per_chunk = launches(
        remap_apply=CHUNK * REMAPS_PER_STEP,
        weighted_select_dot=calls * (MEGA_SELECT_PER_CALL if mega
                                     else SELECT_PER_CALL),
        spec_band_dot=calls * (MEGA_SPEC_PER_CALL if mega
                               else SPEC_PER_CALL),
        taumol_lw=calls * mega,
    )
    return Path(label, step, state, (ml_params, sst, cosz), area, per_chunk)


def phase_rrtmg(device):
    """The RRTMG main path on both routes of the LW gas optics, their
    chunks taken in turns so that both meet the same host; then one
    profiled chunk of each.  Returns the two paths by route and the
    states that phase 6 runs its radiation call on, by the ktable
    route's chunks before them."""
    paths = {route: rrtmg_path(device, route)
             for route in ("ktable", "mega")}
    radiation_states = {}
    for route in RRTMG_SCHEDULE:
        paths[route].chunk()
        if route == "ktable" and paths[route].chunks in RADIATION_STATES_AFTER:
            radiation_states[paths[route].chunks] = paths[route].state
    check(len(radiation_states) == len(RADIATION_STATES_AFTER),
          "the schedule has too few ktable chunks for "
          f"{RADIATION_STATES_AFTER}")
    ms = {route: path.summary() for route, path in paths.items()}
    log(f"  RRTMG chunk: {ms['ktable']:.1f} ms on the ktable route, "
        f"{ms['mega']:.1f} ms on the mega route (chunks in the order "
        f"{', '.join(RRTMG_SCHEDULE)}; the first of each is its warm-up)")
    for path in paths.values():
        profile_chunk(path.label,
                      lambda p=path: p.step(p.state, *p.args))
    return paths, radiation_states


class RangeLaunches:
    """While active, counts each kernel's launches inside each of the
    step's ranges: ``runtime/fused.py`` opens them with
    ``record_function``, which is wrapped to read the launch counts at
    each range's entry and exit (the ranges do not nest)."""

    def __init__(self):
        from fv3net_torch.runtime import fused

        self.mod, self.orig = fused, fused.record_function
        self.counts = {name: dict.fromkeys(KERNELS, 0) for name in RANGES}

    def __enter__(self):
        import contextlib

        orig, counts = self.orig, self.counts

        @contextlib.contextmanager
        def counted(name):
            before = read_counts()
            with orig(name):
                yield
            after = read_counts()
            for k in KERNELS:
                counts[name][k] += after[k] - before[k]

        self.mod.record_function = counted
        return self

    def __exit__(self, *exc):
        self.mod.record_function = self.orig


def profile_chunk(label, run):
    """One chunk, ``run()``, under torch.profiler: the device's busy share
    of the wall time, the device time of each of the step's ranges and
    the device time by op; returns the device busy ms by range, each
    range's hand kernels in.

    A range's device time from the profiler counts the kernels of the
    PyTorch ops inside it but not the hand kernels, which are launched
    through ctypes outside any op; so each hand kernel's device time is
    added to the ranges whose launches it made (:class:`RangeLaunches`),
    in proportion to them (exact where all of a kernel's launches lie in
    one range, as on the flagship's path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            RangeLaunches() as in_range:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # the device-time attribute's name differs across torch versions
    key = ("device_time_total"
           if hasattr(events[0], "device_time_total")
           else "cuda_time_total")
    self_key = "self_" + key
    # device activities (kernels, copies) are the events without CPU
    # time, less the ranges' device-side annotations (their spans)
    device = [e for e in events
              if getattr(e, self_key) > 0 and e.self_cpu_time_total == 0
              and e.key not in RANGES]
    device_us = sum(getattr(e, self_key) for e in device)
    n_kernels = sum(e.count for e in device)
    log(f"  profile (one {label} chunk, profiler on): wall "
        f"{wall_us / 1e3:.1f} ms, device busy {device_us / 1e3:.1f} ms "
        f"({100 * device_us / wall_us:.1f}%), {n_kernels} device "
        f"activities")
    # the hand kernels by name, summed over their template instances, and
    # their device time by the range that launched them
    hand_us = dict.fromkeys(RANGES, 0.0)
    reading = {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
               "activities": n_kernels, "ranges": {}, "kernels": {}}
    for kname, count_name in HAND_KERNELS.items():
        mine = [e for e in device if kname in e.key]
        if not mine:
            continue
        n = sum(e.count for e in mine)
        us = sum(getattr(e, self_key) for e in mine)
        launched = sum(c[count_name] for c in in_range.counts.values())
        log(f"  kernel {kname}: {n} launches, {us / 1e3:.3f} ms; launched "
            + ", ".join(f"{c[count_name]} in {r}"
                        for r, c in in_range.counts.items()
                        if c[count_name]))
        reading["kernels"][count_name] = (n, us / 1e3)
        if launched != n:
            log(f"  ({kname}: {n} launches traced, {launched} counted in "
                "the step's ranges: its share of each range is not exact)")
        for r, c in in_range.counts.items():
            hand_us[r] += us * c[count_name] / max(launched, 1)
    host = {e.key: e for e in events
            if e.key in RANGES and e.cpu_time_total > 0}
    span = {e.key: e for e in events
            if e.key in RANGES and e.cpu_time_total == 0}
    for name in RANGES:
        if name not in host:
            continue
        e = host[name]
        # the kernels of the PyTorch ops inside the range, and the hand
        # kernels it launched
        busy = getattr(e, key) + hand_us[name]
        reading["ranges"][name] = busy / 1e3
        span_us = getattr(span[name], key) if name in span else float("nan")
        log(f"  range {name}: {e.count} calls, host "
            f"{e.cpu_time_total / 1e3:.1f} ms, device busy "
            f"{busy / 1e3:.1f} ms ({100 * busy / max(device_us, 1e-9):.1f}% "
            f"of device busy; hand kernels {hand_us[name] / 1e3:.3f} ms of "
            f"it), device span {span_us / 1e3:.1f} ms")
    for line in events.table(sort_by=self_key, row_limit=15).splitlines():
        log(f"  | {line}")
    return reading


def radiation_inputs(state, sst, cosz, lat):
    """The chunk's radiation inputs (runtime/fused.py's radiation())."""
    from fv3net_torch import entry
    from fv3net_torch.dycore.state import temperature_from_theta_v
    from fv3net_torch.ops import thermo

    delp = state.delp.movedim(1, -1)
    q = state.tracers["sphum"].movedim(1, -1)
    pmid = thermo.pressure_at_midpoint_log(
        delp, toa_pressure=entry.FLAGSHIP_DYCORE.ptop)
    T = temperature_from_theta_v(state.pt.movedim(1, -1), pmid, q)
    qc = state.tracers["cloud_water"].movedim(1, -1)
    return T, delp, q, qc, sst, cosz, lat


class Recorder:
    """Wraps the K4/K3 wrappers to keep the arguments of every call: K4's
    (terms, tab), K3's (w_paths, s_paths, tab, nspa)."""

    def __init__(self):
        from fv3net_torch.ops import ktable_cuda

        self.mod = ktable_cuda
        self.select, self.spec = [], []
        self.orig = (ktable_cuda.weighted_select_dot_cuda,
                     ktable_cuda.spec_band_dot_cuda)

    def __enter__(self):
        sel, spec = self.orig

        def rec_select(*a):
            out = sel(*a)
            self.select.append((a, out))
            return out

        def rec_spec(*a):
            out = spec(*a)
            self.spec.append((a, out))
            return out

        self.mod.weighted_select_dot_cuda = rec_select
        self.mod.spec_band_dot_cuda = rec_spec
        return self

    def __exit__(self, *exc):
        (self.mod.weighted_select_dot_cuda,
         self.mod.spec_band_dot_cuda) = self.orig


class BFloat16Tables:
    """Makes the plain k-table selections read their tables rounded to
    bfloat16 (and back): the control for a table-precision fault."""

    def __init__(self):
        from fv3net_torch.ops import ktable

        self.mod = ktable
        self.orig = (ktable.weighted_select_dot_plain,
                     ktable.spec_band_dot_plain)

    def __enter__(self):
        import torch

        sel, spec = self.orig

        def rounded(tab):
            return tab.to(torch.bfloat16).to(tab.dtype)

        self.mod.weighted_select_dot_plain = (
            lambda terms, tab: sel(terms, rounded(tab)))
        self.mod.spec_band_dot_plain = (
            lambda w, s, tab, nspa: spec(w, s, rounded(tab), nspa))
        return self

    def __exit__(self, *exc):
        (self.mod.weighted_select_dot_plain,
         self.mod.spec_band_dot_plain) = self.orig


class Capture:
    """Wraps ``module.name`` to keep the arguments and the result of its
    first call."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args, self.kwargs, self.out = None, None, None

    def __enter__(self):
        def wrapped(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            if self.args is None:
                self.args, self.kwargs, self.out = args, kwargs, out
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def radiation_differences(out, delp, where, absolute):
    """Logs, per heating rate and flux of one float32 radiation call, how
    far the kernels (both routes) and the two controls part from the
    plain versions; returns the failed gates: the bounds relative to the
    controls and, where ``absolute``, the absolute bounds."""
    import torch
    from fv3net_torch.physics.radiation.rrtmg import params as P

    def dmax(a, b):
        return (a.double() - b.double()).abs().max().item()

    eps = torch.finfo(torch.float32).eps
    heat_keys = {"heating": "tendency_of_air_temperature_due_to_radiation",
                 "LW heating": "total_sky_longwave_heating_rate_python",
                 "SW heating": "total_sky_shortwave_heating_rate_python"}
    quantities = [(label, key, 86400.0, "K/day", RAD_F32_HEATING_K_DAY)
                  for label, key in heat_keys.items()]
    quantities += [(key[:-len("_python")], key, 1.0, "W/m2",
                    RAD_F32_FLUX_W_M2)
                   for key in sorted(out["plain"]) if "_flux_" in key]
    bad = []
    for label, key, unit_scale, unit, limit in quantities:
        d = {name: unit_scale * dmax(out[name][key], out["plain"][key])
             for name in ("kernels", "mega", "float64", "bfloat16 tables")}
        routes = unit_scale * dmax(out["mega"][key], out["kernels"][key])
        scale = unit_scale * out["plain"][key].abs().max().item()
        allowed = RAD_F32_CONTROL_FACTOR * max(d["float64"],
                                               RAD_F32_ULPS * eps * scale)
        worst = max(d["kernels"], d["mega"])
        ratio = d["bfloat16 tables"] / worst if worst else math.inf
        log(f"  float32 {label}: kernels against plain {d['kernels']:.3e} "
            f"{unit}, mega route against plain {d['mega']:.3e} (allowed "
            f"{allowed:.3e}" + (f", bound {limit}" if absolute else "")
            + f"), mega against ktable route {routes:.3e}; controls, plain "
            f"float32 against float64 {d['float64']:.3e}, against bfloat16 "
            f"tables {d['bfloat16 tables']:.3e} "
            f"({ratio:.3g} times the kernels' reading)")
        for name in ("kernels", "mega"):
            if not d[name] <= allowed:
                bad.append(f"{where}: {name} {label} {d[name]} {unit} > "
                           f"{allowed} from the float64 control")
            if absolute and not d[name] <= limit:
                bad.append(f"{where}: {name} {label} {d[name]} {unit} > "
                           f"{limit}")
        if not d["bfloat16 tables"] >= RAD_F32_FAULT_RATIO * worst:
            bad.append(f"{where}: {label}: the bfloat16-table control "
                       f"{d['bfloat16 tables']} {unit} is less than "
                       f"{RAD_F32_FAULT_RATIO} times the kernels' {worst}")

    # where the heating parts most: the layer's flux-divergence
    # difference (heating = HEATFAC * dF / dp[mb]) in float32 ulps of the
    # column's largest flux at the top
    dh = (out["kernels"][heat_keys["heating"]]
          - out["plain"][heat_keys["heating"]]).abs()
    at = divmod(int(dh.argmax()), NPZ)
    dp_mb = delp.reshape(-1, NPZ)[at].item() / 100.0
    d_flux = dh.reshape(-1, NPZ)[at].item() * dp_mb / P.HEATFAC
    f_top = max(out["plain"][k + "_python"].reshape(-1)[at[0]].item() for k in (
        "total_sky_downward_shortwave_flux_at_top_of_atmosphere",
        "total_sky_upward_longwave_flux_at_top_of_atmosphere"))
    ulp = eps * f_top
    log(f"  largest heating difference at column {at[0]}, level {at[1]} of "
        f"{NPZ} (0 = top), dp {dp_mb:.4f} mb: a flux-divergence difference "
        f"of {d_flux:.3e} W/m2, {d_flux / ulp:.1f} float32 ulps of the "
        f"column's {f_top:.2f} W/m2 at the top")
    return bad


SW_COLUMNS = 8  # columns kept by --sw-columns
SW_ARGS = ("plyr", "plvl", "tlyr", "tlvl", "qlyr", "olyr", "gasvmr",
           "clouds", "aerosols", "sfcalb", "delpin", "cosz")


def dump_sw_columns(path, drivers, inputs, cosz, smi):
    """The arguments of ``swrad`` (McICA draws included) in the float32
    plain call and in the float64 control on ``inputs``, for the
    SW_COLUMNS columns where the float32 SW heating parts most from the
    float64 one, with both calls' outputs there, saved to ``path``
    (.npz): the inputs of the CPU test of that error
    (tests/test_torch_rrtmg.py)."""
    import datetime

    import numpy as np
    import torch
    from fv3net_torch.physics.radiation.rrtmg import sw as rsw

    when = datetime.datetime(2016, 7, 1)
    calls = {}
    for name in ("plain", "float64"):
        with Capture(rsw, "swrad") as rec:
            drivers[name](when, inputs, cosz=cosz)
        torch.cuda.synchronize()
        calls[name] = (rec.args, rec.kwargs, rec.out)
    h32 = calls["plain"][2]["hswc"].double()
    h64 = calls["float64"][2]["hswc"]
    per_col = (h32 - h64).abs().max(dim=1).values * 86400.0
    cols = per_col.argsort(descending=True)[:SW_COLUMNS]
    out = {"columns": cols.cpu().numpy(), "card": np.array(smi)}
    # the float64 call takes the float32 call's McICA draws (phase 6),
    # so its rand2d is not kept
    check(torch.equal(calls["plain"][0][13].double(), calls["float64"][0][13]),
          "the float64 control drew other McICA uniforms")
    for name, tag in (("plain", "f32"), ("float64", "f64")):
        args, kwargs, res = calls[name]
        kept = SW_ARGS + (("solcon", "rand2d") if tag == "f32" else
                          ("solcon",))
        for arg_name, x in zip(kept, args[:len(kept)]):
            out[f"{tag}_{arg_name}"] = (
                x[cols].cpu().numpy() if torch.is_tensor(x)
                else np.array(x))
        out[f"{tag}_iovrsw"] = np.array(kwargs["iovrsw"])
        for key in ("hswc", "fsfcdc", "ftoauc"):
            out[f"{tag}_out_{key}"] = res[key][cols].cpu().numpy()
    out["nbase_hi"] = np.array(drivers["plain"].Tsw["nbase_hi"])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **out)
    log(f"  saved swrad's arguments of {SW_COLUMNS} columns to {path}: "
        "float32 SW heating against float64 there "
        + ", ".join(f"{per_col[c].item():.3e}" for c in cols) + " K/day")


def phase_radiation(device, states, sst, cosz, sw_columns=None, smi=""):
    """One RRTMG call alone on both routes of the LW gas optics, on the
    last of ``states`` (by chunks before them); the float32 call against
    its plain version and controls on each of them.  Returns the
    recorded K4/K3 calls, the arguments of the K2 call and the float64
    LW tables."""
    import datetime

    import torch
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.physics import PhysicsConfig
    from fv3net_torch.physics.radiation.rrtmg import lw as rlw
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda
    from fv3net_torch.physics.radiation.rrtmg.driver import (
        RRTMGConfig,
        RRTMGDriver,
    )
    from fv3net_torch.runtime import fused

    lat = torch.tensor(make_grid(NPX).lat, dtype=torch.float32,
                       device=device)
    cfg = PhysicsConfig(radiation_scheme="rrtmg")
    rad = fused._build_radiation_fn(cfg, device, torch.float32)
    rad_mega = fused._build_radiation_fn(cfg, device, torch.float32,
                                         lw_taumol="mega")
    rad_plain = fused._build_radiation_fn(cfg, device, torch.float32,
                                          impl="torch")
    args = radiation_inputs(states[RADIATION_STATES_AFTER[-1]], sst, cosz,
                            lat)

    reset_counts()
    with Recorder() as rec:
        heating, diags = rad(*args)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == launches(weighted_select_dot=SELECT_PER_CALL,
                             spec_band_dot=SPEC_PER_CALL),
          f"one radiation call: launches {counts}")
    check(torch.isfinite(heating).all().item(), "non-finite heating")
    reset_counts()
    with Capture(taumol_cuda, "taumol_lw_cuda") as k2_call:
        heating_mega, _ = rad_mega(*args)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == launches(weighted_select_dot=MEGA_SELECT_PER_CALL,
                             spec_band_dot=MEGA_SPEC_PER_CALL, taumol_lw=1),
          f"one radiation call on the mega route: launches {counts}")
    check(torch.isfinite(heating_mega).all().item(),
          "non-finite heating on the mega route")
    ranges = {"ULWRFtoa": (100.0, 400.0), "USWRFtoa": (0.0, 1400.0),
              "DSWRFsfc": (0.0, 1400.0), "DLWRFsfc": (50.0, 500.0)}
    for name, (lo, hi) in ranges.items():
        x = diags[name]
        x_lo, x_hi = x.min().item(), x.max().item()
        log(f"  {name}: {x_lo:.2f} .. {x_hi:.2f} W/m2 (mean "
            f"{x.mean().item():.2f})")
        check(lo <= x_lo and x_hi <= hi,
              f"{name} outside [{lo}, {hi}] W/m2: {x_lo} .. {x_hi}")
    k_day = heating.abs().max().item() * 86400.0
    log(f"  max |heating| {k_day:.3f} K/day")
    check(k_day < 1000.0, f"radiative heating {k_day} K/day")

    ms = interleaved_ms({"kernels": lambda: rad(*args),
                         "mega": lambda: rad_mega(*args),
                         "plain": lambda: rad_plain(*args)}, 3, warmup=1)
    log(f"  one RRTMG call (C48, npz=32, float32): {ms['kernels']:.1f} ms "
        f"with the kernels on the ktable route, {ms['mega']:.1f} ms on the "
        f"mega route, {ms['plain']:.1f} ms with the plain versions (median "
        "of 3, lower of two)")

    # the same columns through the driver with the kernels, with the
    # plain versions, and the two controls (see RAD_F32_CONTROL_FACTOR)
    rcfg = RRTMGConfig(solcon=1368.22 * cfg.solcon_scale)
    drivers = {
        "kernels": RRTMGDriver(rcfg, device=device),
        "mega": RRTMGDriver(rcfg, device=device, lw_taumol="mega"),
        "plain": RRTMGDriver(rcfg, device=device, impl="torch"),
        "float64": RRTMGDriver(rcfg, dtype=torch.float64, device=device,
                               impl="torch"),
    }
    draws = drivers["kernels"].draw_mcica
    drivers["float64"].draw_mcica = lambda fold, ncol, nz: tuple(
        x.double() for x in draws(fold, ncol, nz))
    when = datetime.datetime(2016, 7, 1)

    def outputs(state):
        T, delp, q, qc = radiation_inputs(state, sst, cosz, lat)[:4]
        inputs = {
            "air_temperature": T,
            "pressure_thickness_of_atmospheric_layer": delp,
            "specific_humidity": q,
            "cloud_water_mixing_ratio": qc,
            "surface_temperature": sst,
            "latitude": lat,
            "longitude": torch.zeros_like(lat),
        }
        out = {name: d(when, inputs, cosz=cosz)
               for name, d in drivers.items()}
        with BFloat16Tables():
            out["bfloat16 tables"] = drivers["plain"](when, inputs,
                                                      cosz=cosz)
        return out, delp

    bad = []
    for after in RADIATION_STATES_AFTER:
        last = after == RADIATION_STATES_AFTER[-1]
        log(f"  the state after {after} chunks of the ktable route:")
        with Capture(rlw, "lwrad") as lw_call:
            out, delp = outputs(states[after])
        bad += radiation_differences(out, delp, f"after {after} chunks",
                                     absolute=last)
    if sw_columns:
        first = states[RADIATION_STATES_AFTER[0]]
        T, delp, q, qc = radiation_inputs(first, sst, cosz, lat)[:4]
        dump_sw_columns(sw_columns, drivers, {
            "air_temperature": T,
            "pressure_thickness_of_atmospheric_layer": delp,
            "specific_humidity": q,
            "cloud_water_mixing_ratio": qc,
            "surface_temperature": sst,
            "latitude": lat,
            "longitude": torch.zeros_like(lat),
        }, cosz, smi)
    # ``out`` and ``lw_call`` are now those of the last state
    lw_kwargs = {k: v for k, v in lw_call.kwargs.items() if k != "taumol"}
    ms = interleaved_ms(
        {route: (lambda route=route: rlw.lwrad(*lw_call.args, **lw_kwargs,
                                               taumol=route))
         for route in ("ktable", "mega")}, 5, warmup=1)
    log(f"  one LW call (lwrad, C48, npz=32, float32): {ms['ktable']:.1f} ms"
        f" on the ktable route, {ms['mega']:.1f} ms on the mega route "
        "(median of 5, lower of two)")

    # the SW down-flux at the top, which the chunk's cache does not keep:
    # 0 at night and at most the solar constant times cosz by day
    toa = out["kernels"][
        "total_sky_downward_shortwave_flux_at_top_of_atmosphere_python"]
    day = cosz > 1e-4
    top = rcfg.solcon * cosz.clamp(min=0.0)
    log(f"  SW down at the top: {toa.min().item():.2f} .. "
        f"{toa.max().item():.2f} W/m2 (solar constant {rcfg.solcon:.2f} "
        "W/m2)")
    check(bool((toa[~day] == 0).all()), "SW down at the top is not 0 at night")
    check(bool((toa[day] > 0).all() and (toa <= top * (1 + 1e-5)).all()),
          "SW down at the top outside (0, solar constant * cosz]")
    check(not bad, f"kernels and plain versions part: {bad}")
    return rec, k2_call.args, drivers["float64"].Tlw


def max_diff(got, want, label):
    """(max |got - want|, max |want|) over the finite values of ``want``;
    the non-finite values must sit at the same points.  (The gas optics
    compute both atmospheres' selections at every point and keep one:
    a species ratio of two zero amounts gives NaN weights at points the
    troposphere mask then discards, in the reference too.)"""
    import torch

    finite = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), finite),
          f"{label}: non-finite values at other points than the plain "
          "version's")
    diff = torch.where(finite, got - want, 0.0).abs().max().item()
    return diff, torch.where(finite, want, 0.0).abs().max().item()


def _select_plain(terms, tab):
    from fv3net_torch.ops import ktable

    return ktable.weighted_select_dot_plain(terms, tab)


def _spec_plain(w_paths, s_paths, tab, nspa):
    from fv3net_torch.ops import ktable

    return ktable.spec_band_dot_plain(w_paths, s_paths, tab, nspa)


def _embedding_bag_select(terms, tab):
    """K4 as one library call: bags of the K rows of each point."""
    import torch
    import torch.nn.functional as F

    lead = torch.broadcast_shapes(*[x.shape for t in terms for x in t
                                    if x is not None])
    rows = tab.shape[0]
    idx = torch.stack([i.expand(lead).reshape(-1).long().clamp(0, rows - 1)
                       for i, _ in terms], 1)
    psw = torch.stack([
        (torch.ones(lead, dtype=tab.dtype, device=tab.device) if w is None
         else w.expand(lead)).reshape(-1) for _, w in terms], 1)
    shape = tuple(lead) + (tab.shape[1],)
    return lambda: F.embedding_bag(idx, tab, per_sample_weights=psw,
                                   mode="sum").view(shape)


def _select_cost(terms, tab, out):
    """(bytes, flops) K4 must move and do: each distinct input read once
    (ids at their own width), the output written once."""
    seen = {}
    for x in [tab, out] + [x for t in terms for x in t if x is not None]:
        seen.setdefault((x.data_ptr(), x.numel()), x)
    G = tab.shape[1]
    return nbytes(*seen.values()), 2 * len(terms) * (out.numel() // G) * G


def _distinct_bytes(tensors):
    """Bytes of the distinct tensors among ``tensors`` (None skipped), each
    read once at its own width."""
    seen = {}
    for x in tensors:
        if x is not None:
            seen.setdefault((x.data_ptr(), x.numel()), x)
    return nbytes(*seen.values())


def _spec_cost(a, out):
    """(bytes, flops) K3 must move and do: each distinct input read once
    (ids at their own width), the output written once."""
    w_paths, s_paths, tab, nspa = a
    n_paths, kw, st = len(w_paths), len(w_paths[0]), len(s_paths[0])
    pairs = [x for p in w_paths + s_paths for pair in p for x in pair]
    moved = _distinct_bytes([tab, out] + pairs)
    return moved, out.numel() * n_paths * st * (2 * kw + 2)


def _embedding_bag_spec(w_paths, s_paths, tab, nspa):
    """K3 as one library call over the [nbase*nspa, ng] view: index
    row*nspa + pos, weight ww*sw, for every (path, stencil, base) term."""
    import torch
    import torch.nn.functional as F

    nbase = tab.shape[0]
    lead = torch.broadcast_shapes(*[x.shape for p in w_paths + s_paths
                                    for pair in p for x in pair
                                    if x is not None])

    def weight(w):
        return (torch.ones(lead, dtype=tab.dtype, device=tab.device)
                if w is None else w.expand(lead))

    idx, wts = [], []
    for wp, sp in zip(w_paths, s_paths):
        for pos, sw in sp:
            pos = pos.expand(lead).long().clamp(0, nspa - 1)
            for row, ww in wp:
                row = row.expand(lead).long().clamp(0, nbase - 1)
                idx.append((row * nspa + pos).reshape(-1))
                wts.append((weight(ww) * weight(sw)).reshape(-1))
    idx = torch.stack(idx, 1).contiguous()
    wts = torch.stack(wts, 1).contiguous()
    view = tab.reshape(nbase * nspa, tab.shape[1] // nspa)
    shape = tuple(lead) + (view.shape[1],)
    return lambda: F.embedding_bag(idx, view, per_sample_weights=wts,
                                   mode="sum").view(shape)


def phase_ktable(rec, reps=20):
    """K4 and K3 against their plain versions on every recorded call, the
    recorded calls of each timed together (the radiation call's path), and
    timings on four of them.  Returns the two kernel lines' numbers."""
    import torch
    from fv3net_torch.ops import ktable_cuda

    worst = {"weighted_select_dot": 0.0, "spec_band_dot": 0.0}
    path = {}
    for name, calls, plain, cost, kernel in (
            ("weighted_select_dot", rec.select, _select_plain, _select_cost,
             ktable_cuda.weighted_select_dot_cuda),
            ("spec_band_dot", rec.spec, _spec_plain, _spec_cost,
             ktable_cuda.spec_band_dot_cuda)):
        path_bound = 0.0
        for i, (a, out) in enumerate(calls):
            err, scale = max_diff(out, plain(*a), f"{name} call {i}")
            tab = a[1] if len(a) == 2 else a[2]
            check(err <= KTABLE_RTOL["float32"] * scale,
                  f"{name} call {i} (tab {tuple(tab.shape)}): "
                  f"max|kernel-plain| {err} > {KTABLE_RTOL['float32']} * "
                  f"{scale}")
            worst[name] = max(worst[name], err)
            moved, flops = cost(*a, out) if len(a) == 2 else cost(a, out)
            path_bound += bound(moved, flops, "float32")[0]

        def run_path(calls=calls, kernel=kernel):
            for a, _ in calls:
                kernel(*a)

        before = read_counts()[name]
        ms = device_ms({"path": run_path}, 4, warmup=1)["path"]
        check(read_counts()[name] > before, f"{name} did not launch")
        path[name] = {"path_ms": ms, "path_bound_ms": path_bound}
        log(f"  {name}: {len(calls)} calls of one radiation call, kernel "
            f"against plain within {worst[name]:.3e} (float32); all of "
            f"them {ms:.4f} ms of device time against a bound of "
            f"{path_bound:.4f} ms ({100 * path_bound / ms:.1f}%)")

    def pick_select(shape):
        for a, _ in rec.select:
            if tuple(a[1].shape) == shape:
                return a
        raise SmokeFailure(f"no K4 call on a {shape} table")

    def pick_spec(shape, n_paths):
        for a, _ in rec.spec:
            if tuple(a[2].shape) == shape and len(a[0]) == n_paths:
                return a
        raise SmokeFailure(f"no K3 call on a {shape} table")

    cases = [
        ("weighted_select_dot", "selfref_all K=2",
         pick_select((10, 140))),
        ("weighted_select_dot", "mtab_lo1 K=4", pick_select((70, 54))),
        ("spec_band_dot", "LW band 3 lower (nspa 9, 2 paths, kw 2, st 3)",
         pick_spec((70, 9 * 16), 2)),
        ("spec_band_dot", "SW band 17 upper (nspa 5, 1 path, kw 4, st 2)",
         pick_spec((236, 5 * 12), 1)),
    ]
    lines = {}
    for name, label, a in cases:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).replace("torch.", "")

            def to(x):
                return (x.to(dtype) if torch.is_tensor(x)
                        and x.is_floating_point() else x)

            if name == "weighted_select_dot":
                terms, tab = a
                a_dt = ([(i, None if w is None else to(w)) for i, w in terms],
                        to(tab))
                kernel = ktable_cuda.weighted_select_dot_cuda

                def plain(a=a_dt):
                    return _select_plain(*a)

                lib = _embedding_bag_select(*a_dt)
            else:
                w_paths, s_paths, tab, nspa = a
                a_dt = tuple([[(i, None if w is None else to(w))
                               for i, w in path] for path in paths]
                             for paths in (w_paths, s_paths)) + (to(tab),
                                                                  nspa)
                kernel = ktable_cuda.spec_band_dot_cuda

                def plain(a=a_dt):
                    return _spec_plain(*a)

                lib = _embedding_bag_spec(*a_dt)
            before = read_counts()
            got = kernel(*a_dt)
            torch.cuda.synchronize()
            want = plain()
            err, scale = max_diff(got, want, f"{name} {label} {dname}")
            rtol = KTABLE_RTOL[dname]
            check(err <= rtol * scale, f"{name} {label} {dname}: "
                  f"max|kernel-plain| {err} > {rtol} * {scale}")
            lib_err = max_diff(lib(), want, f"embedding_bag {label}")[0]
            ms = device_ms({"plain": plain, "kernel": lambda: kernel(*a_dt),
                            "library": lib}, reps)
            check(read_counts() != before, f"{name} did not launch")
            moved, flops = (_select_cost(*a_dt, got)
                            if name == "weighted_select_dot"
                            else _spec_cost(a_dt, got))
            bound_ms, by = bound(moved, flops, dname)
            log(f"  {name} {label} {dname}: out {tuple(got.shape)}; "
                f"max|diff| {err:.3e} (scale {scale:.3e}, rtol {rtol}); "
                f"embedding_bag max|diff| {lib_err:.3e}; device time kernel "
                f"{ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
                f"embedding_bag {ms['library']:.4f} ms (lower of two); "
                f"{moved} bytes moved, {flops} flops, bound "
                f"{bound_ms:.4f} ms ({by}, "
                f"{100 * bound_ms / ms['kernel']:.1f}% of it)")
            # the kernel line reads the float32 call of the largest
            # output of each kernel on the main path
            if dtype == torch.float32 and label.startswith(
                    ("mtab_lo1", "LW band 3")):
                lines[name] = {"max_abs_err": worst[name],
                               "ms": ms["kernel"],
                               "plain_ms": ms["plain"],
                               "bound_ms": bound_ms, "bound_by": by,
                               "library_ms": ms["library"],
                               **path[name]}
    return lines


def _diffs(got, want, label, rtol):
    """Log each field's max |got - want| against its scale; returns the
    fields beyond ``rtol`` of their scale."""
    bad = []
    got, want = fields(got), fields(want)
    for name in ("pt", "delp", "wind", "sphum", "cloud_water"):
        err = (got[name] - want[name]).abs().max().item()
        scale = want[name].abs().max().item()
        rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        log(f"  {label} {name}: max|kernel-plain| {err:.3e} (scale "
            f"{scale:.3e}, rel {rel:.3e})")
        if rtol is not None and not rel <= rtol:
            bad.append(f"{label} {name} rel {rel:.3e} > {rtol}")
    return bad


def phase_step_vs_plain(device, state):
    """The same state through one step with the kernels and with the
    plain versions.

    Gated: the float32 dynamics step (the part of the step that calls K1)
    and the float64 gray step within 1e-5 of each field's scale, the
    float64 RRTMG step (radiation in float64) within 1e-10 on both
    routes of the LW gas optics.  The float32 RRTMG step is logged only: its column physics (near-surface humidity,
    convection triggers) amplifies roundoff-level differences (see
    PERF.md).
    """
    import torch
    from fv3net_torch import entry
    from fv3net_torch.dycore.core import GridArrays, dynamics_step
    from fv3net_torch.dycore.state import DycoreState

    grid = entry.make_grid(NPX)
    _, ak, bk = entry.init_state(grid, NPZ, dtype=torch.float32,
                                 device=device)
    g = GridArrays.from_grid(grid, torch.float32, device)
    akt = torch.tensor(ak, dtype=torch.float32, device=device)
    bkt = torch.tensor(bk, dtype=torch.float32, device=device)
    bad = _diffs(
        dynamics_step(state, g, akt, bkt, entry.FLAGSHIP_DYCORE, impl="cuda"),
        dynamics_step(state, g, akt, bkt, entry.FLAGSHIP_DYCORE,
                      impl="torch"),
        "float32 dynamics step", F32_RTOL,
    )

    cases = (("gray", torch.float64, F32_RTOL, "ktable"),
             ("rrtmg", torch.float32, None, "ktable"),
             ("rrtmg", torch.float64, RRTMG_STEP_RTOL, "ktable"),
             ("rrtmg", torch.float64, RRTMG_STEP_RTOL, "mega"))
    plain_out = {}  # the plain step does not depend on the route
    for radiation, dtype, rtol, lw_taumol in cases:
        s = DycoreState(
            delp=state.delp.to(dtype), pt=state.pt.to(dtype),
            wind=state.wind.to(dtype),
            tracers={k: v.to(dtype) for k, v in state.tracers.items()},
            phis=state.phis.to(dtype),
        )
        name = str(dtype).replace("torch.", "")
        label = f"{name} {radiation} step"
        if lw_taumol != "ktable":
            label += f" ({lw_taumol} route)"

        def run(impl):
            reset_counts()
            step, (_, mlp, sst, cosz) = entry.flagship(
                npx=NPX, npz=NPZ, radiation=radiation, chunk=None,
                device=device, dtype=dtype, impl=impl, lw_taumol=lw_taumol,
            )
            out = step(s, mlp, sst, cosz)
            torch.cuda.synchronize()
            return out, read_counts()

        if (radiation, dtype) not in plain_out:
            plain_out[radiation, dtype], counts = run("torch")
            check(not any(counts.values()),
                  f"plain {label} launched kernels: {counts}")
        out, counts = run("cuda")
        rrtmg = radiation == "rrtmg"
        mega = lw_taumol == "mega"
        want = launches(
            remap_apply=REMAPS_PER_STEP,
            weighted_select_dot=rrtmg * (MEGA_SELECT_PER_CALL if mega
                                         else SELECT_PER_CALL),
            spec_band_dot=rrtmg * (MEGA_SPEC_PER_CALL if mega
                                   else SPEC_PER_CALL),
            taumol_lw=int(mega),
        )
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        bad += _diffs(out, plain_out[radiation, dtype], label, rtol)
    check(not bad, f"kernel and plain paths part: {bad}")


def phase_taumol(k2_args, tables64, reps=10):
    """K2 against its plain version on the arguments of one radiation
    call of the main path, float32 and float64; returns its kernel-line
    numbers (float32)."""
    import torch
    from fv3net_torch.physics.radiation.rrtmg import lw as rlw
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda

    def to64(x):
        if isinstance(x, dict):
            return {k: to64(v) for k, v in x.items()}
        return x.double() if x.is_floating_point() else x

    line = {}
    for dname in ("float32", "float64"):
        args = k2_args if dname == "float32" else (
            tuple(to64(x) for x in k2_args[:6]) + (tables64,))
        before = read_counts()["taumol_lw"]
        got = taumol_cuda.taumol_lw_cuda(*args)
        torch.cuda.synchronize()
        check(read_counts()["taumol_lw"] == before + 1,
              "taumol_lw did not launch")
        want = rlw.taumol_lw_plain(*args)
        errs = {}
        for name, g, w in zip(("fracs", "tautot"), got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"K2 {dname} {name}: shape or dtype differs")
            err, scale = max_diff(g, w, f"K2 {dname} {name}")
            errs[name] = (err, scale)
            check(err <= TAUMOL_RTOL[dname] * scale,
                  f"K2 {dname} {name}: max|kernel-plain| {err} > "
                  f"{TAUMOL_RTOL[dname]} * {scale}")
            rel = torch.where(w != 0, (g - w).abs() / w.abs(),
                              (g != 0).to(w.dtype)).nan_to_num().max().item()
            errs[name] += (rel,)
            check(rel <= TAUMOL_VALUE_RTOL[dname],
                  f"K2 {dname} {name}: max relative |kernel-plain| of a "
                  f"value {rel} > {TAUMOL_VALUE_RTOL[dname]}")
        n_bad = int((~torch.isfinite(want[1])).sum())
        flat, meta, _ = taumol_cuda.pack_tables(args[6])
        planes, keep = taumol_cuda.pack_planes(*args[:6], flat)
        lead = tuple(got[0].shape[:-1])
        N = math.prod(lead)

        def packed(keep=keep):  # the launch alone, on planes packed before
            return taumol_cuda.taumol_lw_launch(planes, flat, meta, lead)

        dev = device_ms({
            "plain": lambda: rlw.taumol_lw_plain(*args),
            "kernel": lambda: taumol_cuda.taumol_lw_cuda(*args),
            "launch": packed,
            "ktable": lambda: rlw.taumol_lw(*args),
        }, reps)
        check(all(torch.equal(a.nan_to_num(), b.nan_to_num())
                  for a, b in zip(packed(), got)),
              "K2 gave two answers on the same planes")
        # the point planes (each at its own width) and the tables read
        # once, both outputs written once; ~2,000 flops per point
        point_bytes = N * (len(taumol_cuda.FLOAT_PLANES) * flat.element_size()
                           + sum(args[0][k].element_size()
                                 for k in taumol_cuda.INT_PLANES))
        moved = point_bytes + nbytes(flat, meta, *got)
        bound_ms, by = bound(moved, 2000 * N, dname)
        log(f"  K2 {dname}: N={N} points, fracs max|diff| "
            f"{errs['fracs'][0]:.3e} (scale {errs['fracs'][1]:.3e}), tautot "
            f"max|diff| {errs['tautot'][0]:.3e} (scale "
            f"{errs['tautot'][1]:.3e}), rtol {TAUMOL_RTOL[dname]}, value by "
            f"value within {errs['tautot'][2]:.3e} relative (bound "
            f"{TAUMOL_VALUE_RTOL[dname]}), "
            f"{n_bad} non-finite values (at the same points); device time "
            f"wrapper {dev['kernel']:.3f} ms (packing the plane pointers "
            f"and the launch), the launch alone "
            f"{dev['launch']:.3f} ms, plain {dev['plain']:.3f} ms, the "
            f"K3/K4 route {dev['ktable']:.3f} ms; {moved} bytes moved "
            f"({point_bytes} in the point planes, {nbytes(flat, meta)} "
            f"in the tables, {nbytes(*got)} out), bound {bound_ms:.4f} ms "
            f"({by})")
        if dname == "float32":
            # its path: the one call of a radiation call on the mega route
            line = {"max_abs_err": max(e[0] for e in errs.values()),
                    "ms": dev["kernel"], "plain_ms": dev["plain"],
                    "bound_ms": bound_ms, "bound_by": by,
                    "library_ms": None, "path_ms": dev["kernel"],
                    "path_bound_ms": bound_ms}
    return line


def phase_wavg(device, reps=20):
    """K5 against its plain version and the pooling form of the library;
    returns its kernel-line numbers (float32, the pipeline's
    [tile, z, y, x] call)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from fv3net_torch.ops import coarsen

    rng = np.random.RandomState(0)
    line = {}
    path = {"path_ms": 0.0, "path_bound_ms": 0.0}
    # the two calls the pipeline makes per time index (a weight plane per
    # tile: shared by the levels of a [tile, z, y, x] variable, one each
    # for a [tile, y, x] variable), then one plane for every batch, then a
    # shape off any tile size.  The weights are random, not cell areas:
    # the cube's six tiles have like areas, and a kernel that read another
    # tile's plane would pass with them
    cases = (((6, NZ_DIAG, C384, C384), (6, 1, C384, C384), COARSEN_FACTOR),
             ((6, C384, C384), (6, C384, C384), COARSEN_FACTOR),
             ((6 * NZ_DIAG, C384, C384), (C384, C384), COARSEN_FACTOR),
             ((6, 12, 12), (6, 12, 12), 2))
    for shape, w_shape, factor in cases:
        x = torch.tensor(rng.rand(*shape), dtype=torch.float32, device=device)
        w = torch.tensor(rng.rand(*w_shape), dtype=torch.float32,
                         device=device)
        before = read_counts()["weighted_block_average"]
        got = coarsen.weighted_block_average(x, w, factor)
        torch.cuda.synchronize()
        check(read_counts()["weighted_block_average"] == before + 1,
              "weighted_block_average did not launch")
        want = coarsen.weighted_block_average_plain(x, w, factor)
        check(got.shape == want.shape and torch.isfinite(got).all().item(),
              f"K5 {shape}: wrong shape or non-finite output")
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs()).max().item()
        check(rel <= WAVG_RTOL, f"K5 {shape} factor {factor}: max relative "
              f"|kernel-plain| {rel} > {WAVG_RTOL}")

        def library():  # the pooling form: means of x*w over means of w
            planes = (1, -1) + x.shape[-2:]  # avg_pool2d takes [N, C, y, x]
            return (F.avg_pool2d((x * w).reshape(planes), factor)
                    / F.avg_pool2d(w.expand(x.shape).reshape(planes), factor)
                    ).reshape(got.shape)

        lib_rel = ((library() - want).abs() / want.abs()).max().item()
        dev = device_ms({
            "plain": lambda: coarsen.weighted_block_average_plain(x, w,
                                                                  factor),
            "kernel": lambda: coarsen.weighted_block_average(x, w, factor),
            "library": library,
        }, reps)
        moved = nbytes(x, w, got)
        bound_ms, by = bound(moved, 3 * x.numel(), "float32")
        log(f"  K5 x {shape}, w {w_shape}, factor {factor}: max relative "
            f"|diff| {rel:.3e} (rtol {WAVG_RTOL}), max|diff| {err:.3e}; "
            f"avg_pool2d form max relative |diff| {lib_rel:.3e}; device "
            f"time kernel {dev['kernel']:.4f} ms, "
            f"plain {dev['plain']:.4f} ms, avg_pool2d form "
            f"{dev['library']:.4f} ms; {moved} bytes moved, bound "
            f"{bound_ms:.4f} ms ({by}), "
            f"{moved / dev['kernel'] / 1e6:.1f} GB/s")
        if shape in (cases[0][0], cases[1][0]):
            # its path: the pipeline's two calls of a time index
            path["path_ms"] += dev["kernel"]
            path["path_bound_ms"] += bound_ms
        if shape == cases[0][0]:
            line = {"max_abs_err": err, "ms": dev["kernel"],
                    "plain_ms": dev["plain"], "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": dev["library"]}
    log(f"  K5, the pipeline's two calls of a time index: "
        f"{path['path_ms']:.4f} ms of device time against a bound of "
        f"{path['path_bound_ms']:.4f} ms")
    return dict(line, **path)


def phase_pipeline(device):
    """The C384 -> C48 diagnostics pipeline on the card, from a seeded
    store in a temporary directory; returns the K5 launches it made."""
    import tempfile

    import numpy as np
    import torch
    from fv3net_torch.core import zarrio
    from fv3net_torch.core.dataset import Dataset
    from fv3net_torch.core.quantity import Quantity
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.ops import coarsen
    from fv3net_torch.pipelines.coarsen_diagnostics import coarsen_diagnostics

    rng = np.random.default_rng(0)
    nt, n, nc = PIPELINE_TIMES, C384, C384 // COARSEN_FACTOR
    t0 = time.perf_counter()
    ds = Dataset({
        "PRATEsfc": Quantity(
            rng.random((nt, 6, n, n), dtype=np.float32) * 1e-4,
            ("time", "tile", "y", "x"), units="kg/m2/s"),
        "air_temperature": Quantity(
            250.0 + 40.0 * rng.random((nt, 6, NZ_DIAG, n, n),
                                      dtype=np.float32),
            ("time", "tile", "z", "y", "x"), units="K"),
    })
    want_shapes = {"PRATEsfc": (nt, 6, nc, nc),
                   "air_temperature": (nt, 6, NZ_DIAG, nc, nc)}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "c384.zarr"), os.path.join(tmp, "c48.zarr")
        zarrio.to_zarr(ds, src, chunks={"time": 1})
        t_write = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        coarsen_diagnostics(src, dst, COARSEN_FACTOR, device=device)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = read_counts()
        out = zarrio.open_zarr(dst)
    check(counts == launches(weighted_block_average=len(ds) * nt),
          f"pipeline: launches {counts}, expected one K5 launch per "
          f"variable and time ({len(ds) * nt})")
    check(sorted(out) == sorted(ds), f"pipeline wrote {sorted(out)}")
    area = torch.tensor(make_grid(n).area, dtype=torch.float64, device=device)
    area_c = coarsen.block_sum(area, COARSEN_FACTOR)
    for name, shape in want_shapes.items():
        q = out[name]
        check(q.shape == shape and q.dims == ds[name].dims
              and q.values.dtype == np.float32,
              f"pipeline {name}: shape {q.shape} dims {q.dims}")
        check(bool(np.isfinite(q.values).all()), f"pipeline {name}: "
              "non-finite values")
        fine = torch.tensor(ds[name].values, device=device)
        coarse = torch.tensor(q.values, device=device)
        wf = area if fine.ndim == 4 else area[:, None]
        want = coarsen.weighted_block_average_plain(fine, wf.float(),
                                                    COARSEN_FACTOR)
        rel = ((coarse - want).abs() / want.abs()).max().item()
        check(rel <= WAVG_RTOL, f"pipeline {name}: max relative |output - "
              f"plain block average| {rel} > {WAVG_RTOL}")
        log(f"  pipeline {name}: every value within {rel:.3e} relative of "
            f"the plain block average (rtol {WAVG_RTOL})")
        del want
        fine, coarse = fine.double(), coarse.double()
        wc = area_c if fine.ndim == 4 else area_c[:, None]
        lead = tuple(range(1, fine.ndim))
        mean_f = (fine * wf).sum(lead) / wf.expand(fine.shape[1:]).sum()
        mean_c = (coarse * wc).sum(lead) / wc.expand(coarse.shape[1:]).sum()
        rel = ((mean_c - mean_f).abs() / mean_f.abs()).max().item()
        log(f"  pipeline {name}: {tuple(ds[name].shape)} -> {q.shape}, "
            f"area-weighted global mean kept to {rel:.3e} relative (bound "
            f"{PIPELINE_MEAN_RTOL})")
        check(rel <= PIPELINE_MEAN_RTOL, f"pipeline {name}: global mean "
              f"moved by {rel} relative")
    log(f"  pipeline: C{n} -> C{nc}, {nt} time indices, {len(ds)} "
        f"variables: store written in {t_write:.1f} s, coarsen_diagnostics "
        f"{t_run:.2f} s ({t_run / nt:.2f} s per time index, reading and "
        f"writing the stores included), launches {counts}")
    return counts


# K3 calls of the yardstick (--kernel-times): (nbase, nspa, ng, n_paths,
# kw, st) of LW band 3 lower, the main path's K3 kernel-line call, and of
# LW band 3 upper, the largest table (236 x 80)
K3_YARDSTICK = {"LW band 3 lower": (70, 9, 16, 2, 2, 3),
                "LW band 3 upper": (236, 5, 16, 2, 2, 2)}


# the production chunk (entry.production): one warm-up and this many
# timed chunks, then one under the profiler
PRODUCTION_TIMED_CHUNKS = 5
# its kernels against its plain versions, within each field's scale
# times the CPU chunk tests' bound (tests/test_torch_production.py
# CHUNK_RTOL): a 2-step float64 chunk with a model that leaves the ML
# limiter idle, and 1 step with one whose limiter acts (the next step's
# remap parts states that differ only in the signs of the residues the
# limiter leaves, as the reference's does)
PRODUCTION_STEPS_VS_PLAIN = 2
# the tendency scales of the batch that sets the dense model's output
# scaler: the entry's (dQ2 ~1e-6 /s through the scaler's 1e-7 floor) and
# the CPU stepper tests' (dQ2 large enough that the limiter acts)
QUIET_DQ_SCALE = (1e-6, 1e-9)
ACTING_DQ_SCALE = (1e-5, 3e-6)
PRODUCTION_CHUNK_RTOL = 1e-8
# the mass gate.  The ML humidity setter keeps each layer's dry air mass
# and moves delp, so the air mass is not kept (2 float64 steps at C6 move
# it by 7.4e-5); the physics moves water without moving delp, so the dry
# air mass changes by the column's water change.  The gate is the
# dry-air budget: the change of the global dry air mass less the chunk's
# precipitation less evaporation (chunk_accumulated_*) less the change
# of the cloud water mass, within the flagship's air-mass bound of the
# dry air mass (the budget closes to 1e-16 in float64 on the CPU)
DRY_MASS_BUDGET_RTOL = 1e-5
SST_RANGE = (200.0, 330.0)  # K


def production_masses(dycore, area):
    """(dry air mass, cloud water mass) over the globe [kg], float64."""
    import torch
    from fv3net_torch.core.constants import GRAVITY

    delp = dycore.delp.to(torch.float64)
    q = dycore.tracers["sphum"].to(torch.float64)
    qc = dycore.tracers["cloud_water"].to(torch.float64)
    a = area.to(torch.float64)
    return (((delp * (1.0 - q)).sum(1) * a).sum().item() / GRAVITY,
            ((delp * qc).sum(1) * a).sum().item() / GRAVITY)


def production_gates(label, before, out, area):
    """Gates one production chunk's output ``out`` = (dycore, surface,
    diags) from the dycore ``before``: every field finite, SST inside
    SST_RANGE, ice thickness >= 0, the chunk's TOTAL_PRECIP >= 0, and the
    dry-air budget (DRY_MASS_BUDGET_RTOL).  Returns the budget's
    residual."""
    import torch
    from fv3net_torch.runtime import names

    dycore, surface, diags = out
    for group, tensors in (("state", fields(dycore)), ("surface", surface),
                           ("diagnostic", diags)):
        for name, x in tensors.items():
            check(torch.isfinite(x).all().item(),
                  f"{label}: non-finite {group} {name}")
    sst = surface[names.SST]
    lo, hi = sst.min().item(), sst.max().item()
    check(SST_RANGE[0] <= lo and hi <= SST_RANGE[1],
          f"{label}: SST {lo} .. {hi} K outside {SST_RANGE}")
    check((surface["ice_thickness"] >= 0).all().item(),
          f"{label}: negative ice thickness")
    check((diags[names.TOTAL_PRECIP] >= 0).all().item(),
          f"{label}: negative chunk TOTAL_PRECIP")
    dry0, wc0 = production_masses(before, area)
    dry1, wc1 = production_masses(dycore, area)
    a = area.to(torch.float64)
    p_minus_e = ((diags["chunk_accumulated_PRATEsfc"].double()
                  - diags["chunk_accumulated_evaporation"].double())
                 * a).sum().item()
    residual = (dry1 - dry0 - p_minus_e - (wc1 - wc0)) / dry0
    check(abs(residual) <= DRY_MASS_BUDGET_RTOL,
          f"{label}: dry-air budget residual {residual:.3e} > "
          f"{DRY_MASS_BUDGET_RTOL}")
    log(f"  {label}: SST {lo:.2f} .. {hi:.2f} K, ice up to "
        f"{surface['ice_thickness'].max().item():.4f} m, chunk "
        f"TOTAL_PRECIP up to {diags[names.TOTAL_PRECIP].max().item():.3e} "
        f"m; dry-air mass change {(dry1 - dry0) / dry0:.3e}, budget "
        f"residual {residual:.3e}")
    return residual


def production_launches(steps, radiation_calls):
    """Expected launches of a production chunk: K1 on every step's three
    remaps (theta_v with iv=2, the winds, the tracers: remap_te is off),
    K4 and K3 in every radiation call, no K2."""
    return launches(remap_apply=steps * REMAPS_PER_STEP,
                    weighted_select_dot=radiation_calls * SELECT_PER_CALL,
                    spec_band_dot=radiation_calls * SPEC_PER_CALL)


def run_production_chunk(label, chunk, args, area, expected):
    """One production chunk from launch counts set to 0; gates the counts
    read after it and its output.  Returns (output, seconds, counts)."""
    import torch

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = chunk(*args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    check(counts == expected,
          f"{label}: launches {counts}, expected {expected}")
    production_gates(label, args[0], out, area)
    log(f"  {label}: {dt * 1e3:.1f} ms, launches {counts}")
    return out, dt, counts


def phase_production(device):
    """The production chunk at full width (entry.production: C48, npz=32,
    float32, RRTMG every 4th step, slab ocean and sea ice, the "set" SST
    prescriber, the dense ML stepper): a warm-up chunk, timed chunks and
    one profiled chunk.  Returns its launches over the chunks run."""
    import torch
    from fv3net_torch import entry

    t0 = time.perf_counter()
    chunk, (dycore, surface, cosz, presc) = entry.production(
        npx=NPX, npz=NPZ, chunk=CHUNK, device=device)
    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    log(f"  built the production chunk in {time.perf_counter() - t0:.2f} s")
    expected = production_launches(CHUNK, RADIATION_CALLS_PER_CHUNK)
    total = launches()
    wall = []
    for i in range(1 + PRODUCTION_TIMED_CHUNKS):
        label = (f"production chunk {i} "
                 f"({'warm-up' if i == 0 else 'timed'})")
        (dycore, surface, _), dt, counts = run_production_chunk(
            label, chunk, (dycore, surface, cosz, presc), area, expected)
        total = {k: v + counts[k] for k, v in total.items()}
        if i:
            wall.append(dt)
    ms = statistics.median(wall) * 1e3
    sypd = (CHUNK * DT / (ms / 1e3)) / 365.0
    log(f"  production main path: {ms:.1f} ms per {CHUNK}-step chunk "
        f"(median of {len(wall)}; {', '.join(f'{w * 1e3:.1f}' for w in wall)}"
        f"), {sypd:.3f} SYPD; launches in {1 + len(wall)} chunks {total}")
    reading = profile_chunk(
        "production", lambda: chunk(dycore, surface, cosz, presc))
    log("  production profiled chunk: wall "
        f"{reading['wall_ms']:.1f} ms, device busy "
        f"{reading['device_ms']:.1f} ms, idle share "
        f"{100 * (1 - reading['device_ms'] / reading['wall_ms']):.1f}%, "
        f"{reading['activities']} device activities; range device busy "
        + ", ".join(f"{r} {v:.1f} ms" for r, v in reading["ranges"].items())
        + "; hand kernels " + ", ".join(
            f"{k} {n} launches {t:.3f} ms"
            for k, (n, t) in reading["kernels"].items()))
    return total


def production_model(device, dtype, dq_scale):
    """The production entry's seeded dense model (1 hidden layer of 16),
    its output scaler fitted to tendencies of the scales ``dq_scale``."""
    from fv3net_torch import entry

    return entry.flagship_dense_model(NPZ, dtype, device, 0, hidden=(16,),
                                      n=64, dq_scale=dq_scale)


def quiet_production_model(device, dtype):
    """The production entry's seeded dense model with its outputs scaled
    by 1e-4 (its last layer), so that the ML limiter does not act: where
    it acts it leaves q at +-1e-18, and the next step's kord-9 tracer
    remap takes a layer for an extremum from the sign of q[k+1] - q[k]
    between two such residues, which is the sign of roundoff (the CPU
    chunk tests take the same scaling;
    test_production_chunk_limiter_active_step_by_step shows the
    reference's step doing so)."""
    import torch

    model = production_model(device, dtype, QUIET_DQ_SCALE)
    with torch.no_grad():
        model.layers[-1].weight.mul_(1e-4)
        model.layers[-1].bias.mul_(1e-4)
    return model


def phase_production_vs_plain(device):
    """Float64 production chunks at C48 with the kernels and with the
    plain versions: 2 steps with radiation every second step (step 1
    takes the cache) and the quiet model, then 1 step with a model whose
    limiter acts (gated: some q left within 1e-15 of 0).
    The dycore fields, every surface field, the chunk's TOTAL_PRECIP and
    chunk_accumulated_* within PRODUCTION_CHUNK_RTOL of each field's
    scale."""
    import torch
    from fv3net_torch import entry
    from fv3net_torch.runtime import names

    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    bad = []
    for label, model, steps in (
            ("float64 production chunk",
             quiet_production_model(device, torch.float64),
             PRODUCTION_STEPS_VS_PLAIN),
            ("float64 production step, limiter acting",
             production_model(device, torch.float64, ACTING_DQ_SCALE), 1)):
        outs = {}
        for impl in ("torch", "cuda"):
            chunk, args = entry.production(
                npx=NPX, npz=NPZ, chunk=steps, radiation_interval=2,
                model=model, dtype=torch.float64, device=device, impl=impl)
            expected = (launches() if impl == "torch" else
                        production_launches(steps, 1))
            outs[impl], _, _ = run_production_chunk(
                f"{label} ({impl})", chunk, args, area, expected)
        (kd, ks, kdiag), (pd, ps, pdiag) = outs["cuda"], outs["torch"]
        if steps == 1:
            residues = (pd.tracers["sphum"].abs() < 1e-15).sum().item()
            log(f"  {label}: {residues} points of q within 1e-15 of 0")
            check(residues > 0, f"{label}: the ML limiter did not act")
        bad += _diffs(kd, pd, label, PRODUCTION_CHUNK_RTOL)
        pairs = [(f"surface {k}", ks[k], ps[k]) for k in sorted(ps)]
        pairs += [(k, kdiag[k], pdiag[k]) for k in sorted(pdiag)
                  if k == names.TOTAL_PRECIP
                  or k.startswith("chunk_accumulated_")]
        check(set(ks) == set(ps) and set(kdiag) == set(pdiag),
              f"{label}: the kernel and plain chunks return other keys")
        for name, got, want in pairs:
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            rel = (err / scale if scale > 0
                   else (0.0 if err == 0 else math.inf))
            log(f"  {label} {name}: max|kernel-plain| {err:.3e} (scale "
                f"{scale:.3e}, rel {rel:.3e})")
            if not rel <= PRODUCTION_CHUNK_RTOL:
                bad.append(f"{label} {name} rel {rel:.3e}")
    check(not bad, f"production kernel and plain chunks part: {bad}")


def phase_production_land(device):
    """One chunk of the production chunk's land variant: the Noah soil
    on tile 0 with a seeded subgrid orography there (so the step runs
    the gravity-wave drag); the production gates, soil moisture inside
    [0, theta_sat], and GWD's launched stress >= 0 everywhere and > 0
    over the land."""
    import numpy as np
    import torch
    from fv3net_torch import entry
    from fv3net_torch.physics.soil import SoilParams

    rng = np.random.RandomState(0)
    mask = np.zeros((6, NPX, NPX))
    mask[0] = 1.0
    sgh = mask * (100.0 + 400.0 * rng.rand(6, NPX, NPX))  # m
    chunk, args = entry.production(
        npx=NPX, npz=NPZ, chunk=CHUNK, device=device, land_model="noah",
        land_mask=mask, sgh=sgh)
    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    (_, surface, diags), _, _ = run_production_chunk(
        "land-variant chunk", chunk, args, area,
        production_launches(CHUNK, RADIATION_CALLS_PER_CHUNK))
    smc = surface["soil_moisture_layers"]
    theta_sat = SoilParams().theta_sat
    lo, hi = smc.min().item(), smc.max().item()
    check(0.0 <= lo and hi <= theta_sat,
          f"land variant: soil moisture {lo} .. {hi} outside "
          f"[0, {theta_sat}]")
    tau = diags["taugwd"]
    land = torch.tensor(mask, device=device) > 0.5
    check((tau >= 0).all().item(), "land variant: negative taugwd")
    check((tau[land] > 0).all().item(),
          "land variant: taugwd is 0 at a land point")
    log(f"  land variant: soil moisture {lo:.4f} .. {hi:.4f} (theta_sat "
        f"{theta_sat}), taugwd over land {tau[land].min().item():.3e} .. "
        f"{tau[land].max().item():.3e} N/m2, over the ocean "
        f"{tau[~land].max().item():.3e}")


def k3_call(device, dtype, case, seed=1):
    """``(w_paths, s_paths, tab, nspa)`` of a seeded K3 call of
    ``K3_YARDSTICK[case]`` at the radiation's 442,368 points ([13,824, 32],
    ids int64 and weights of ``dtype``, as the main path holds them)."""
    import numpy as np
    import torch

    nbase, nspa, ng, n_paths, kw, st = K3_YARDSTICK[case]
    rng = np.random.RandomState(seed)
    lead = (6 * NPX * NPX, NPZ)

    def pairs(hi, n, scale):
        return [(torch.tensor(rng.randint(0, hi, lead), dtype=torch.int64,
                              device=device),
                 torch.tensor(scale * rng.rand(*lead), dtype=dtype,
                              device=device)) for _ in range(n)]

    w_paths = [pairs(nbase, kw, 1.0) for _ in range(n_paths)]
    s_paths = [pairs(nspa, st, 1e3) for _ in range(n_paths)]
    tab = torch.tensor(rng.rand(nbase, nspa * ng), dtype=dtype,
                       device=device)
    return w_paths, s_paths, tab, nspa


def column_state(C, L, seed=0):
    """Seeded radiation inputs of C columns x L levels on the hybrid
    coordinate (numpy; z index 0 = model top), with clouds in half the
    layers; returns ``(state, cosz)``."""
    import numpy as np
    from fv3net_torch.dycore.vertical import hybrid_coordinate

    rng = np.random.RandomState(seed)
    ak, bk = hybrid_coordinate(L)
    pe = ak[None] + bk[None] * (1e5 + 3000 * rng.randn(C))[:, None]
    pmid = 0.5 * (pe[:, 1:] + pe[:, :-1])
    T = np.maximum(290 * (pmid / 1e5) ** 0.2, 200) + 3 * rng.randn(C, L)
    lat = rng.uniform(-1.4, 1.4, C)
    state = {
        "air_temperature": T,
        "pressure_thickness_of_atmospheric_layer": np.diff(pe, axis=1),
        "specific_humidity": 0.02 * (pmid / 1e5) ** 3 * rng.rand(C, L) ** 2,
        "cloud_water_mixing_ratio": 1e-4 * rng.rand(C, L) * (
            rng.rand(C, L) > 0.5),
        "surface_temperature": T[:, -1] + 1,
        "latitude": lat,
        "longitude": rng.uniform(0, 6.28, C),
    }
    return state, np.clip(np.cos(lat), -0.3, 1)


def k2_call(device, dtype, seed=0):
    """The arguments ``(c, colamt, coldry, colbrd, wx, tauaer, T)`` that
    one RRTMG call on the mega route hands to K2's wrapper, on seeded
    columns at the flagship's size (13,824 x 32), made by the tree's own
    ``RRTMGDriver``."""
    import datetime

    import torch
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda
    from fv3net_torch.physics.radiation.rrtmg.driver import (
        RRTMGConfig,
        RRTMGDriver,
    )

    state, cosz = column_state(6 * NPX * NPX, NPZ, seed)
    driver = RRTMGDriver(RRTMGConfig(), dtype=dtype, device=device,
                         lw_taumol="mega")
    with Capture(taumol_cuda, "taumol_lw_cuda") as call:
        driver(datetime.datetime(2016, 7, 1),
               {k: torch.tensor(v, dtype=dtype, device=device)
                for k, v in state.items()},
               cosz=torch.tensor(cosz, dtype=dtype, device=device))
    torch.cuda.synchronize()
    check(call.args is not None, "the RRTMG call made no K2 call")
    return call.args


def k2_launch(args):
    """A function that runs K2's launch alone on the arguments' point
    planes, packed once beforehand, in the tree's own form."""
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda as tc

    flat, meta, _ = tc.pack_tables(args[6])
    lead = tuple(args[2].shape)
    if hasattr(tc, "pack_points"):  # a tree that copies the planes
        fp, ip = tc.pack_points(*args[:6])
        return lambda: tc.taumol_lw_packed(fp, ip, flat, meta, lead)
    planes, keep = tc.pack_planes(*args[:6], flat)
    return lambda keep=keep: tc.taumol_lw_launch(planes, flat, meta, lead)


def digest(*tensors):
    """sha256 (first 16 hex digits) of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def resource_usage(path):
    """``cuobjdump --dump-resource-usage`` of a built library: per kernel
    instance (demangled where ``cu++filt`` is found) its registers, stack,
    shared and local bytes."""
    import re
    import shutil

    cuda_bin = "/usr/local/cuda/bin"
    tool = shutil.which("cuobjdump") or os.path.join(cuda_bin, "cuobjdump")
    out = subprocess.run([tool, "--dump-resource-usage", str(path)],
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    filt = shutil.which("cu++filt") or os.path.join(cuda_bin, "cu++filt")
    rows = []
    for line in out.stdout.splitlines():  # "Function f:", then its usage
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            if os.path.exists(filt):
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True).stdout.strip() or name
            rows.append((name, {}))
        res = re.findall(r"\b(REG|STACK|SHARED|LOCAL):(\d+)", line)
        if res and rows:
            rows[-1][1].update({k: int(v) for k, v in res})
    return rows


def log_plans():
    """How the tree's K3 and K2 launch on this card (points per tile,
    shared bytes, threads, blocks an SM holds by
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), where the tree
    reports it."""
    import torch
    from fv3net_torch.ops import ktable_cuda
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda

    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).replace("torch.", "")
        if hasattr(ktable_cuda, "spec_plan"):
            for case, (nbase, nspa, ng, n_paths, kw, st) in \
                    K3_YARDSTICK.items():
                plan = ktable_cuda.spec_plan(dtype, n_paths * (kw + st), ng)
                log(f"  K3 {case} {dname}: {plan}")
        if hasattr(taumol_cuda, "launch_plan"):
            log(f"  K2 {dname}: {taumol_cuda.launch_plan(dtype)}")


def kernel_times(device, reps=30):
    """The yardstick on which two trees' kernels are compared
    (``--kernel-times``; ``--tree`` picks the tree).

    K1 on the dycore step's three calls (F = 3, 2, 1 at C48, npz=32); K4
    on a call shaped as the main path's ``mtab_lo1`` selection (4 terms
    of int64 ids and float32 weights at the radiation's 442,368 points into
    a 70 x 54 table; seeded, not recorded); K3 through
    ``ktable.spec_band_dot`` on seeded calls shaped as LW band 3 lower and
    as LW band 3 upper, the largest table (``K3_YARDSTICK``), in float32
    and float64; K2 through ``taumol_cuda.taumol_lw_cuda`` on the arguments
    that the tree's own RRTMG driver makes from seeded columns
    (:func:`k2_call`), float32 and float64, and its launch alone.  Each is
    timed three ways: CUDA events around one wrapper call with the host's
    work in (:func:`interleaved_ms`, how PRs 1-3 timed the kernels),
    device time (:func:`device_ms`), and the host's microseconds per call
    queued back to back; K3's and K2's outputs also by their digest
    (:func:`digest`), equal on two trees when they agree bit for bit.
    Then K1's float32 readings against the exact (float64) application at
    km=32 and at km=79, the kernel's and the plain version's.  Returns
    them as a dict."""
    import numpy as np
    import torch
    from fv3net_torch.ops import ktable, remap_cuda
    from fv3net_torch.physics.radiation.rrtmg import lw as rlw
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda

    def host_us(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    out = {}

    def three_ways(name, fn, n=reps, **extra):
        v = out[name] = dict({"events_ms": interleaved_ms({"k": fn}, n)["k"],
                              "device_ms": device_ms({"k": fn}, n)["k"],
                              "host_us": host_us(fn)}, **extra)
        log(f"  {name}: CUDA events of one call (host work in) "
            f"{v['events_ms']:.4f} ms, device time {v['device_ms']:.4f} ms, "
            f"host {v['host_us']:.1f} us per call"
            + (f", digest {v['digest']}" if "digest" in v else ""))

    for F in (3, 2, 1):
        args = remap_inputs(device, torch.float32, F)
        three_ways(f"K1 F={F}", lambda a=args: remap_cuda.remap_apply_cuda(*a))
    rng = np.random.RandomState(0)
    lead, rows, G = (6 * NPX * NPX, NPZ), 70, 54
    tab = torch.tensor(rng.rand(rows, G), dtype=torch.float32, device=device)
    terms = [(torch.tensor(rng.randint(0, rows, lead), dtype=torch.int64,
                           device=device),
              torch.tensor(rng.rand(*lead), dtype=torch.float32,
                           device=device)) for _ in range(4)]
    got = ktable.weighted_select_dot(terms, tab)
    err = (got - ktable.weighted_select_dot_plain(terms, tab)).abs().max()
    check(err.item() <= KTABLE_RTOL["float32"] * got.abs().max().item(),
          f"K4 mtab_lo1 shape: max|kernel-plain| {err.item()}")
    three_ways("K4 mtab_lo1", lambda: ktable.weighted_select_dot(terms, tab))
    for case in K3_YARDSTICK:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).replace("torch.", "")
            a = k3_call(device, dtype, case)
            got = ktable.spec_band_dot(*a)
            torch.cuda.synchronize()
            err, scale = max_diff(got, ktable.spec_band_dot_plain(*a),
                                  f"K3 {case} {dname}")
            check(err <= KTABLE_RTOL[dname] * scale,
                  f"K3 {case} {dname}: max|kernel-plain| {err}")
            three_ways(f"K3 {case} {dname}",
                       lambda a=a: ktable.spec_band_dot(*a),
                       digest=digest(got))
            del a, got
    for dtype, n in ((torch.float32, 10), (torch.float64, 5)):
        dname = str(dtype).replace("torch.", "")
        args = k2_call(device, dtype)
        got = taumol_cuda.taumol_lw_cuda(*args)
        torch.cuda.synchronize()
        want = rlw.taumol_lw_plain(*args)
        for name, g, w in zip(("fracs", "tautot"), got, want):
            err, scale = max_diff(g, w, f"K2 {dname} {name}")
            check(err <= TAUMOL_RTOL[dname] * scale,
                  f"K2 {dname} {name}: max|kernel-plain| {err}")
        three_ways(f"K2 {dname}",
                   lambda a=args: taumol_cuda.taumol_lw_cuda(*a), n,
                   digest=digest(*got))
        three_ways(f"K2 {dname} launch", k2_launch(args), n)
        del args, got, want
    for npz in (NPZ, KM_DEEP):
        args = remap_inputs(device, torch.float32, 3, npz)
        got = remap_cuda.remap_apply_cuda(*args)
        scale, err, err_k, err_p = remap_readings(args, got)
        out[f"K1 float32 F=3 km={npz}"] = {
            "scale": scale, "kernel_plain": err, "kernel_exact": err_k,
            "plain_exact": err_p}
        log(f"  K1 float32 F=3 km={npz}: max|kernel-plain| {err:.3e} "
            f"({err / scale:.3e} of scale {scale:.3e}); against the exact "
            f"application: kernel {err_k:.3e} ({err_k / scale:.3e}), plain "
            f"{err_p:.3e} ({err_p / scale:.3e})")
    return out


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--kernel-times", action="store_true",
        help="build K1-K4 and time them on one yardstick (see "
             "kernel_times) instead of the smoke run")
    parser.add_argument(
        "--sw-columns", metavar="PATH",
        help="also save swrad's arguments on the columns where float32 SW "
             "heating parts most from float64 (phase 6) to PATH (.npz)")
    parser.add_argument(
        "--tree", default=os.path.dirname(os.path.abspath(__file__)),
        help="directory whose fv3net_torch is imported (default: this "
             "script's)")
    opts = parser.parse_args()
    import torch

    log("phase 1: device")
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: this smoke run needs a CUDA "
          "card (the port has no CPU path here)")
    smi = nvidia_smi()
    log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    try:
        import fv3net_torch.entry  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"fv3net_torch is not in {tree}: {e}")
    check(os.path.dirname(os.path.dirname(fv3net_torch.__file__)) == tree,
          f"fv3net_torch came from {fv3net_torch.__file__}, not {tree}")
    device = torch.device(DEVICE)
    t_start = time.perf_counter()
    if opts.kernel_times:
        from fv3net_torch.ops import ktable_cuda, remap_cuda
        from fv3net_torch.physics.radiation.rrtmg import taumol_cuda

        log(f"kernel times of {tree}")
        for m in (remap_cuda, ktable_cuda, taumol_cuda):
            path = m.build().path
            log(f"  built {path.name}")
            if m is not remap_cuda:
                for name, res in resource_usage(path):
                    log(f"  resources of {name}: {res}")
        log_plans()
        print(json.dumps({"kernel_times": kernel_times(device),
                          "device": smi}), flush=True)
        return 0

    log("phase 2: build")
    build_kernels()
    log_plans()

    log("phase 3: remap kernel K1 against its plain version")
    remap_line = phase_remap_kernel(device)

    log("phase 4: gray main path")
    phase_gray(device)

    log("phase 5: RRTMG main path, LW gas optics through K4/K3 and "
        "through K2")
    paths, states = phase_rrtmg(device)
    state = states[RADIATION_STATES_AFTER[-1]]
    counts, counts_mega = paths["ktable"].counts, paths["mega"].counts
    _, sst, cosz = paths["ktable"].args
    del paths

    log("phase 6: one RRTMG radiation call")
    rec, k2_args, tables64 = phase_radiation(
        device, states, sst, cosz, sw_columns=opts.sw_columns, smi=smi)

    log("phase 7: k-table kernels K4 and K3 against their plain versions")
    ktable_lines = phase_ktable(rec)
    del rec, states

    log("phase 8: one step, kernels against plain")
    phase_step_vs_plain(device, state)

    log("phase 9: LW gas-optics kernel K2 against its plain version")
    taumol_line = phase_taumol(k2_args, tables64)
    del k2_args, tables64

    log("phase 10: block-average kernel K5 against its plain version")
    wavg_line = phase_wavg(device)

    log("phase 11: C384 -> C48 coarsening pipeline")
    counts_pipeline = phase_pipeline(device)

    log("phase 12: production main path (slab ocean, sea ice, the SST "
        "prescriber and the ML stepper around the RRTMG step)")
    phase_production(device)

    log("phase 13: production chunk, kernels against plain (float64)")
    phase_production_vs_plain(device)

    log("phase 14: production land variant (Noah soil, gravity-wave drag)")
    phase_production_land(device)

    # each kernel's launches come from the run of the path it lies on
    counts = dict(counts, taumol_lw=counts_mega["taumol_lw"],
                  weighted_block_average=counts_pipeline[
                      "weighted_block_average"])
    common = {
        "remap_apply": {"source": "fv3net_torch/csrc/remap_apply.cu",
                        "replaces": "fv3net_tpu/ops/pallas_remap.py:58",
                        "library_ms": None, **remap_line},
        "weighted_select_dot": {
            "source": "fv3net_torch/csrc/ktable.cu",
            "replaces": "fv3net_tpu/ops/pallas_ktable.py:35",
            **ktable_lines["weighted_select_dot"]},
        "spec_band_dot": {
            "source": "fv3net_torch/csrc/ktable.cu",
            "replaces": "fv3net_tpu/ops/pallas_ktable.py:97",
            **ktable_lines["spec_band_dot"]},
        "taumol_lw": {
            "source": "fv3net_torch/csrc/taumol_lw.cu",
            "replaces": "fv3net_tpu/physics/radiation/rrtmg/"
                        "pallas_taumol.py:73",
            **taumol_line},
        "weighted_block_average": {
            "source": "fv3net_torch/csrc/wavg.cu",
            "replaces": "fv3net_tpu/ops/pallas_kernels.py:25",
            **wavg_line},
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": v["source"],
         "replaces": v["replaces"], "launches": counts[name],
         "max_abs_err": v["max_abs_err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
         "bound_by": v["bound_by"], "library_ms": v["library_ms"],
         "path_ms": v["path_ms"], "path_bound_ms": v["path_bound_ms"]}
        for name, v in common.items()
    ]}
    for k in line["kernels"]:
        check(k["launches"] > 0, f"{k['name']} was launched no time on its "
              "path")
        for value in k.values():
            check(not isinstance(value, float) or math.isfinite(value),
                  "non-finite number in the kernel line")
    log(f"  all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
