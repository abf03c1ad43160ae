#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fv3net_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, and no result line is printed):

1. device: a CUDA card is required (there is no CPU path); prints the
   card's name and power limit and the torch / CUDA versions;
2. build: compiles the port's four CUDA sources for sm_90a from this
   checkout, one ``nvcc`` each, all at once: ``remap_apply.cu`` (K1),
   ``ktable.cu`` (K4 and K3, float32, float64 and bfloat16 instances),
   ``taumol_lw.cu`` (K2) and ``wavg.cu`` (K5),
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
   float32 call on both routes against the plain versions beside the
   plain call in float64: every heating rate and flux parts by at most
   twice what float32 itself errs there; and the same calls with the SW
   two-stream in float64 on every side (which takes the state-dependent
   float32 cancellation out) within absolute bounds, beside the plain
   call with bfloat16 tables, which must part by at least 3 times what
   the kernels do; one LW call alone on
   each route; then every K4 and K3 call of that float32 call against
   its plain version value by value, within the two versions' own
   float32 summation roundoff, the bfloat16-table control at least 10
   times farther on every call;
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
    stress >= 0, and > 0 over the land;
15. the segmented run (``runtime/segmented_run/api.py``) of the
    production configuration as a run config (:func:`segment_config`:
    C48, npz=32, RRTMG every 4th step, slab ocean and sea ice, the
    namelist's dycore, phase 13's quiet dense model loaded from its
    artifact directory, a zarr SST prescriber, zarr diagnostics and a
    Fortran diagnostics file): ``api.create`` and two
    ``api.append_segment`` calls of 2 chunks each, with each segment's
    setup seconds, wall per chunk in ``run_segment``, SYPD and host
    seconds by phase (``timing.phase_report``).  Gates: the production
    path taken; every chunk's launches exact (K1 24, K4 88, K3 46, K2 0)
    and phase 12's gates; the stores' rows and variables, the
    interval-average rows against the every rows they cover (1e-6), the
    RESTART's files; segment 1's RESTART read back and segment 2's first
    chunk started from it, bit for bit; the two segments against one
    segment of 4 chunks, bit for bit; a fresh loop's first chunk (under
    the profiler: device busy by range, idle share) against
    ``build_fused_production_chunk`` called directly on its inputs, bit
    for bit; one float64 chunk of 2 steps through the loop, kernels
    against plain, within 1e-8 of each field's scale;
16. the RRTMG options: the flagship chunk with the reference's
    accelerator radiation settings (bf16 storage, SW daylight
    compression: ``flagship(rrtmg_options=BF16_OPTIONS)``) in turns with
    the default chunk, one warm-up and 5 timed each, and one profiled:
    ms per chunk, SYPD, device busy, idle share, the radiation range;
    launches exact per chunk by kernel and by instance (K4/K3 float32 or
    bfloat16); every K4 and K3 call of one bf16 radiation call on phase
    6's state against its plain bfloat16 version, bit for bit, timed
    with ``embedding_bag`` on bf16 as the yardstick; that call's bf16
    storage against float32 storage within the reference's bounds (root
    mean square), daylight compression on against off, the lookup-table
    transmittances against the direct exponentials within the
    reference's quantization bounds; a C96 call in 16,384-column blocks
    against the unblocked call (the reference's bounds) and a C192 call
    in blocks, with each call's time and peak memory;
17. the dycore options: the JW06 baroclinic wave
    (``dycore/testcases.py``) at C48 through 8 steps under the
    reference's ``DycoreConfig()`` (advection order 2), order 1 and
    order 4 with kord 7 (ppm_profile into K1): finite fields, air-mass
    drift, exact K1 launches, ms per 8 steps; one float64 step of each,
    kernels against plain, within 1e-10 of each field's scale; K1
    against plain on ppm_profile's profiles at kord 4-7 and on the
    ``iv=-2`` profile with a surface value;
18. K2 under bf16 storage: the flagship chunk with the reference's
    accelerator radiation settings on the mega route
    (``flagship(lw_taumol="mega", rrtmg_options=BF16_OPTIONS)``: K2's
    bfloat16 instance) in turns with the same settings on the ktable
    route, one warm-up and 3 timed each, the mega route's chunk profiled
    beside phase 16's profiled chunk of the ktable route (the same
    configuration): launches exact by kernel and by instance, ms per
    chunk, SYPD, device busy, the radiation range, idle share; K2's
    bfloat16 instance against its plain
    version on the arguments of one bf16 radiation call on phase 6's
    state, value by value (at most 1 bfloat16 ulp, the share of differing
    values printed), with its device time beside the plain version, the
    ktable route's bf16 gas optics and its bound;
19. the FV3GFS-style C48 namelist through the segmented run: phase 15's
    configuration with ``fv_core_nml`` (hydrostatic false, n_split 3),
    ``gfs_physics_nml`` (imp_physics 11: GFDL microphysics),
    ``prognostic_ozone`` and ``stratospheric_h2o``, from a moist JW06
    restart; two ``append_segment`` segments of 2 chunks, each chunk's
    launches exact (K1 4 a step: w with the winds, o3mr and the GFDL
    species with the tracers, delz as specific volume), phase 12's gates
    (the dry-air budget over all condensates), w and delz finite, delz >
    0, the GFDL scheme making condensate; 2 x 2 chunks against 1 x 4 bit
    for bit; a fresh loop's chunk profiled; the device time and
    activities of the sedimentation loop and the acoustic solve; one
    float64 chunk of 2 steps, kernels against plain, within 1e-8;
20. the online microphysics emulator through the segmented run: phase
    15's configuration with ``online_emulator`` (a dense artifact of the
    exact map q -> 0.99 q, T and cloud water passed through, written with
    the port's ``DenseModel.dump``; target microphysics), two
    ``append_segment`` segments of 2 chunks, each chunk gated as phase 12
    (K1 24, K4 88, K3 46, K2 0; the dry-air budget) and q >= 0, segment 2
    started from segment 1's RESTART bit for bit, a fresh loop's chunk
    profiled; one chunk with a seeded model in the gscond slot,
    piggy-backed, its six emulator and physics tendencies in the zarr
    store; one float64 chunk of 2 steps, kernels against plain, 1e-8;
21. the Python radiation stepper (``radiation_scheme``: rrtmg) in a
    per-step TimeLoop at C48 beside the gray model radiation, 4 steps:
    K1 3, K4 44, K3 23 a step, its fluxes among the diagnostics, ms a
    step; with ``apply_heating`` its dQ1 equal to its heating rate; one
    ``GFSRadiationDriver`` call on the 13,824 C48 columns in GFS layout,
    float64 (seeded sfcprop, emissivity map and condensate, McICA
    uniforms from a ``torch.Generator``) against the same call with the
    plain versions within 1e-10 of each output's scale, its K4/K3 calls
    value by value within their summation roundoff, ms a call;
22. the flagship chunk with the synthetic band radiation
    (``flagship(radiation="synthband")``): K1 24 a chunk and no other
    hand kernel, ms a chunk, SYPD, device busy and activities, its
    heating and fluxes finite; a float64 chunk of 2 steps, kernels
    against plain, 1e-8; ``held_suarez_forcing`` on the C48 JW06 state on
    the card against its CPU result, 1e-6;
23. the dense trainer: ``entry.train_entry_model`` (the flagship's 2 x
    128 on 256 samples, production's 1 x 16 on 64, one epoch) on the
    card in float32 and float64, the float64 weights within 1e-10 of
    scale of the same training on the CPU, ms a training (phases 4-5
    and 12-20 drive the entries with these trained models);
24. the sharded dry run, ``entry.dryrun_multigpu(4)`` in four processes
    over gloo on the one card, each rank computing its block with the
    hand kernels: the nonhydrostatic RRTMG step within 2e-5 of one
    device, the 8-step production chunk within 5e-3, ``write_sharded``
    exact, a data-parallel Adam step within 1e-5, the C384 case within
    1e-3; each rank's K1/K4/K3 launches equal to one device's;
25. the nudged run: phase 15's configuration without its ML model,
    ``nudging`` T, q, both winds and delp (3 h) toward a seeded
    9-time reference store, per step (RRTMG each step: K1 3, K4 44, K3
    23 a step) through 2 ``append_segment`` segments of 4 steps: launches
    and finite fields, the nudging diagnostics in the zarr store, 2 x 4
    steps against 1 x 8 bit for bit, T nearer its reference than without
    nudging, one float64 step kernels against plain (1e-8) whose
    nudging tendencies equal (ref - state) / tau on the host (1e-12),
    ms a step, SYPD, a profiled step;
26. prescribed tendencies: the production configuration with a limited
    prephysics ``tendency_prescriber`` of a seeded dQ1/dQ2 store with
    outliers, as 2 fused chunks of 4 ("tend") and as 8 per-step steps;
    the limiter's bounds equal to ``np.quantile``, no prescribed value
    outside them, exact launches; the top-level ``tendency_prescriber``
    with ``bias_correction`` every 1800 s (fires on steps 1, 3, 5, 7);
    float64, the 2 fused chunks against the 8 per-step steps within
    1e-10 (radiation every step: the per-step path has no interval);
27. the reservoir corrector: ``reservoir``, ``hybrid_reservoir`` (state
    500, 64 column features) and ``subdomain_reservoir`` (2 x 2
    subdomains a tile, overlap 1, a [60, 6, 48, 48, 64] series) trained
    on the card and on the CPU, held-out predictions within 1e-4; the
    hybrid and the subdomain model as ``reservoir_corrector`` over 2
    segments of 4 steps, the second warm-started from
    ``save_reservoir_state``, and a diagnostic-only step: launches, the
    increment before the predict, predictions after the synchronization
    equal to the host's float64 readout (1e-5) and landing in the state;
    ms of one increment, ms a step, the trainers' seconds;
28. the offline ops and pipelines at C384 -> C48, factor 8, float32, on
    a seeded 79-level state with the GFDL tracer set on the card:
    ``coarsen_state_on_sigma``, ``_on_pressure`` and ``_blended`` and
    ``compute_budget`` (each timed twice), ``coarsen_sfc_data_complex``
    (blocks without snow: K5 over all-zero weights), their exact K5
    launches, each K5 call against its plain version on its own
    arguments (NaN at the same places, 128 roundings of 2^-24 of scale),
    the whole calls against their plain runs by NaN and finiteness, the
    coarse column mass against the fine; float64 sigma, pressure and
    budget calls on 8 levels, kernels against plain within 1e-12; the
    ``coarsen_restarts`` CLI (blended) in a process of its own on a
    C384 Fortran-layout restart directory that ``save_fortran_restarts``
    writes (its seconds, K5 launches and peak RSS); ``coarsen_surface``
    on 24 subtile shards with float64 areas through the runner's 4
    threads (every tile ok on its first attempt, the files against the
    float64 block average); ``regrid_zarr_to_latlon`` of the C48 state
    to 180 x 360, gated by conservation; the phase's peak device memory.

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
``path_bound_ms`` the sum of their bounds.  ``weighted_select_dot_bf16``
and ``spec_band_dot_bf16`` are K4's and K3's bfloat16 instances, their
launches from phase 16's bf16 chunks, their bound at 2 bytes a bfloat16
value; ``taumol_lw_bf16`` is K2's bfloat16 instance, its launches from
phase 18's mega-route bf16 chunks, its bound at 2 bytes a bfloat16
output; ``weighted_select_dot_f64`` and ``spec_band_dot_f64`` are K4's
and K3's float64 instances at the float64 GFS chain's shapes, their
launches from phase 21's GFS call (``path_ms``: the call's 44 and 23
calls).  The script imports nothing of jax or of ``fv3net_tpu``.
"""
import concurrent.futures
import gc
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
# rest of the phase (times, recorded kernel calls) is on the last
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
# float32 radiation call, kernels against plain, on each state of
# RADIATION_STATES_AFTER.  As the main path makes it, the call is held
# to the same call's controls, which use the plain versions and the same
# McICA draws: the call in float64 (what float32 roundoff itself moves).
# Two float32 results that each err from the float64 one by e part by at
# most 2 e (RAD_F32_CONTROL_FACTOR; the control below RAD_F32_ULPS
# float32 ulps of the quantity's largest value counts as that many ulps).
#   The float32 SW two-stream cancels (inherited, ROADMAP Queue 3) and
# lifts any roundoff of the gas optics by a factor that depends on the
# state: on one state the kernels' SW heating parted from plain by
# 1.348e-2 K/day, on another by 2.69e-2, with float32 itself erring by
# 7e-2 to 1.9e-1.  So the call is also made with the two-stream in
# float64 on every side (TwoStream64), and there held to two absolute
# bounds (first set, on the float32 call, from an H100's readings), and
# the control with every selection table rounded to bfloat16 (a
# precision fault the gate must catch) must part from plain by at least
# RAD_F32_FAULT_RATIO times what the kernels do, or the comparison could
# not tell a sound kernel from that fault.
RAD_F32_HEATING_K_DAY = 2e-2
RAD_F32_FLUX_W_M2 = 2e-2
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
    if state.w is not None:  # the nonhydrostatic prognostics
        out.update(w=state.w, delz=state.delz)
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
    ktable_cuda.SELECT_BY_DTYPE = dict.fromkeys(ktable_cuda.SELECT_BY_DTYPE,
                                                0)
    ktable_cuda.SPEC_BY_DTYPE = dict.fromkeys(ktable_cuda.SPEC_BY_DTYPE, 0)
    taumol_cuda.TAUMOL_LAUNCHES = 0
    taumol_cuda.LAUNCHES_BY_INSTANCE = dict.fromkeys(
        taumol_cuda.LAUNCHES_BY_INSTANCE, 0)
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
        # K4's and K3's launches a chunk by instance, where gated
        # (read_instance_counts), and their sums
        self.per_instance = None
        self.instance_totals = {}

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
        if self.per_instance is not None:
            inst = read_instance_counts()
            check(inst == self.per_instance, f"{label} chunk {i}: launches "
                  f"by instance {inst}, expected {self.per_instance}")
            self.instance_totals = {k: self.instance_totals.get(k, 0) + v
                                    for k, v in inst.items()}
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
    states that phases 6, 8, 16 and 18 run on, by the ktable route's
    chunks before them."""
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


# names the profiler's own event list leaves out (torch.autograd.profiler
# _filter_name)
PROFILER_UTILITY_OPS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def kineto_totals(prof):
    """The sums of a profiler run that ``key_averages()`` gives, read
    from the profiler's raw (kineto) events without building its event
    tree, which takes tens of seconds for a chunk's several hundred
    thousand events.  As there, a device event counts toward the
    front-end CPU op whose correlation id it is linked to, and an op's
    device time takes in that of every op nested in it on its thread.

    Returns ``(device, ranges, spans, ops)``: the device activities by
    name ([count, ns]), less the ranges' device-side spans; each range of
    ``RANGES`` as [calls, host ns, device ns]; the spans' device ns by
    range; the front-end ops by name ([count, device ns of the kernels
    linked to them])."""
    import bisect

    from torch.autograd import DeviceType

    attached, device, spans, ops, marks = {}, {}, {}, {}, []
    by_thread = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in PROFILER_UTILITY_OPS or (
                hasattr(e, "is_hidden_event") and e.is_hidden_event()):
            continue
        linked = e.linked_correlation_id()
        if e.device_type() != DeviceType.CPU:
            ns = e.duration_ns()
            if linked > 0:
                attached[linked] = attached.get(linked, 0) + ns
            if name in RANGES:
                spans[name] = spans.get(name, 0) + ns
            elif ns > 0:
                c = device.setdefault(name, [0, 0])
                c[0] += 1
                c[1] += ns
        elif (linked == 0 and not e.is_async()
              and e.start_thread_id() == e.end_thread_id()):
            op = (e.start_ns(), e.end_ns(), e.correlation_id(), name)
            by_thread.setdefault(e.start_thread_id(), []).append(op)
            if name in RANGES:
                marks.append((e.start_thread_id(), op))
    for thread_ops in by_thread.values():
        thread_ops.sort()
        for _, _, corr, name in thread_ops:
            c = ops.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += attached.get(corr, 0)
    ranges = {}
    for thread, (t0, t1, _, name) in marks:
        thread_ops = by_thread[thread]
        i = bisect.bisect_left(thread_ops, (t0,))
        ns = 0
        while i < len(thread_ops) and thread_ops[i][0] < t1:
            if thread_ops[i][1] <= t1:
                ns += attached.get(thread_ops[i][2], 0)
            i += 1
        r = ranges.setdefault(name, [0, 0, 0])
        r[0] += 1
        r[1] += t1 - t0
        r[2] += ns
    return device, ranges, spans, ops


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
    device, ranges, spans, ops = kineto_totals(prof)
    device_us = sum(ns for _, ns in device.values()) / 1e3
    n_kernels = sum(n for n, _ in device.values())
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
        mine = [c for name, c in device.items() if kname in name]
        if not mine:
            continue
        n = sum(c[0] for c in mine)
        us = sum(c[1] for c in mine) / 1e3
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
    for name in RANGES:
        if name not in ranges or ranges[name][1] <= 0:
            continue
        calls, host_ns, dev_ns = ranges[name]
        # the kernels of the PyTorch ops inside the range, and the hand
        # kernels it launched
        busy = dev_ns / 1e3 + hand_us[name]
        reading["ranges"][name] = busy / 1e3
        span_us = spans[name] / 1e3 if name in spans else float("nan")
        log(f"  range {name}: {calls} calls, host "
            f"{host_ns / 1e6:.1f} ms, device busy "
            f"{busy / 1e3:.1f} ms ({100 * busy / max(device_us, 1e-9):.1f}% "
            f"of device busy; hand kernels {hand_us[name] / 1e3:.3f} ms of "
            f"it), device span {span_us / 1e3:.1f} ms")
    top = sorted([(ns, n, name) for name, (n, ns) in device.items()]
                 + [(ns, n, name) for name, (n, ns) in ops.items()
                    if ns > 0 and name not in RANGES], reverse=True)[:15]
    log("  | device ms  calls  name (device activities, and the ops whose "
        "kernels they are)")
    for ns, n, name in top:
        log(f"  | {ns / 1e6:9.3f} {n:6d}  {name[:90]}")
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


class TwoStream64:
    """Makes the SW solver take its layers' two-stream properties
    (``rrtmg.sw._twostream``) in float64, cast back to the call's dtype:
    the float32 cancellation there (inherited from the reference, ROADMAP
    Queue 3) amplifies any roundoff of the gas optics by a factor that
    depends on the state, which this takes out of a comparison."""

    def __init__(self):
        from fv3net_torch.physics.radiation.rrtmg import sw

        self.mod, self.orig = sw, sw._twostream

    def __enter__(self):
        import torch

        orig = self.orig

        def twostream(*args, **kwargs):
            dtype = args[0].dtype

            def up(x):
                return x.double() if torch.is_tensor(x) else x

            out = orig(*[up(x) for x in args],
                       **{k: up(v) for k, v in kwargs.items()})
            return tuple(x.to(dtype) for x in out)

        self.mod._twostream = twostream
        return self

    def __exit__(self, *exc):
        self.mod._twostream = self.orig


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


def radiation_differences(out, delp, where, isolated=False):
    """Logs, per heating rate and flux of one float32 radiation call, how
    far the kernels (both routes) and the controls part from the plain
    versions; returns the failed gates.  The float32 call as the main
    path makes it: at most RAD_F32_CONTROL_FACTOR times the float64
    control's reading.  ``isolated``, the same call with the SW
    two-stream in float64 on every side (``TwoStream64``): within the
    absolute bounds RAD_F32_*, and the bfloat16-table control at least
    RAD_F32_FAULT_RATIO times the kernels' reading."""
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
    controls = ("bfloat16 tables",) if isolated else ("float64",
                                                      "bfloat16 tables")
    tag = ("float32, SW two-stream in float64" if isolated else "float32")
    bad = []
    for label, key, unit_scale, unit, limit in quantities:
        d = {name: unit_scale * dmax(out[name][key], out["plain"][key])
             for name in ("kernels", "mega") + controls}
        routes = unit_scale * dmax(out["mega"][key], out["kernels"][key])
        worst = max(d["kernels"], d["mega"])
        ratio = d["bfloat16 tables"] / worst if worst else math.inf
        if isolated:
            allowed = limit
            against = "bound"
        else:
            scale = unit_scale * out["plain"][key].abs().max().item()
            allowed = RAD_F32_CONTROL_FACTOR * max(
                d["float64"], RAD_F32_ULPS * eps * scale)
            against = "from the float64 control"
        log(f"  {tag} {label}: kernels against plain {d['kernels']:.3e} "
            f"{unit}, mega route against plain {d['mega']:.3e} (allowed "
            f"{allowed:.3e}), mega against ktable route {routes:.3e}; "
            "controls, " + ("" if isolated else "plain float32 against "
                            f"float64 {d['float64']:.3e}, ")
            + f"against bfloat16 tables {d['bfloat16 tables']:.3e} "
            f"({ratio:.3g} times the kernels' reading"
            + (f", needed {RAD_F32_FAULT_RATIO})" if isolated else ")"))
        for name in ("kernels", "mega"):
            if not d[name] <= allowed:
                bad.append(f"{where}, {tag}: {name} {label} {d[name]} "
                           f"{unit} > {allowed} {against}")
        if isolated and not d["bfloat16 tables"] >= RAD_F32_FAULT_RATIO * worst:
            bad.append(f"{where}, {tag}: {label}: the bfloat16-table "
                       f"control {d['bfloat16 tables']} {unit} is less "
                       f"than {RAD_F32_FAULT_RATIO} times the kernels' "
                       f"{worst}")
    if isolated:
        return bad

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

    def outputs(state, float64=True):
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
               for name, d in drivers.items()
               if float64 or name != "float64"}
        with BFloat16Tables():
            out["bfloat16 tables"] = drivers["plain"](when, inputs,
                                                      cosz=cosz)
        return out, delp

    bad = []
    for after in RADIATION_STATES_AFTER:
        where = f"after {after} chunks"
        log(f"  the state after {after} chunks of the ktable route:")
        with TwoStream64():
            isolated, _ = outputs(states[after], float64=False)
        bad += radiation_differences(isolated, None, where, isolated=True)
        del isolated
        with Capture(rlw, "lwrad") as lw_call:
            out, delp = outputs(states[after])
        bad += radiation_differences(out, delp, where)
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


def phase_taumol(k2_args, tables64, reps=3):
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
# of the condensate mass, within the flagship's air-mass bound of the
# dry air mass (the budget closes to 1e-16 in float64 on the CPU).  The
# namelist of phase 19 adds stratospheric water by design (h2ophys: a
# relaxation of a few ppmv over 100 days, above 100 hPa only), which a
# 2-hour chunk turns into a change of the dry air mass far inside the
# bound
DRY_MASS_BUDGET_RTOL = 1e-5
SST_RANGE = (200.0, 330.0)  # K


# the condensates a state may carry: cloud water (the liquid in GFDL
# mode) and the GFDL scheme's four others
CONDENSATES = ("cloud_water", "ice_wat", "rainwat", "snowwat", "graupel")


def production_masses(dycore, area):
    """(dry air mass, condensate mass) over the globe [kg], float64."""
    import torch
    from fv3net_torch.core.constants import GRAVITY

    delp = dycore.delp.to(torch.float64)
    q = dycore.tracers["sphum"].to(torch.float64)
    qc = sum(dycore.tracers[k].to(torch.float64) for k in CONDENSATES
             if k in dycore.tracers)
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
    if dycore.delz is not None:
        check((dycore.delz > 0).all().item(),
              f"{label}: a layer of thickness delz <= 0")
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
    """The production entry's dense model (1 hidden layer of 16), trained
    one epoch on the entry's sample batch with tendencies of the scales
    ``dq_scale``."""
    from fv3net_torch import entry

    return entry.train_entry_model(NPZ, dtype, device, 0, hidden=(16,),
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


# phase 15: the segmented run (runtime/segmented_run/api.py) at full
# width: SEGMENT_CHUNKS chunks a segment, two appended segments
SEGMENT_CHUNKS = 2
SEGMENT_AVERAGE_S = 7200.0  # the interval-average file's window
SEGMENT_SST_TIMES = 3  # time indices of the seeded SST store
SEGMENT_EVERY = ("air_temperature", "specific_humidity", "eastward_wind",
                 "surface_pressure")
SEGMENT_AVERAGED = ("total_precipitation", "ULWRFtoa", "DSWRFsfc",
                    "surface_pressure")
SEGMENT_AVERAGE_RTOL = 1e-6  # an average row against its every rows
SEGMENT_PHASES = ("setup", "loop_dispatch", "diag_observe", "scalar_flush",
                  "restart_write")


def segment_config(tmp, chunks=SEGMENT_CHUNKS):
    """The production configuration as a run config: C48, npz=32, RRTMG
    every 4th step, slab ocean and sea ice, the namelist's dycore
    defaults (hord 4, kord 9, remap_te, d2_bg_k1/k2 0.12/0.06, tau 0.5 d
    down to rf_cutoff 300 hPa); phase 13's quiet dense model (1 x 16,
    seeded) in the reference's artifact format; a "set" prescriber of
    ocean_surface_temperature from a seeded store of SEGMENT_SST_TIMES
    times; an every file of state fields (zarr chunks of 2 times), an
    interval-average file of the chunk's 2-D fields and one Fortran
    diagnostics file."""
    import numpy as np
    import torch
    from fv3net_torch.core import zarrio
    from fv3net_torch.core.dataset import Dataset
    from fv3net_torch.core.quantity import Quantity
    from fv3net_torch.fit import io
    from fv3net_torch.grid.geometry import make_grid

    model_dir = os.path.join(tmp, "model")
    if not os.path.isdir(model_dir):
        io.dump(quiet_production_model("cpu", torch.float32), model_dir)
        lat = make_grid(NPX).lat
        rng = np.random.RandomState(0)
        sst = ((300.15 - 30.0 * np.sin(lat) ** 2)[None]
               + 0.5 * rng.rand(SEGMENT_SST_TIMES, 6, NPX, NPX))
        zarrio.to_zarr(Dataset({"ocean_surface_temperature": Quantity(
            sst.astype(np.float32), ("time", "tile", "y", "x"))}),
            os.path.join(tmp, "sst.zarr"))
    return {
        "namelist": {"npx": NPX, "npz": NPZ, "radiation": "rrtmg",
                     "slab_ocean": True, "sea_ice": True},
        "fused_chunk_steps": CHUNK,
        "radiation_interval_steps": 4,
        "duration_seconds": chunks * CHUNK * DT,
        "scikit_learn": {"model": [model_dir]},
        "prephysics": [{"dataset": os.path.join(tmp, "sst.zarr"),
                        "variables": ["ocean_surface_temperature"]}],
        "diagnostics": [
            {"name": "state_after_timestep.zarr",
             "variables": list(SEGMENT_EVERY), "times": {"kind": "every"},
             "chunks": {"time": 2}},
            {"name": "surface_averages.zarr",
             "variables": list(SEGMENT_AVERAGED),
             "times": {"kind": "interval-average",
                       "frequency": SEGMENT_AVERAGE_S}},
        ],
        "fortran_diagnostics": [
            {"name": "atmos_dt_atmos.zarr", "times": {"kind": "every"},
             "variables": [{"module_name": "dynamics",
                            "field_name": "water_vapor_path",
                            "output_name": "PWAT"}]},
        ],
    }


class ChunkRecorder:
    """While active, every chunk a TimeLoop runs is recorded: its inputs,
    its output and the launches it made (counts set to 0 just before the
    chunk, read just after), and the loops that ran them."""

    def __init__(self):
        from fv3net_torch.runtime import loop

        self.cls, self.orig = loop.TimeLoop, loop.TimeLoop._chunk_fn
        self.chunks, self.loops = [], []

    def __enter__(self):
        orig, rec = self.orig, self

        def chunk_fn(loop, n_steps):
            fn = orig(loop, n_steps)
            if not rec.loops or rec.loops[-1] is not loop:
                rec.loops.append(loop)

            def run(*args):
                reset_counts()
                out = fn(*args)
                rec.chunks.append((n_steps, args, out, read_counts()))
                return out

            return run

        self.cls._chunk_fn = chunk_fn
        return self

    def __exit__(self, *exc):
        self.cls._chunk_fn = self.orig


def state_tensors(state):
    """name -> tensor of a ModelState, dycore and surface."""
    from fv3net_torch.runtime import checkpoint

    return checkpoint._state_arrays(state)


def same_bits(got, want, label):
    """Gate: the two states hold the same keys and equal tensors."""
    import torch

    a, b = state_tensors(got), state_tensors(want)
    check(set(a) == set(b), f"{label}: keys {sorted(a)} against "
          f"{sorted(b)}")
    bad = [k for k in b if not torch.equal(a[k].to(b[k].device), b[k])]
    check(not bad, f"{label}: not bit for bit in {bad}")
    log(f"  {label}: bit for bit in all {len(b)} fields")


def gate_segment(label, rec, area, expected):
    """Gates the chunks of one recorded segment: the launches, the
    production gates (finite, SST, ice, precipitation, dry-air budget).
    Returns the launches summed."""
    from fv3net_torch.runtime.metrics import GLOBAL_MEANS_KEY

    total = launches()
    for i, (n, args, out, counts) in enumerate(rec.chunks):
        check(n == CHUNK, f"{label} chunk {i}: {n} steps")
        check(counts == expected, f"{label} chunk {i}: launches {counts}, "
              f"expected {expected}")
        dycore, surface, diags = out
        production_gates(f"{label} chunk {i}", args[0], (dycore, surface, {
            k: q.data for k, q in diags.items() if k != GLOBAL_MEANS_KEY}),
            area)
        total = {k: v + counts[k] for k, v in total.items()}
    return total


def gate_stores(label, seg, chunks):
    """Gates one segment's output: the zarr stores' rows and variables,
    the interval-average rows against the every rows they cover, the
    Fortran restart files."""
    import numpy as np
    from fv3net_torch.core import zarrio

    every = zarrio.open_zarr(os.path.join(seg, "state_after_timestep.zarr"))
    avg = zarrio.open_zarr(os.path.join(seg, "surface_averages.zarr"))
    fortran = zarrio.open_zarr(os.path.join(seg, "atmos_dt_atmos.zarr"))
    per_window = int(SEGMENT_AVERAGE_S // (CHUNK * DT))
    for name, ds, want_vars, rows in (
            ("every", every, SEGMENT_EVERY, chunks),
            ("interval-average", avg, SEGMENT_AVERAGED,
             chunks // per_window),
            ("fortran", fortran, ("PWAT",), chunks)):
        check(sorted(ds) == sorted(want_vars), f"{label} {name} store: "
              f"variables {sorted(ds)}")
        for k in want_vars:
            check(ds[k].shape[0] == rows and np.isfinite(ds[k].values).all(),
                  f"{label} {name} {k}: shape {ds[k].shape}, {rows} finite "
                  "rows expected")
    ps_every = every["surface_pressure"].values.astype(np.float64)
    ps_avg = avg["surface_pressure"].values.astype(np.float64)
    worst = 0.0
    for w in range(ps_avg.shape[0]):
        mean = ps_every[w * per_window:(w + 1) * per_window].mean(axis=0)
        worst = max(worst, np.abs(ps_avg[w] - mean).max()
                    / np.abs(mean).max())
    check(worst <= SEGMENT_AVERAGE_RTOL, f"{label}: interval-average rows "
          f"part from the mean of their every rows by {worst:.3e}")
    restart = os.path.join(seg, "RESTART")
    want_files = ["coupler.res", "restart.json", "state.npz"] + [
        f"{c}.tile{t}.nc" for c in ("fv_core.res", "fv_tracer.res",
                                    "fv_srf_wnd.res", "sfc_data")
        for t in range(1, 7)]
    missing = sorted(set(want_files) - set(os.listdir(restart)))
    check(not missing, f"{label}: RESTART lacks {missing}")
    log(f"  {label} stores: every {chunks} rows, interval-average "
        f"{chunks // per_window} rows within {worst:.3e} of the mean of "
        f"their every rows, fortran {chunks} rows; RESTART with "
        f"{len(want_files)} files")


def log_segment(label, report, chunks, seconds, chunk_steps=CHUNK):
    """Logs one segment's phase report, wall per chunk (of
    ``chunk_steps`` steps) in run_segment and SYPD; returns the wall per
    chunk (s)."""
    for name in SEGMENT_PHASES:
        check(name in report, f"{label}: no {name} in the phase report")
    loop_s = sum(report[k]["total_seconds"] for k in
                 ("loop_dispatch", "diag_observe", "scalar_flush"))
    per_chunk = loop_s / chunks
    log(f"  {label}: {seconds:.2f} s in all; setup "
        f"{report['setup']['total_seconds']:.2f} s; wall per chunk in "
        f"run_segment {per_chunk * 1e3:.1f} ms "
        f"({chunk_steps * DT / per_chunk / 365.0:.3f} SYPD); host seconds "
        + ", ".join(f"{k} {report[k]['total_seconds']:.3f} "
                    f"({report[k]['hits']} hits)"
                    for k in SEGMENT_PHASES[1:])
        + "; " + ", ".join(f"{k} {v:.0f}" for k, v in report.items()
                           if not isinstance(v, dict)))
    return per_chunk


def loop_kernels_vs_plain(label, cfg64, expected):
    """One float64 chunk of 2 steps (or, on the per-step path, the
    config's steps) through the TimeLoop with the kernels and with the
    plain versions: the launches (``expected`` with the kernels, none
    without), every state field and TOTAL_PRECIP, ULWRFtoa
    and DSWRFsfc where the chunk emits them, within
    PRODUCTION_CHUNK_RTOL of each field's scale.  Returns the names of
    the state fields compared."""
    import torch
    from fv3net_torch.runtime import names
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop

    outs = {}
    for impl in ("torch", "cuda"):
        loop = TimeLoop(get_config(cfg64), dtype=torch.float64, impl=impl)
        reset_counts()
        (_, diags), = list(loop)
        counts = read_counts()
        want = launches() if impl == "torch" else expected
        check(counts == want, f"{label} ({impl}): launches {counts}, "
              f"expected {want}")
        outs[impl] = (loop.state, diags)
    (ks, kdiags), (ps, pdiags) = outs["cuda"], outs["torch"]
    kt, pt = state_tensors(ks), state_tensors(ps)
    pairs = [(k, kt[k], pt[k]) for k in sorted(pt)]
    pairs += [(k, kdiags[k].data, pdiags[k].data)
              for k in (names.TOTAL_PRECIP, "ULWRFtoa", "DSWRFsfc")
              if k in pdiags]
    bad, worst = [], 0.0
    for name, got, want in pairs:
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        worst = max(worst, rel)
        if not rel <= PRODUCTION_CHUNK_RTOL:
            bad.append(f"{name} rel {rel:.3e}")
    check(not bad, f"{label}, kernels against plain: {bad}")
    steps = int(cfg64["duration_seconds"] // DT)
    log(f"  {label} of {steps} step(s), kernels against plain: {len(pairs)} fields "
        f"within {worst:.3e} of their scale (bound {PRODUCTION_CHUNK_RTOL})")
    return set(pt)


def phase_segmented_run(device):
    """The segmented run (runtime/segmented_run/api.py) on the card at
    C48: ``api.create`` and two ``api.append_segment`` calls of
    SEGMENT_CHUNKS production chunks each, gated per chunk as phase 12
    and per segment by its stores and RESTART; the first chunk of a fresh
    TimeLoop (under the profiler) against build_fused_production_chunk
    called directly on its inputs, bit for bit; segment 1's RESTART read
    back bit for bit and segment 2 started from it; the two segments
    against one segment of twice the chunks, bit for bit; and one float64
    chunk of 2 steps through the loop, kernels against plain.  Returns
    the launches of the appended segments."""
    import logging
    import tempfile

    import torch
    from fv3net_torch import entry
    from fv3net_torch.runtime import checkpoint, names, timing
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.segmented_run import api

    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    expected = production_launches(CHUNK, RADIATION_CALLS_PER_CHUNK)
    scalar_lines = []
    handler = logging.Handler()
    handler.emit = lambda record: scalar_lines.append(record.getMessage())
    stats = logging.getLogger("statistics")
    stats.addHandler(handler)
    stats.setLevel(logging.INFO)
    total = launches()
    tmp = tempfile.mkdtemp(prefix="segmented_run_")
    try:
        url = os.path.join(tmp, "run")
        api.create(url, segment_config(tmp))
        segs, loops = [], []
        for s in (1, 2):
            with ChunkRecorder() as rec:
                t0 = time.perf_counter()
                segs.append(api.append_segment(url))
                seconds = time.perf_counter() - t0
            report = timing.phase_report()
            label = f"segment {s}"
            check(len(rec.loops) == 1, f"{label}: {len(rec.loops)} loops")
            loop = rec.loops[0]
            check(loop.fusable() and loop._production_features(),
                  f"{label}: the production path was not taken")
            check(len(rec.chunks) == SEGMENT_CHUNKS,
                  f"{label}: {len(rec.chunks)} chunks")
            counts = gate_segment(label, rec, area, expected)
            total = {k: v + counts[k] for k, v in total.items()}
            log_segment(label, report, SEGMENT_CHUNKS, seconds)
            gate_stores(label, segs[-1], SEGMENT_CHUNKS)
            if s == 1:
                restart = os.path.join(segs[0], "RESTART")
                state, t_end = checkpoint.load_state(restart)
                same_bits(state, loop.state, "segment 1 RESTART read back")
                check(t_end == loop.time, f"segment 1 RESTART time {t_end}")
            else:
                check(os.path.basename(segs[1])
                      == t_end.strftime("%Y%m%d.%H%M%S"),
                      f"segment 2 is {segs[1]}, not at {t_end}")
                same_bits(model_state_of(rec.chunks[0][1]), state,
                          "segment 2's first chunk from segment 1's RESTART")
            loops.append(loop)
            del rec
        check(len(scalar_lines) == 2 * SEGMENT_CHUNKS,
              f"{len(scalar_lines)} scalar log lines")
        log(f"  scalar log: {len(scalar_lines)} lines, e.g. "
            f"{scalar_lines[-1][:160]}...")
        long_cfg = get_config(segment_config(tmp, 2 * SEGMENT_CHUNKS))
        t0 = time.perf_counter()
        long = api.run_segment(long_cfg, os.path.join(tmp, "long"))
        log_segment(f"one segment of {2 * SEGMENT_CHUNKS} chunks",
                    long.phase_report, 2 * SEGMENT_CHUNKS,
                    time.perf_counter() - t0)
        same_bits(loops[1].state, long.state,
                  f"2 x {SEGMENT_CHUNKS} chunks against 1 x "
                  f"{2 * SEGMENT_CHUNKS}")
        del long, loops

        # the loop adds nothing to the chunk; its first chunk profiled
        loop = TimeLoop(get_config(segment_config(tmp, 1)))
        dycore, surface, cosz, prescribed = loop.chunk_inputs(CHUNK)
        surface = dict(surface, **{names.TOTAL_PRECIP: torch.zeros_like(
            surface[names.TSFC])})
        direct = loop.build_production_chunk(CHUNK)(dycore, surface, cosz,
                                                    prescribed)
        it = iter(loop)
        reading = profile_chunk("segmented-run", lambda: next(it))
        log("  segmented-run profiled chunk (the loop's, boundary "
            f"diagnostics in): wall {reading['wall_ms']:.1f} ms, device busy "
            f"{reading['device_ms']:.1f} ms, idle share "
            f"{100 * (1 - reading['device_ms'] / reading['wall_ms']):.1f}%; "
            "range device busy " + ", ".join(
                f"{r} {v:.1f} ms" for r, v in reading["ranges"].items()))
        same_bits(loop.state, model_state_of((direct[0], direct[1])),
                  "the loop's first chunk against the chunk called directly")
        del loop, direct, it

        # float64, 1 chunk of 2 steps (radiation at step 0), kernels
        # against plain through the loop
        cfg64 = dict(segment_config(tmp, 1), fused_chunk_steps=2,
                     duration_seconds=2 * DT, radiation_interval_steps=2,
                     diagnostics=[], fortran_diagnostics=[])
        loop_kernels_vs_plain("float64 loop chunk", cfg64,
                              production_launches(2, 1))
    finally:
        stats.removeHandler(handler)
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  segmented run: launches in the {2 * SEGMENT_CHUNKS} chunks of "
        f"the appended segments {total}")
    return total


def model_state_of(args):
    """The ModelState of a chunk's (dycore, surface, ...) arguments or
    output."""
    from fv3net_torch.runtime.derived_state import ModelState

    return ModelState(dycore=args[0], surface=dict(args[1]))


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


# ---------------------------------------------------------------- phase 6b
# each K4 and K3 call of phase 6's float32 radiation call, the kernel
# against the plain version on the same float32 inputs, value by value
# within the two versions' own float32 summation roundoff: each rounding
# (K4: the plain version's K products and K-1 sums and the kernel's K
# fused multiply-adds; K3: per path and stencil position 2 kw + 1 and
# kw + 1 of them) errs by at most half an ulp (RAD_SUM_ULPS) of the sum
# of the terms' magnitudes.  The bfloat16-table control (the plain
# version on tables rounded to bfloat16) must part by at least
# RAD_SUM_FAULT_RATIO times what the kernel does on every call
RAD_SUM_ULPS = 0.5
RAD_SUM_FAULT_RATIO = 10.0


def phase_radiation_summation(rec):
    """K4 and K3 against their plain versions on every recorded call of
    one radiation call (float32, or float64 for the GFS chain), each value
    within the summation roundoff of its terms in its dtype (see
    RAD_SUM_ULPS), beside the bfloat16-table control; returns (the
    largest kernel reading in units of its bound, the least
    control-to-kernel ratio)."""
    import torch
    from fv3net_torch.ops import ktable

    worst, margin, bad = 0.0, math.inf, []
    dtype_name = "float32"

    def rounded(tab):
        return tab.to(torch.bfloat16).to(tab.dtype)

    def absolute(pairs):
        return [(i, None if w is None else w.abs()) for i, w in pairs]

    for name, calls in (("weighted_select_dot", rec.select),
                        ("spec_band_dot", rec.spec)):
        for i, (a, out) in enumerate(calls):
            if name == "weighted_select_dot":
                terms, tab = a
                want = ktable.weighted_select_dot_plain(terms, tab)
                control = ktable.weighted_select_dot_plain(terms,
                                                           rounded(tab))
                mag = ktable.weighted_select_dot_plain(absolute(terms),
                                                       tab.abs())
                n_round = 3 * len(terms) - 1
            else:
                w_paths, s_paths, tab, nspa = a
                want = ktable.spec_band_dot_plain(w_paths, s_paths, tab, nspa)
                control = ktable.spec_band_dot_plain(w_paths, s_paths,
                                                     rounded(tab), nspa)
                mag = ktable.spec_band_dot_plain(
                    [absolute(p) for p in w_paths],
                    [absolute(p) for p in s_paths], tab.abs(), nspa)
                n_round = len(w_paths) * len(s_paths[0]) * (
                    3 * len(w_paths[0]) + 2)
            finfo = torch.finfo(out.dtype)
            dtype_name = str(out.dtype).replace("torch.", "")
            finite = torch.isfinite(want)
            d_k = torch.where(finite, (out - want).abs(), 0.0)
            d_c = torch.where(finite, (control - want).abs(), 0.0)
            allowed = RAD_SUM_ULPS * n_round * finfo.eps * torch.where(
                finite, mag, 0.0)
            reading = (d_k / allowed.clamp(min=finfo.tiny)).max().item()
            ratio = (d_c.max() / d_k.max()).item() if d_k.max() > 0 \
                else math.inf
            worst, margin = max(worst, reading), min(margin, ratio)
            if not reading <= 1.0:
                bad.append(f"{name} call {i}: {reading:.3g} x its bound")
            if not ratio >= RAD_SUM_FAULT_RATIO:
                bad.append(f"{name} call {i}: bfloat16-table control "
                           f"{ratio:.3g} x the kernel's")
        log(f"  {name}: {len(calls)} {dtype_name} calls, each value of "
            f"the kernel within its summation roundoff of plain")
    log(f"  {dtype_name} radiation call, K4/K3 against plain value by value: "
        f"at most {worst:.3g} of the summation-roundoff bound; the "
        f"bfloat16-table control parts by at least {margin:.3g} times the "
        f"kernels' reading on every call (needed {RAD_SUM_FAULT_RATIO})")
    check(not bad, f"K4/K3 against plain beyond their summation roundoff: "
          f"{bad[:8]}")
    return worst, margin


def driver_inputs(rad_args, lat):
    """RRTMGDriver's state dict from ``radiation_inputs``'s tuple."""
    import torch

    T, delp, q, qc, sst = rad_args[:5]
    return {"air_temperature": T,
            "pressure_thickness_of_atmospheric_layer": delp,
            "specific_humidity": q, "cloud_water_mixing_ratio": qc,
            "surface_temperature": sst, "latitude": lat,
            "longitude": torch.zeros_like(lat)}


# ---------------------------------------------------------------- phase 16
# the reference's radiation settings on its accelerator: bf16 storage and
# SW daylight compression (fv3net_tpu rrtmg lw.py _sdt, sw.py
# _compress_daylight_default)
BF16_OPTIONS = {"storage_dtype": "bfloat16", "compress_daylight": True}
# the default and the bf16 chunks in turns (each one's first is its
# warm-up, then 5 timed)
OPTIONS_SCHEDULE = ("default", "bf16", "bf16", "default", "default", "bf16",
                    "bf16", "default", "default", "bf16", "bf16", "default")
# K4 per radiation call under bf16 storage, by instance: the LW Planck
# fractions (12 calls) and 1-D minors (1) and the SW band 24 Rayleigh lerp
# (1) take their two rows alone, as the reference (lw.py _lerp_taken): 14
# more; the solar source's 7 lerps read float32 tables (the reference's
# are exact gathers)
SOLAR_SOURCE_LERPS = 7
SELECT_BF16_PER_CALL = SELECT_PER_CALL + 14 - SOLAR_SOURCE_LERPS
# K3 per radiation call under bf16 storage: a call a path (LW: 2 paths a
# band, 9 lower and 3 upper bands; SW: 1 path, 8 + 3 bands)
SPEC_BF16_PER_CALL = 2 * (9 + 3) + (8 + 3)
# the reference's bounds of bf16 storage against float32 storage
# (tests/test_rrtmg.py, the max over its 8 test columns, which the CPU
# test holds the port to on those columns): fluxes W/m2, heating K/day.
# Here they bound the root mean square over the C48 values: the largest
# difference of 13,824 columns runs past them (a bfloat16 Planck or
# solar source errs by up to 2^-9 of 460 or 1000 W/m2 at the surface,
# and the thin top layers turn a flux error into heating), as the
# reference's own bf16 storage does (1.02 W/m2 against its float32 on
# 20 of the CPU test's columns); the max is logged
BF16_FLUX_W_M2, BF16_HEATING_K_DAY = 1.0, 0.5
# the lookup tables against the direct exponentials: the reference's
# quantization bounds (tests/test_rrtmg_oracle.py), (rtol, atol W/m2)
LUT_TOL = {"longwave": (5e-4, 0.2), "shortwave": (1e-3, 0.5)}
# blocked against unblocked: the reference's bounds (tests/test_rrtmg.py):
# fluxes W/m2, heating K/s
COLUMN_BLOCK = 16384
BLOCK_FLUX_W_M2, BLOCK_HEATING_K_S = 0.01, 1e-6
# the cubes of the blocking cases: C96 blocked and unblocked, C192
# blocked only (an unblocked C192 call's planes outgrow the card)
BLOCKED_CUBES = (96, 192)
# columns of the call with the reference's options together in blocks
# of 8
SMALL_COLUMNS = 60
# compression on against off: the solved columns' arithmetic is their
# own, but a sum over the g-points of [C, G] planes may take its terms in
# another order at another C; a flux may part by COMPRESS_FLUX_W_M2 (8
# float32 ulps of 1361 W/m2) and a heating rate by what two such fluxes
# make over the thinnest layer
COMPRESS_FLUX_W_M2 = 8 * 1.2e-7 * 1361.0


def options_path(device, label, rrtmg_options):
    """The RRTMG flagship chunk with ``rrtmg_options``, expecting its
    launches by kernel and by instance."""
    import torch
    from fv3net_torch import entry

    step, (state, ml_params, sst, cosz) = entry.flagship(
        npx=NPX, npz=NPZ, chunk=CHUNK, device=device,
        rrtmg_options=rrtmg_options)
    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    calls = RADIATION_CALLS_PER_CHUNK
    if rrtmg_options:
        sel = {"bf16": calls * SELECT_BF16_PER_CALL,
               "f32": calls * SOLAR_SOURCE_LERPS}
        spec = {"bf16": calls * SPEC_BF16_PER_CALL}
    else:
        sel = {"f32": calls * SELECT_PER_CALL}
        spec = {"f32": calls * SPEC_PER_CALL}
    per_chunk = launches(remap_apply=CHUNK * REMAPS_PER_STEP,
                         weighted_select_dot=sum(sel.values()),
                         spec_band_dot=sum(spec.values()))
    path = Path(label, step, state, (ml_params, sst, cosz), area, per_chunk)
    path.per_instance = instance_counts(sel, spec)
    return path


def instance_counts(sel=None, spec=None, taumol=None):
    out = {}
    for kernel, by in (("weighted_select_dot", sel or {}),
                       ("spec_band_dot", spec or {}),
                       ("taumol_lw", taumol or {})):
        for sfx in ("f32", "f64", "bf16"):
            out[f"{kernel}_{sfx}"] = by.get(sfx, 0)
    return out


def read_instance_counts():
    from fv3net_torch.ops import ktable_cuda
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda

    return instance_counts(ktable_cuda.SELECT_BY_DTYPE,
                           ktable_cuda.SPEC_BY_DTYPE,
                           taumol_cuda.LAUNCHES_BY_INSTANCE)


def rrtmg_drivers(device, **options):
    """RRTMGDriver of the flagship's radiation config with ``options``."""
    from fv3net_torch.physics import PhysicsConfig
    from fv3net_torch.physics.radiation.rrtmg.driver import (
        RRTMGConfig,
        RRTMGDriver,
    )

    return RRTMGDriver(RRTMGConfig(
        solcon=1368.22 * PhysicsConfig().solcon_scale, **options),
        device=device)


def output_diffs(a, b, rms=False):
    """{key: max |a - b|} over the driver's heating rates (K/day) and
    fluxes (W/m2); ``rms``: the root mean square over the values
    instead."""
    out = {}
    for key in sorted(a):
        d = a[key].double() - b[key].double()
        d = (d.square().mean().sqrt() if rms else d.abs().max()).item()
        if "_flux_" in key:
            out[key] = d
        elif "heating" in key or "tendency" in key:
            out[key] = 86400.0 * d
    return out


def columns_inputs(device, npx, seed=7):
    """Radiation-driver inputs on a C``npx`` cube at NPZ levels: the
    flagship's resting moist start, seeded clouds in a fifth of the
    layers, the aquaplanet SST and cosz = cos(lat) cos(lon)."""
    import numpy as np
    import torch
    from fv3net_torch.dycore.state import init_state
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.runtime.fused import aquaplanet_sst

    grid = make_grid(npx)
    state, _, _ = init_state(grid, NPZ, dtype=torch.float32, device=device,
                             perturbation=2.0)
    lat = torch.tensor(grid.lat, dtype=torch.float32, device=device)
    cosz = torch.tensor(np.cos(grid.lat) * np.cos(grid.lon),
                        dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = state.delp.shape
    qc = 1e-4 * torch.rand(shape, generator=gen, device=device) * (
        torch.rand(shape, generator=gen, device=device) > 0.8)
    state.tracers["cloud_water"] = qc
    sst = aquaplanet_sst(lat)
    args = radiation_inputs(state, sst, cosz, lat)
    return driver_inputs(args, lat), cosz


def memory_call(label, driver, inputs, cosz):
    """One driver call from a reset peak: (outputs, seconds, peak bytes)."""
    import datetime

    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = driver(datetime.datetime(2016, 7, 1), inputs, cosz=cosz)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for key, x in out.items():
        check(torch.isfinite(x).all().item(), f"{label}: non-finite {key}")
    log(f"  {label}: {dt * 1e3:.1f} ms, peak memory {peak / 2**30:.2f} GiB "
        f"({(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} "
        "GiB held before the call)")
    return out, dt, peak


def phase_rrtmg_options(device, state6, sst, cosz):
    """The reference's accelerator radiation settings and the other RRTMG
    options: the flagship chunk with bf16 storage and daylight compression
    in turns with the default chunk; K4 and K3 in bfloat16 against their
    plain versions on every call of one bf16 radiation call on phase 6's
    state; that call against float32 storage; compression on against off;
    the lookup tables against the direct exponentials; a C96 call blocked
    against unblocked and a C192 call blocked, with their peak memory.
    Returns the two bf16 kernel lines and the readings."""
    import datetime

    import torch
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.physics import PhysicsConfig
    from fv3net_torch.physics.radiation.rrtmg import params as P
    from fv3net_torch.runtime import fused

    readings = {}
    paths = {"default": options_path(device, "rrtmg-f32", None),
             "bf16": options_path(device, "rrtmg-bf16", BF16_OPTIONS)}
    for name in OPTIONS_SCHEDULE:
        paths[name].chunk()
    for name, path in paths.items():
        ms = path.summary()
        readings[name] = {"ms": ms,
                          "sypd": (CHUNK * DT / (ms / 1e3)) / 365.0,
                          "instances": path.instance_totals}
        log(f"  {path.label}: launches by instance in {path.chunks} chunks "
            f"{path.instance_totals}")
        prof = profile_chunk(path.label, lambda p=path: p.step(p.state,
                                                               *p.args))
        readings[name]["profile"] = prof
        log(f"  {path.label} profiled chunk: device busy "
            f"{prof['device_ms']:.1f} ms of {prof['wall_ms']:.1f} ms wall "
            f"({100 * (1 - prof['device_ms'] / prof['wall_ms']):.1f}% idle);"
            f" radiation range {prof['ranges'].get('radiation', 0.0):.1f} ms")
    bf16_launches = {
        k: paths["bf16"].instance_totals[f"{k}_bf16"]
        for k in ("weighted_select_dot", "spec_band_dot")}
    del paths

    # one bf16 radiation call on phase 6's state: every K4/K3 call against
    # its plain bf16 version, bit for bit
    lat = torch.tensor(make_grid(NPX).lat, dtype=torch.float32,
                       device=device)
    rad_bf16 = fused._build_radiation_fn(
        PhysicsConfig(radiation_scheme="rrtmg"), device, torch.float32,
        rrtmg_options=BF16_OPTIONS)
    args = radiation_inputs(state6, sst, cosz, lat)
    reset_counts()
    with Recorder() as rec:
        rad_bf16(*args)
    torch.cuda.synchronize()
    inst = read_instance_counts()
    check(inst == instance_counts(
        {"bf16": SELECT_BF16_PER_CALL, "f32": SOLAR_SOURCE_LERPS},
        {"bf16": SPEC_BF16_PER_CALL}),
        f"one bf16 radiation call: launches by instance {inst}")
    lines = phase_ktable_bf16(rec)

    # the bf16 call against the float32 call; compression; lookup tables
    inputs = driver_inputs(args, lat)
    when = datetime.datetime(2016, 7, 1)
    f32 = rrtmg_drivers(device)
    base = f32(when, inputs, cosz=cosz)
    dmin_mb = args[1].min().item() / 100.0
    checks = (
        ("bf16 storage against float32 storage",
         dict(storage_dtype="bfloat16"), True,
         lambda key: BF16_FLUX_W_M2 if "_flux_" in key
         else BF16_HEATING_K_DAY),
        ("compression on against off", dict(compress_daylight=True), False,
         lambda key: COMPRESS_FLUX_W_M2 if "_flux_" in key else
         86400.0 * 2 * COMPRESS_FLUX_W_M2 * P.HEATFAC / dmin_mb),
    )
    for label, options, rms, limit in checks:
        other = rrtmg_drivers(device, **options)(when, inputs, cosz=cosz)
        d = output_diffs(other, base, rms=rms)
        d_max = output_diffs(other, base)
        readings[label] = {"gated": d, "max": d_max}
        worst = {k: v for k, v in d.items() if not v <= limit(k)}
        for key, v in d.items():
            what = "rms" if rms else "max"
            log(f"  {label}: {key} {what} {v:.3e} (bound {limit(key):.3e})"
                + (f", max {d_max[key]:.3e}" if rms else ""))
        check(not worst, f"{label}: beyond the bound {worst}")
    tables = rrtmg_drivers(device, fast_exp=False)(when, inputs, cosz=cosz)
    bad = []
    for key in sorted(base):
        if "_flux_" not in key:
            continue
        rtol, atol = LUT_TOL["longwave" if "longwave" in key
                             else "shortwave"]
        err = (tables[key].double() - base[key].double()).abs()
        excess = (err - (atol + rtol * base[key].double().abs())).max()
        log(f"  lookup tables against direct exponentials: {key} "
            f"{err.max().item():.3e} W/m2 (rtol {rtol}, atol {atol})")
        if excess.item() > 0:
            bad.append(key)
    check(not bad, f"lookup tables beyond the reference's quantization "
          f"bounds: {bad}")
    # the reference's options together, on the first SMALL_COLUMNS columns
    # in blocks of 8 (a ragged last block), against the same call
    # unblocked
    def first(x):  # the first SMALL_COLUMNS of the [6, 48, 48] columns
        return x.flatten(0, 2)[:SMALL_COLUMNS]

    few = {k: first(v) for k, v in inputs.items()}
    options = dict(fast_exp=False, storage_dtype="bfloat16")
    d = output_diffs(
        rrtmg_drivers(device, column_block=8, **options)(
            when, few, cosz=first(cosz)),
        rrtmg_drivers(device, **options)(when, few, cosz=first(cosz)))
    bad = {k: v for k, v in d.items()
           if not v <= (BLOCK_FLUX_W_M2 if "_flux_" in k
                        else 86400.0 * BLOCK_HEATING_K_S)}
    log(f"  RRTMGConfig(fast_exp=False, column_block=8, storage_dtype="
        f"'bfloat16') on {SMALL_COLUMNS} columns against unblocked: max "
        f"{max(d.values()):.3e}")
    check(not bad, f"the options together, blocked against unblocked: {bad}")
    del base, tables, rec, rad_bf16, f32

    # column blocking at C96 and C192, from the memory the earlier phases
    # released
    gc.collect()
    torch.cuda.empty_cache()
    c96, c192 = BLOCKED_CUBES
    inputs96, cosz96 = columns_inputs(device, c96)
    whole, t_whole, m_whole = memory_call(
        f"C{c96} call unblocked ({6 * c96 * c96} columns)",
        rrtmg_drivers(device), inputs96, cosz96)
    blocked, t_blk, m_blk = memory_call(
        f"C{c96} call in {COLUMN_BLOCK}-column blocks",
        rrtmg_drivers(device, column_block=COLUMN_BLOCK), inputs96, cosz96)
    d = output_diffs(blocked, whole)
    bad = {k: v for k, v in d.items()
           if not v <= (BLOCK_FLUX_W_M2 if "_flux_" in k
                        else 86400.0 * BLOCK_HEATING_K_S)}
    log(f"  C{c96} blocked against unblocked: " + ", ".join(
        f"{k} {v:.3e}" for k, v in d.items()))
    check(not bad, f"C{c96} blocked against unblocked: {bad}")
    readings["C96"] = {"unblocked_s": t_whole, "unblocked_peak": m_whole,
                       "blocked_s": t_blk, "blocked_peak": m_blk,
                       "max_diff": d}
    del whole, blocked, inputs96, cosz96
    inputs192, cosz192 = columns_inputs(device, c192)
    out192, t192, m192 = memory_call(
        f"C{c192} call in {COLUMN_BLOCK}-column blocks "
        f"({6 * c192 * c192} columns)",
        rrtmg_drivers(device, column_block=COLUMN_BLOCK), inputs192,
        cosz192)
    readings["C192"] = {"blocked_s": t192, "blocked_peak": m192}
    del out192, inputs192, cosz192
    torch.cuda.empty_cache()
    return lines, bf16_launches, readings


def phase_ktable_bf16(rec, reps=20):
    """K4's and K3's bfloat16 instances against their plain versions on
    every recorded bf16 call of one radiation call, bit for bit; all of
    them timed together (the path), and the largest call of each timed
    against its plain version and ``embedding_bag`` on the same bf16
    inputs.  Returns the two kernel lines."""
    import torch
    from fv3net_torch.ops import ktable_cuda

    lines = {}
    for name, calls, plain, cost, kernel, tab_of, pick in (
            ("weighted_select_dot", rec.select, _select_plain, _select_cost,
             ktable_cuda.weighted_select_dot_cuda, lambda a: a[1],
             lambda a: tuple(a[1].shape) == (70, 54)),
            ("spec_band_dot", rec.spec, _spec_plain, _spec_cost,
             ktable_cuda.spec_band_dot_cuda, lambda a: a[2],
             lambda a: tuple(a[2].shape) == (70, 9 * 16))):
        mine = [(a, out) for a, out in calls
                if tab_of(a).dtype == torch.bfloat16]
        check(mine, f"{name}: no bfloat16 call recorded")
        path_bound, worst = 0.0, 0.0
        for i, (a, out) in enumerate(mine):
            want = plain(*a)
            check(out.dtype == want.dtype, f"{name} bf16 call {i}: dtype "
                  f"{out.dtype}, plain {want.dtype}")
            err, scale = max_diff(out.float(), want.float(),
                                  f"{name} bf16 call {i}")
            finite = torch.isfinite(want)
            check(torch.equal(torch.where(finite, out, 0),
                              torch.where(finite, want, 0)),
                  f"{name} bf16 call {i} (tab {tuple(tab_of(a).shape)}): "
                  f"kernel and plain differ, max {err} (scale {scale})")
            worst = max(worst, err)
            moved, flops = cost(*a, out) if len(a) == 2 else cost(a, out)
            path_bound += bound(moved, flops, "float32")[0]

        def run_path(mine=mine, kernel=kernel):
            for a, _ in mine:
                kernel(*a)

        path_ms = device_ms({"path": run_path}, 4, warmup=1)["path"]
        a = next(a for a, _ in mine if pick(a))
        lib = (_embedding_bag_select(*a) if len(a) == 2
               else _embedding_bag_spec(*a))
        got = kernel(*a)
        lib_err = max_diff(lib().float(), got.float(),
                           f"embedding_bag bf16 {name}")[0]
        ms = device_ms({"plain": lambda: plain(*a),
                        "kernel": lambda: kernel(*a), "library": lib}, reps)
        moved, flops = cost(*a, got) if len(a) == 2 else cost(a, got)
        bound_ms, by = bound(moved, flops, "float32")
        log(f"  {name} bfloat16: {len(mine)} calls of one bf16 radiation "
            f"call equal to plain bit for bit; all of them {path_ms:.4f} ms "
            f"of device time against a bound of {path_bound:.4f} ms; on "
            f"{tuple(tab_of(a).shape)}: kernel {ms['kernel']:.4f} ms, plain "
            f"{ms['plain']:.4f} ms, embedding_bag {ms['library']:.4f} ms "
            f"(max|diff| {lib_err:.3e}); {moved} bytes moved (2 B a bfloat16"
            f" value), {flops} flops, bound {bound_ms:.4f} ms ({by}, "
            f"{100 * bound_ms / ms['kernel']:.1f}% of it)")
        lines[name] = {"max_abs_err": worst, "ms": ms["kernel"],
                       "plain_ms": ms["plain"], "bound_ms": bound_ms,
                       "bound_by": by, "library_ms": ms["library"],
                       "path_ms": path_ms, "path_bound_ms": path_bound}
    return lines


# ---------------------------------------------------------------- phase 17
# JW06 at C48 through the dycore options: the reference's DycoreConfig()
# (advection order 2), order 1, and PPM with kord 7 (ppm_profile into K1)
DYCORE_OPTIONS = {"DycoreConfig()": {}, "order 1": {"advection_order": 1},
                  "order 4, kord 7": {"advection_order": 4, "kord": 7}}
DYCORE_STEPS = 8
DYCORE_F64_RTOL = 1e-10  # one float64 step, kernels against plain


def phase_dycore_options(device, reps=10):
    """The JW06 baroclinic wave (dycore/testcases.py) at C48 through 8
    steps of each of DYCORE_OPTIONS (finite, air-mass drift, exact K1
    launches, ms), one float64 step of each with the kernels against the
    plain versions, and K1 against plain on ppm_profile's profiles at
    kord 4-7 and on the iv=-2 profile with a surface value.  Returns the
    ms per 8 steps by option."""
    import torch
    from fv3net_torch.dycore import testcases
    from fv3net_torch.dycore.core import (
        DycoreConfig,
        GridArrays,
        dynamics_step,
    )
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.ops import remap as rm
    from fv3net_torch.ops import remap_cuda

    grid = make_grid(NPX)
    out = {}
    for dtype in (torch.float32, torch.float64):
        g = GridArrays.from_grid(grid, dtype=dtype, device=device)
        state0, ak, bk = testcases.baroclinic_wave_state(
            grid, NPZ, dtype=dtype, device=device)
        ak = torch.tensor(ak, dtype=dtype, device=device)
        bk = torch.tensor(bk, dtype=dtype, device=device)
        area = torch.tensor(grid.area, device=device)
        for label, kw in DYCORE_OPTIONS.items():
            cfg = DycoreConfig(**kw)
            if dtype == torch.float64:
                got = dynamics_step(state0, g, ak, bk, cfg)
                want = dynamics_step(state0, g, ak, bk, cfg, impl="torch")
                torch.cuda.synchronize()
                bad = _diffs(got, want, f"JW06 {label} float64 step",
                             DYCORE_F64_RTOL)
                check(not bad, f"JW06 {label}: kernels against plain {bad}")
                continue
            state = state0
            m0 = air_mass(state, area)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DYCORE_STEPS):
                state = dynamics_step(state, g, ak, bk, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            check(counts == launches(
                remap_apply=DYCORE_STEPS * REMAPS_PER_STEP),
                f"JW06 {label}: launches {counts}")
            for name, x in fields(state).items():
                check(torch.isfinite(x).all().item(),
                      f"JW06 {label}: non-finite {name}")
            drift = abs(air_mass(state, area) - m0) / m0
            check(drift <= 1e-5, f"JW06 {label}: air-mass drift {drift}")
            wind = state.wind.abs().max().item()
            log(f"  JW06 {label}: {DYCORE_STEPS} steps in {ms:.1f} ms "
                f"(the first call in), air-mass drift {drift:.3e}, max "
                f"|wind| {wind:.2f} m/s, launches {counts}")
            out[label] = {"ms": ms, "drift": drift}

    # K1 on the kord <= 7 profiles and the iv=-2 one
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        search, q = remap_inputs(device, dtype, 3)[:2]
        rtol = F32_RTOL if dtype == torch.float32 else F64_RTOL
        cases = [(f"ppm_profile kord {k}", rm.ppm_profile(
            q, search["dp1"], 1, k)) for k in (4, 5, 6, 7)]
        w = q - q.mean()
        qs = w[..., -1] * 0.5
        cases.append(("cs_profile iv=-2 with qs", (w,) + rm.cs_profile(
            w, search["dp1"], -2, 9, qs=qs)))
        for label, prof in cases:
            field = prof[0] if len(prof) == 4 else q
            al, ar, a6 = prof[-3:]
            a = (search, field.contiguous(), al.contiguous(),
                 ar.contiguous(), a6.contiguous())
            before = remap_cuda.LAUNCHES
            got = remap_cuda.remap_apply_cuda(*a)
            torch.cuda.synchronize()
            check(remap_cuda.LAUNCHES == before + 1, f"K1 {label}: no launch")
            want = rm.remap_apply_plain(*a)
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            log(f"  K1 on {label} ({name}): max|kernel-plain| {err:.3e} "
                f"(scale {scale:.3e}, rtol {rtol})")
            check(err <= rtol * scale, f"K1 on {label} {name}: {err} > "
                  f"{rtol} * {scale}")
    return out


# ---------------------------------------------------------------- phase 18
# K2's bfloat16 instance against its plain version: bit for bit, except
# where a float32 operation the card takes its own way (the pow of the
# gas-amount adjustments) moves a sum across a bfloat16 rounding tie: then
# by one bfloat16 ulp at most
K2_BF16_ULPS = 1
# the mega and the ktable route under BF16_OPTIONS in turns (each one's
# first is its warm-up, then 3 timed)
MEGA_BF16_SCHEDULE = ("ktable", "mega", "mega", "ktable", "ktable", "mega",
                      "mega", "ktable")
# K4 calls of the LW gas optics under bf16 storage (its 27 of float32, the
# 13 lerps of two rows taken alone: 12 Planck fractions, the 1-D minors)
# and K3 calls (2 paths a band, 9 lower and 3 upper bands): K2 takes them
TAUMOL_SELECT_BF16 = 27 + 13
TAUMOL_SPEC_BF16 = 2 * (9 + 3)


def mega_bf16_path(device):
    """The flagship chunk with BF16_OPTIONS on the mega route: K2's
    bfloat16 instance once a radiation call."""
    import torch
    from fv3net_torch import entry

    step, (state, ml_params, sst, cosz) = entry.flagship(
        npx=NPX, npz=NPZ, chunk=CHUNK, device=device, lw_taumol="mega",
        rrtmg_options=BF16_OPTIONS)
    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    calls = RADIATION_CALLS_PER_CHUNK
    sel = {"bf16": calls * (SELECT_BF16_PER_CALL - TAUMOL_SELECT_BF16),
           "f32": calls * SOLAR_SOURCE_LERPS}
    spec = {"bf16": calls * (SPEC_BF16_PER_CALL - TAUMOL_SPEC_BF16)}
    per_chunk = launches(remap_apply=CHUNK * REMAPS_PER_STEP,
                         weighted_select_dot=sum(sel.values()),
                         spec_band_dot=sum(spec.values()),
                         taumol_lw=calls)
    path = Path("rrtmg-mega-bf16", step, state, (ml_params, sst, cosz),
                area, per_chunk)
    path.per_instance = instance_counts(sel, spec, {"bf16": calls})
    return path


def bf16_ulps(got, want):
    """Per value, the bfloat16 ulps between two bfloat16 tensors of the
    same sign (their bit patterns as integers)."""
    import torch

    return (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()


def phase_taumol_bf16(device, state6, sst, cosz, ktable_profile, reps=2):
    """K2 under the reference's accelerator radiation settings: the mega
    route's bf16 chunk in turns with the ktable route's (launches by
    instance, ms per chunk, SYPD; one profiled chunk of the mega route:
    device busy, the radiation range, idle share, beside phase 16's
    profiled chunk of the ktable route, ``ktable_profile``, the same
    configuration in the same call); then K2's bfloat16 instance against
    its plain version on the arguments of one bf16 radiation call on phase
    6's state, value by value, timed beside the plain version, the
    ktable route's bf16 gas optics and its bound.  Returns its kernel line
    and its launches on the mega route's chunks."""
    import torch
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.physics import PhysicsConfig
    from fv3net_torch.physics.radiation.rrtmg import lw as rlw
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda
    from fv3net_torch.runtime import fused

    paths = {"ktable": options_path(device, "rrtmg-bf16", BF16_OPTIONS),
             "mega": mega_bf16_path(device)}
    for name in MEGA_BF16_SCHEDULE:
        paths[name].chunk()
    for name, path in paths.items():
        ms = path.summary()
        log(f"  {path.label}: launches by instance in {path.chunks} chunks "
            f"{path.instance_totals}")
        prof = (ktable_profile if name == "ktable" else profile_chunk(
            path.label, lambda p=path: p.step(p.state, *p.args)))
        log(f"  {path.label} profiled chunk"
            f"{' (phase 16)' if name == 'ktable' else ''}: wall "
            f"{prof['wall_ms']:.1f} ms, "
            f"device busy {prof['device_ms']:.1f} ms "
            f"({100 * (1 - prof['device_ms'] / prof['wall_ms']):.1f}% idle),"
            f" {prof['activities']} device activities; radiation range "
            f"{prof['ranges'].get('radiation', 0.0):.1f} ms; median chunk "
            f"{ms:.1f} ms")
    mega_launches = paths["mega"].instance_totals["taumol_lw_bf16"]
    del paths

    # K2's bf16 call of one radiation call on phase 6's state
    lat = torch.tensor(make_grid(NPX).lat, dtype=torch.float32,
                       device=device)
    rad = fused._build_radiation_fn(
        PhysicsConfig(radiation_scheme="rrtmg"), device, torch.float32,
        lw_taumol="mega", rrtmg_options=BF16_OPTIONS)
    seen = []
    orig = taumol_cuda.taumol_lw_cuda

    def captured(*a):
        out = orig(*a)
        seen.append((a, out))
        return out

    taumol_cuda.taumol_lw_cuda = captured
    try:
        rad(*radiation_inputs(state6, sst, cosz, lat))
    finally:
        taumol_cuda.taumol_lw_cuda = orig
    torch.cuda.synchronize()
    check(len(seen) == 1, f"one bf16 radiation call made {len(seen)} K2 "
          "calls")
    args, got = seen[0]
    check(args[7] == torch.bfloat16, f"K2 storage {args[7]}")
    want = rlw.taumol_lw_plain(*args[:7], storage=torch.bfloat16)
    errs = {}
    for name, g, w in zip(("fracs", "tautot"), got, want):
        check(g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape,
              f"K2 bf16 {name}: {g.dtype} {tuple(g.shape)} against plain "
              f"{w.dtype} {tuple(w.shape)}")
        finite = torch.isfinite(w.float())
        check(torch.equal(finite, torch.isfinite(g.float())),
              f"K2 bf16 {name}: non-finite at other points than plain")
        ulps = torch.where(finite, bf16_ulps(g, w), 0)
        share = (ulps > 0).float().mean().item()
        worst = ulps.max().item()
        err = (g.float() - w.float()).nan_to_num().abs().max().item()
        errs[name] = err
        log(f"  K2 bf16 {name}: {share:.3e} of the values differ from plain,"
            f" by at most {worst} bfloat16 ulp (max|diff| {err:.3e})")
        check(worst <= K2_BF16_ULPS, f"K2 bf16 {name}: {worst} ulps from "
              f"plain > {K2_BF16_ULPS}")
    c, colamt, coldry, colbrd, wx, tauaer, T = args[:7]
    flat, meta, _ = taumol_cuda.pack_tables(T)
    flat_bf16 = taumol_cuda.stored_flat(T)
    planes, keep = taumol_cuda.pack_planes(c, colamt, coldry, colbrd, wx,
                                           tauaer, flat)
    lead = tuple(coldry.shape)
    N = math.prod(lead)
    dev = device_ms({
        "plain": lambda: rlw.taumol_lw_plain(*args[:7],
                                             storage=torch.bfloat16),
        "kernel": lambda: taumol_cuda.taumol_lw_cuda(*args),
        "launch": lambda keep=keep: taumol_cuda.taumol_lw_launch(
            planes, flat, meta, lead, flat_bf16),
        "ktable": lambda: rlw.taumol_lw(*args[:7], storage=torch.bfloat16),
    }, reps)
    # the point planes at their own widths (the aerosol taus bfloat16),
    # the tables read once in float32 and in bfloat16, both bfloat16
    # outputs written once (2 B a value); ~2,000 flops per point
    point_bytes = sum(nbytes(x) for x in (colamt, coldry, colbrd, wx,
                                          tauaer, c["rfrate"]))
    point_bytes += sum(nbytes(c[k]) for k in taumol_cuda.FLOAT_PLANES[:12])
    point_bytes += sum(nbytes(c[k]) for k in taumol_cuda.INT_PLANES)
    moved = point_bytes + nbytes(flat, flat_bf16, meta, *got)
    bound_ms, by = bound(moved, 2000 * N, "float32")
    log(f"  K2 bf16: N={N} points; device time wrapper {dev['kernel']:.3f} "
        f"ms, the launch alone {dev['launch']:.3f} ms, plain "
        f"{dev['plain']:.3f} ms, the ktable route's bf16 gas optics "
        f"{dev['ktable']:.3f} ms; {moved} bytes moved ({point_bytes} in the "
        f"point planes, {nbytes(flat, flat_bf16, meta)} in the tables, "
        f"{nbytes(*got)} out at 2 B a value), bound {bound_ms:.4f} ms ({by},"
        f" {100 * bound_ms / dev['kernel']:.1f}% of it); its path, the one "
        "call of a radiation call on the mega route: the same")
    line = {"max_abs_err": max(errs.values()), "ms": dev["kernel"],
            "plain_ms": dev["plain"], "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "path_ms": dev["kernel"],
            "path_bound_ms": bound_ms}
    return line, mega_launches


# ---------------------------------------------------------------- phase 19
# the FV3GFS-style C48 namelist (Fortran-shaped, lowered by
# runtime/config.py): the nonhydrostatic core at the smallest n_split the
# acoustic CFL check takes at C48 (2 raises), GFDL microphysics
# (imp_physics 11), prognostic ozone and stratospheric water, on the
# production configuration of phase 15
NAMELIST_N_SPLIT = 3
# K1 a step: the winds with w (one call), the tracers with o3mr and the
# four GFDL species (one call), the total energy and delz as specific
# volume
NAMELIST_REMAPS_PER_STEP = 4
# GFDL subcycles a physics call (the sedimentation runs in each)
GFDL_SUBCYCLES = 2


# the start: the JW06 jet (dycore/testcases.py; 288 K at the ground, a
# cold upper troposphere and its surface geopotential) moistened to
# NAMELIST_RH of saturation below 300 hPa, so that the GFDL scheme makes
# liquid and ice from the first step
NAMELIST_RH = 0.9


def namelist_initial_conditions(tmp):
    """A ``state.npz`` restart in ``tmp/ic`` (float64, made on the CPU)
    of the moist JW06 state over the aquaplanet SST."""
    import datetime

    import torch
    from fv3net_torch.dycore import testcases
    from fv3net_torch.dycore.state import (
        temperature_from_theta_v,
        theta_v_from_temperature,
    )
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.ops import thermo
    from fv3net_torch.runtime import checkpoint, names
    from fv3net_torch.runtime.derived_state import ModelState
    from fv3net_torch.runtime.fused import aquaplanet_sst

    path = os.path.join(tmp, "ic")
    if os.path.isdir(path):
        return path
    grid = make_grid(NPX)
    state, _, _ = testcases.baroclinic_wave_state(
        grid, NPZ, dtype=torch.float64, device="cpu")
    delp = state.delp.movedim(1, -1)
    pmid = thermo.pressure_at_midpoint_log(delp).movedim(-1, 1)
    T = temperature_from_theta_v(state.pt, pmid, state.tracers["sphum"])
    es = thermo.saturation_pressure(T)
    qsat = 0.622 * es / (pmid - 0.378 * es)
    q = torch.where(pmid > 3.0e4, NAMELIST_RH * qsat.clamp(max=0.02), 1e-6)
    state.tracers["sphum"] = q
    state.pt = theta_v_from_temperature(T, pmid, q)
    lat = torch.tensor(grid.lat, dtype=torch.float64)
    sst = aquaplanet_sst(lat)
    checkpoint.save_state(ModelState(dycore=state, surface={
        names.TSFC: sst, names.SST: sst.clone(),
        names.MASK: torch.zeros_like(sst)}),
        datetime.datetime(2016, 8, 1), path)
    return path


def namelist_config(tmp, chunks=SEGMENT_CHUNKS):
    """Phase 15's run config with the namelist's sections in place of its
    flat grid and radiation keys, from the moist JW06 start."""
    cfg = segment_config(tmp, chunks)
    cfg["initial_conditions"] = namelist_initial_conditions(tmp)
    flat = {k: v for k, v in cfg["namelist"].items()
            if k not in ("npx", "npz", "radiation")}
    cfg["namelist"] = dict(
        flat,
        fv_core_nml={"npx": NPX + 1, "npz": NPZ,
                     "n_split": NAMELIST_N_SPLIT, "hydrostatic": False},
        coupler_nml={"dt_atmos": DT},
        gfs_physics_nml={"imp_physics": 11, "fhswr": 4 * DT},
        prognostic_ozone=True,
        stratospheric_h2o=True,
    )
    return cfg


def device_activities(fn):
    """The device activities (kernels, copies) of one call of ``fn`` under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    return sum(e.count for e in events
               if getattr(e, key) > 0 and e.self_cpu_time_total == 0)


def phase_namelist_run(device):
    """The namelist's segmented run at C48: ``api.create`` and two
    ``api.append_segment`` calls of SEGMENT_CHUNKS chunks, each chunk's
    launches exact (K1 4 a step; K4 and K3 in every radiation call; no
    K2) with phase 12's gates, w and delz finite and delz > 0; the
    segments against one segment of twice the chunks, bit for bit; a
    fresh loop's first chunk profiled; the launches and device time the
    GFDL sedimentation loop and the batched tridiagonal solve add; one
    float64 chunk of 2 steps, kernels against plain."""
    import tempfile

    import torch
    from fv3net_torch import entry
    from fv3net_torch.dycore import nonhydro
    from fv3net_torch.physics import microphysics_gfdl
    from fv3net_torch.runtime import names, timing
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.segmented_run import api

    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    calls = RADIATION_CALLS_PER_CHUNK
    expected = launches(remap_apply=CHUNK * NAMELIST_REMAPS_PER_STEP,
                        weighted_select_dot=calls * SELECT_PER_CALL,
                        spec_band_dot=calls * SPEC_PER_CALL)
    log(f"  predicted launches a chunk: {expected}")
    total = launches()
    tmp = tempfile.mkdtemp(prefix="namelist_run_")
    try:
        url = os.path.join(tmp, "run")
        api.create(url, namelist_config(tmp))
        loops = []
        for s in (1, 2):
            with ChunkRecorder() as rec:
                t0 = time.perf_counter()
                seg = api.append_segment(url)
                seconds = time.perf_counter() - t0
            report = timing.phase_report()
            label = f"namelist segment {s}"
            loop = rec.loops[0]
            cfg = loop._dyn_cfg
            check(loop.fusable() and loop._production_features()
                  and not cfg.hydrostatic
                  and cfg.n_split == NAMELIST_N_SPLIT
                  and loop._phys_cfg.microphysics_scheme == "gfdl"
                  and loop._phys_cfg.stratospheric_h2o
                  and loop._phys_cfg.radiation_scheme == "rrtmg",
                  f"{label}: the namelist's production path was not taken")
            tracers = loop.state.dycore.tracers
            check({"o3mr", *microphysics_gfdl.GFDL_TRACER_NAMES}
                  <= set(tracers), f"{label}: tracers {sorted(tracers)}")
            check(len(rec.chunks) == SEGMENT_CHUNKS,
                  f"{label}: {len(rec.chunks)} chunks")
            counts = gate_segment(label, rec, area, expected)
            total = {k: v + counts[k] for k, v in total.items()}
            log_segment(label, report, SEGMENT_CHUNKS, seconds)
            gate_stores(label, seg, SEGMENT_CHUNKS)
            d = loop.state.dycore
            check(any(tracers[k].max().item() > 0 for k in
                      microphysics_gfdl.GFDL_TRACER_NAMES),
                  f"{label}: the GFDL scheme made no ice, rain, snow or "
                  "graupel")
            log(f"  {label}: |w| up to {d.w.abs().max().item():.3e} m/s, "
                f"delz {d.delz.min().item():.1f} .. "
                f"{d.delz.max().item():.1f} m, o3mr up to "
                f"{tracers['o3mr'].max().item():.3e}, "
                + ", ".join(f"{k} up to {tracers[k].max().item():.3e}"
                            for k in microphysics_gfdl.GFDL_TRACER_NAMES))
            loops.append(loop)
            del rec
        long = api.run_segment(
            get_config(namelist_config(tmp, 2 * SEGMENT_CHUNKS)),
            os.path.join(tmp, "long"))
        same_bits(loops[1].state, long.state,
                  f"namelist: 2 x {SEGMENT_CHUNKS} chunks against 1 x "
                  f"{2 * SEGMENT_CHUNKS}")
        del long, loops

        loop = TimeLoop(get_config(namelist_config(tmp, 1)))
        it = iter(loop)
        reading = profile_chunk("namelist", lambda: next(it))
        log("  namelist profiled chunk (the loop's): wall "
            f"{reading['wall_ms']:.1f} ms, device busy "
            f"{reading['device_ms']:.1f} ms, idle share "
            f"{100 * (1 - reading['device_ms'] / reading['wall_ms']):.1f}%, "
            f"{reading['activities']} device activities; range device busy "
            + ", ".join(f"{r} {v:.1f} ms"
                        for r, v in reading["ranges"].items()))

        # what the sedimentation loop and the tridiagonal solve add, at
        # the chunk's shapes
        d = loop.state.dycore
        zl = d.delp.movedim(1, -1)
        species = tuple(d.tracers[k].movedim(1, -1)
                        for k in microphysics_gfdl.GFDL_TRACER_NAMES)
        vts = tuple(torch.full_like(zl, v) for v in (0.5, 5.0, 1.0, 3.0))
        dz = 8.0 * zl / 100.0
        dt_sub = DT / NAMELIST_N_SPLIT
        a = torch.full_like(d.delp.movedim(1, 0), -0.1)
        calls = {
            "sedimentation": lambda: microphysics_gfdl._sediment(
                species, vts, dz, zl / 9.8, DT / GFDL_SUBCYCLES),
            "acoustic solve": lambda: nonhydro.vertical_solver(
                d.w, d.delz, d.delp, d.pt, dt_sub, loop._dyn_cfg.ptop),
            "dense solve": lambda: nonhydro._tridiag_solve(a, 1.0 - 2 * a,
                                                           a, a),
        }
        ms = device_ms(calls, 5)
        per_chunk = {"sedimentation": GFDL_SUBCYCLES * CHUNK,
                     "acoustic solve": NAMELIST_N_SPLIT * CHUNK,
                     "dense solve": NAMELIST_N_SPLIT * CHUNK}
        for name, fn in calls.items():
            n = device_activities(fn)
            log(f"  {name}: {n} device activities (profiler) and "
                f"{ms[name]:.3f} ms of device time a call, {per_chunk[name]} "
                f"calls a chunk: {n * per_chunk[name]} activities, "
                f"{ms[name] * per_chunk[name]:.1f} ms")
        log(f"  (the sedimentation of the 4 GFDL species stacked over "
            f"{NPZ} levels; the acoustic solve of one substep, its dense "
            f"solve of {d.delp[0, 0].numel() * 6} [{NPZ}, {NPZ}] systems "
            "inside it)")
        del loop, it

        # float64, 1 chunk of 2 steps (radiation at step 0), kernels
        # against plain through the loop
        cfg64 = dict(namelist_config(tmp, 1), fused_chunk_steps=2,
                     duration_seconds=2 * DT, radiation_interval_steps=2,
                     diagnostics=[], fortran_diagnostics=[])
        compared = loop_kernels_vs_plain(
            "float64 namelist chunk", cfg64,
            launches(remap_apply=2 * NAMELIST_REMAPS_PER_STEP,
                     weighted_select_dot=SELECT_PER_CALL,
                     spec_band_dot=SPEC_PER_CALL))
        check({"w", "delz", "tracer_o3mr", "tracer_graupel"} <= compared,
              f"float64 namelist chunk: fields {sorted(compared)}")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  namelist run: launches in the {2 * SEGMENT_CHUNKS} chunks of the "
        f"appended segments {total}")
    return total


# -- phase 20: the online microphysics emulator through run_segment ------
# the gscond piggy-back diagnostics a run records (the emulator's and
# the native stage's tendencies)
PIGGY_FIELDS = tuple(
    f"tendency_of_{f}_due_to_gscond_{src}"
    for f in ("air_temperature", "specific_humidity", "cloud_water")
    for src in ("emulator", "physics"))


EMULATOR_FIELDS = ("air_temperature", "specific_humidity",
                   "cloud_water_mixing_ratio")


def _emulator_sample(npz):
    """A seeded batch of 256 columns of the emulator's fields and its
    packing."""
    import numpy as np
    from fv3net_torch.fit.packer import PackingInfo

    rng = np.random.RandomState(0)
    X = np.concatenate([260 + 30 * rng.rand(256, npz),
                        0.01 * rng.rand(256, npz),
                        1e-4 * rng.rand(256, npz)], axis=1)
    return rng, X, PackingInfo(list(EMULATOR_FIELDS), [npz] * 3)


def dry_emulator_model(npz):
    """A float32 DenseModel (CPU) of the emulator's fields that is exactly
    q -> 0.99 q with T and cloud water passed through: one hidden ReLU
    layer [I, -I] (relu(x) - relu(-x) = x makes the map linear in
    normalized space), both scalers of zero mean and the sample's std, so
    that the map keeps each value's sign and q >= 0."""
    import numpy as np
    import torch
    from fv3net_torch.fit.dense import DenseModel
    from fv3net_torch.fit.normalize import StandardScaler

    _, X, info = _emulator_sample(npz)
    std = StandardScaler.fit(torch.tensor(X, dtype=torch.float32)).std
    m = np.ones(3 * npz)
    m[npz:2 * npz] = 0.99
    eye = np.eye(3 * npz)
    w = [np.concatenate([eye, -eye], axis=1),
         np.concatenate([np.diag(m), -np.diag(m)], axis=0)]
    params = [{"w": torch.tensor(wi, dtype=torch.float32),
               "b": torch.zeros(wi.shape[1], dtype=torch.float32)}
              for wi in w]
    return DenseModel(
        input_variables=info.names, output_variables=info.names,
        params=params, input_info=info, output_info=info,
        x_scaler=StandardScaler(torch.zeros_like(std), std),
        y_scaler=StandardScaler(torch.zeros_like(std), std.clone()))


def seeded_emulator_model(npz):
    """A float32 DenseModel (CPU) of the emulator's fields with one hidden
    layer of 16, untrained He-normal weights from a ``torch.Generator``
    seeded with 0, its scalers from the seeded sample."""
    import torch
    from fv3net_torch.fit.dense import DenseModel, init_mlp_params
    from fv3net_torch.fit.normalize import StandardScaler

    rng, X, info = _emulator_sample(npz)
    params = init_mlp_params(torch.Generator().manual_seed(0),
                             [3 * npz, 16, 3 * npz], dtype=torch.float32)
    Y = X * (1.0 + 0.01 * rng.randn(*X.shape))
    return DenseModel(
        input_variables=info.names, output_variables=info.names,
        params=params, input_info=info, output_info=info,
        x_scaler=StandardScaler.fit(torch.tensor(X, dtype=torch.float32)),
        y_scaler=StandardScaler.fit(torch.tensor(Y, dtype=torch.float32)))


def emulator_artifacts(tmp):
    """The emulator artifacts in the reference's dense format, written
    with the port's ``DenseModel.dump``: the dry map q -> 0.99 q (T and
    cloud water passed through, exactly linear; its zero-mean scalers
    keep q >= 0) and a seeded He-normal 1 x 16 model.  Returns their
    directories."""
    from fv3net_torch.fit import io

    dirs = {}
    for name, build in (("dry", dry_emulator_model),
                        ("seeded", seeded_emulator_model)):
        path = os.path.join(tmp, f"emulator_{name}")
        if not os.path.isdir(path):
            io.dump(build(NPZ), path)
        dirs[name] = path
    return dirs


def emulated_config(tmp, chunks=SEGMENT_CHUNKS, model="dry", **online):
    """Phase 15's run config with ``online_emulator`` (by default the dry
    map in place of Zhao-Carr)."""
    cfg = segment_config(tmp, chunks)
    cfg["online_emulator"] = {"url": emulator_artifacts(tmp)[model],
                              "target": "microphysics", **online}
    return cfg


def phase_emulated_run(device):
    """The emulated production run at C48: phase 15's configuration with
    ``online_emulator`` (the dry map, target microphysics) through
    ``api.create`` and two ``api.append_segment`` calls of SEGMENT_CHUNKS
    chunks, each chunk gated as phase 12 (launches exact, the dry-air
    budget, ...) and q >= 0; segment 2 started from segment 1's RESTART
    bit for bit; a fresh loop's chunk profiled; one chunk with the seeded
    model in the gscond slot, piggy-backed, whose six tendencies reach
    the zarr diagnostics; one float64 chunk of 2 steps, kernels against
    plain.  Returns the launches of the appended segments."""
    import tempfile

    import numpy as np
    import torch
    from fv3net_torch import entry
    from fv3net_torch.core import zarrio
    from fv3net_torch.runtime import checkpoint, timing
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.segmented_run import api

    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    expected = production_launches(CHUNK, RADIATION_CALLS_PER_CHUNK)
    total = launches()
    tmp = tempfile.mkdtemp(prefix="emulated_run_")
    try:
        url = os.path.join(tmp, "run")
        api.create(url, emulated_config(tmp))
        walls = []
        for s in (1, 2):
            with ChunkRecorder() as rec:
                t0 = time.perf_counter()
                seg = api.append_segment(url)
                seconds = time.perf_counter() - t0
            report = timing.phase_report()
            label = f"emulated segment {s}"
            loop = rec.loops[0]
            check(loop.fusable() and loop._production_features()
                  and loop._microphysics_emulator is not None
                  and loop._gscond_emulator is None,
                  f"{label}: the emulated production path was not taken")
            counts = gate_segment(label, rec, area, expected)
            total = {k: v + counts[k] for k, v in total.items()}
            for i, (_, _, out, _) in enumerate(rec.chunks):
                q_min = out[0].tracers["sphum"].min().item()
                check(q_min >= 0.0, f"{label} chunk {i}: q down to {q_min}")
            walls.append(log_segment(label, report, SEGMENT_CHUNKS,
                                     seconds))
            gate_stores(label, seg, SEGMENT_CHUNKS)
            if s == 1:
                state, t_end = checkpoint.load_state(
                    os.path.join(seg, "RESTART"))
                same_bits(state, loop.state,
                          "emulated segment 1 RESTART read back")
            else:
                same_bits(model_state_of(rec.chunks[0][1]), state,
                          "emulated segment 2's first chunk from segment "
                          "1's RESTART")
            del rec, loop

        loop = TimeLoop(get_config(emulated_config(tmp, 1)))
        it = iter(loop)
        reading = profile_chunk("emulated", lambda: next(it))
        log("  emulated profiled chunk (the loop's): wall "
            f"{reading['wall_ms']:.1f} ms, device busy "
            f"{reading['device_ms']:.1f} ms, idle share "
            f"{100 * (1 - reading['device_ms'] / reading['wall_ms']):.1f}%, "
            f"{reading['activities']} device activities; range device busy "
            + ", ".join(f"{r} {v:.1f} ms"
                        for r, v in reading["ranges"].items()))
        del loop, it

        # the seeded model in the gscond slot, piggy-backed: the native
        # stage advances the state, both sources' tendencies are recorded
        cfg = dict(emulated_config(tmp, 1, model="seeded", target="gscond",
                                   piggy_back=True),
                   fortran_diagnostics=[],
                   diagnostics=[{"name": "piggy.zarr",
                                 "variables": list(PIGGY_FIELDS),
                                 "times": {"kind": "every"}}])
        reset_counts()
        loop = api.run_segment(get_config(cfg), os.path.join(tmp, "piggy"))
        counts = read_counts()
        check(loop._gscond_emulator is not None
              and loop._emulator_piggy_back and loop.fusable(),
              "piggy-back: the gscond slot was not taken")
        check(counts == expected, f"piggy-back chunk: launches {counts}, "
              f"expected {expected}")
        ds = zarrio.open_zarr(os.path.join(tmp, "piggy", "piggy.zarr"))
        check(sorted(ds) == sorted(PIGGY_FIELDS),
              f"piggy-back store: variables {sorted(ds)}")
        for k in PIGGY_FIELDS:
            v = ds[k].values
            check(v.shape[0] == 1 and np.isfinite(v).all(),
                  f"piggy-back store {k}: shape {v.shape} or non-finite")
        e = ds["tendency_of_specific_humidity_due_to_gscond_emulator"].values
        p = ds["tendency_of_specific_humidity_due_to_gscond_physics"].values
        log(f"  piggy-back chunk (gscond, seeded model): {len(PIGGY_FIELDS)} "
            f"tendencies in the store; dq/dt emulator up to "
            f"{np.abs(e).max():.3e}, physics up to {np.abs(p).max():.3e} "
            "1/s")
        del loop

        cfg64 = dict(emulated_config(tmp, 1), fused_chunk_steps=2,
                     duration_seconds=2 * DT, radiation_interval_steps=2,
                     diagnostics=[], fortran_diagnostics=[])
        loop_kernels_vs_plain("float64 emulated chunk", cfg64,
                              production_launches(2, 1))
        log(f"  emulated run: wall per chunk in run_segment "
            + ", ".join(f"{w * 1e3:.1f} ms ({CHUNK * DT / w / 365.0:.3f} "
                        "SYPD)" for w in walls))
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  emulated run: launches in the {2 * SEGMENT_CHUNKS} chunks of the "
        f"appended segments {total}")
    return total


# -- phase 21: the radiation stepper and the GFS chain -------------------
STEPPER_STEPS = 4
GFS_JDATE = (2016, 7, 3, 12, 30, 0)
GFS_RTOL = 1e-10  # the float64 chain, kernels against plain
GFS_REPS = 3


def gfs_inputs(device, seed=0):
    """The GFS-layout inputs (ivflip=1, layer 0 at the surface) of the
    13,824 columns of a C48 rest state, float64: its pressures,
    temperatures and humidity, the ozone climatology, seeded GFDL
    condensate and cloud amount in the free troposphere, a seeded
    sfcprop over sea, land and sea ice, a seeded emissivity index map,
    and McICA uniforms from a ``torch.Generator`` on the card."""
    import numpy as np
    import torch
    from fv3net_torch.dycore.state import init_state, temperature_from_theta_v
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.ops import thermo
    from fv3net_torch.physics.radiation import gases

    grid = make_grid(NPX)
    f64 = dict(dtype=torch.float64, device=device)
    state, _, _ = init_state(grid, NPZ, **f64)
    delp = state.delp.movedim(1, -1).reshape(-1, NPZ)
    q = state.tracers["sphum"].movedim(1, -1).reshape(-1, NPZ)
    pe = thermo.pressure_at_interface(delp)
    pmid = thermo.pressure_at_midpoint_log(delp)
    T = temperature_from_theta_v(
        state.pt.movedim(1, -1).reshape(-1, NPZ), pmid, q)
    C = delp.shape[0]
    lat = torch.tensor(grid.lat.reshape(-1), **f64)
    o3 = gases.ozone_profile(pmid, lat)
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, **f64)

    liq = torch.where((pmid > 4.0e4) & (pmid < 9.0e4),
                      2.0e-5 * rand(C, NPZ), 0.0)
    ice = torch.where((pmid > 1.5e4) & (pmid < 4.5e4),
                      1.2e-5 * rand(C, NPZ), 0.0)
    cldamt = torch.where(liq + ice > 1e-7, 0.3 + 0.7 * rand(C, NPZ), 0.0)
    qgrs = torch.stack([q, o3, liq, ice, 0.2 * liq, 0.3 * ice, 0.1 * ice,
                        cldamt], dim=-1)
    statein = {"prsi": pe.flip(1), "prsl": pmid.flip(1), "tgrs": T.flip(1),
               "qgrs": qgrs.flip(1)}
    rng = np.random.default_rng(seed)
    slmsk = rng.integers(0, 3, C).astype(np.float64)
    tsfc = T[:, -1].cpu().numpy() + 2.0
    sfcprop = {
        "tsfc": tsfc, "slmsk": slmsk,
        "snowd": np.where(slmsk > 0.5, 20.0 * rng.random(C), 0.0),
        "zorl": 10.0 + 90.0 * rng.random(C),
        "hprime": 200.0 * rng.random(C),
        "alvsf": 0.2 + 0.1 * rng.random(C),
        "alnsf": 0.3 + 0.1 * rng.random(C),
        "alvwf": 0.18 + 0.1 * rng.random(C),
        "alnwf": 0.28 + 0.1 * rng.random(C),
        "facsf": 0.5 * np.ones(C), "facwf": 0.5 * np.ones(C),
        "fice": np.where(slmsk > 1.5, 0.6 + 0.4 * rng.random(C), 0.0),
        "tisfc": np.where(slmsk > 1.5, 260.0 + 10.0 * rng.random(C), tsfc),
    }
    grid_in = {"xlat": grid.lat.reshape(-1), "xlon": grid.lon.reshape(-1)}
    rand_lw = rand(C, 140 * NPZ)
    rand_sw = rand(C, 112 * NPZ)
    idxems = rng.integers(1, 9, size=(360, 180))
    return statein, sfcprop, grid_in, rand_lw, rand_sw, idxems


def phase_radiation_stepper(device):
    """The Python radiation stepper in a per-step TimeLoop at C48 (gray
    model radiation, the stepper on RRTMG every step): its launches each
    step, its fluxes among the diagnostics, ms a step; with apply_heating
    its dQ1 equal to its heating rate.  Then one GFSRadiationDriver call
    on the C48 columns in float64: against the same call with the plain
    versions (GFS_RTOL), its K4/K3 calls value by value within their
    summation roundoff, ms a call and the launches.  Returns the
    launches a stepper step and a GFS call."""
    import torch
    from fv3net_torch.physics.radiation import gfs_driver
    from fv3net_torch.physics.radiation.rrtmg import tables
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.steppers.radiation import RadiationStepper

    def stepper_config(steps, **rs):
        return get_config({
            "namelist": {"npx": NPX, "npz": NPZ},
            "duration_seconds": steps * DT,
            "radiation_scheme": {"kind": "python", "scheme": "rrtmg", **rs}})

    per_step = launches(remap_apply=REMAPS_PER_STEP,
                        weighted_select_dot=SELECT_PER_CALL,
                        spec_band_dot=SPEC_PER_CALL)
    log(f"  predicted launches a stepper step: {per_step}")
    loop = TimeLoop(stepper_config(STEPPER_STEPS))
    check(not loop.fusable() and loop._radiation_stepper is not None
          and loop._radiation_fn is None,
          "the stepper loop is not the per-step path with gray radiation")
    it = iter(loop)
    walls = []
    flux = "total_sky_upward_longwave_flux_at_top_of_atmosphere_python"
    for i in range(STEPPER_STEPS):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, diags = next(it)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
        check(counts == per_step, f"stepper step {i}: launches {counts}, "
              f"expected {per_step}")
        for k in (flux, "total_sky_downward_shortwave_flux_at_surface_python",
                  "clear_sky_longwave_heating_rate_python"):
            check(k in diags and torch.isfinite(diags[k].data).all().item(),
                  f"stepper step {i}: {k} missing or non-finite")
        check("dQ1_radiation" not in diags,
              f"stepper step {i}: dQ1 applied without apply_heating")
    ms = statistics.median(walls[1:]) * 1e3
    log(f"  stepper loop: {ms:.1f} ms a step (median of "
        f"{STEPPER_STEPS - 1} after the first, "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls)
        + f"), OLR {diags[flux].data.min().item():.1f} .. "
        f"{diags[flux].data.max().item():.1f} W/m2")
    del loop, it

    heated = TimeLoop(stepper_config(1, apply_heating=True))
    calls = []
    orig = RadiationStepper.__call__

    def record(self, time_, state):
        out = orig(self, time_, state)
        calls.append(out)
        return out

    RadiationStepper.__call__ = record
    try:
        (_, diags), = list(heated)
    finally:
        RadiationStepper.__call__ = orig
    (tendencies, sdiags, _), = calls
    heating = sdiags["tendency_of_air_temperature_due_to_radiation"].data
    check(torch.equal(diags["dQ1_radiation"].data, heating)
          and torch.equal(tendencies["dQ1"].data, heating),
          "apply_heating: dQ1 is not the stepper's heating rate")
    log("  apply_heating: dQ1 equal to the stepper's heating rate")
    del heated

    statein, sfcprop, grid, rand_lw, rand_sw, idxems = gfs_inputs(device)
    lw_t, sw_t = tables.make_lw_tables(seed=0), tables.make_sw_tables(seed=1)
    drivers = {}
    for impl in ("torch", None):
        d = gfs_driver.GFSRadiationDriver(
            gfs_driver.GFSDriverConfig(levs=NPZ), lw_t, sw_t, idxems,
            device=device, impl=impl)
        d.radupdate(GFS_JDATE, DT)
        drivers[impl] = d

    def call(impl):
        return drivers[impl](statein, sfcprop, grid, 12.5, rand_lw, rand_sw)

    want = call("torch")
    reset_counts()
    with Recorder() as rec:
        got = call(None)
    counts = read_counts()
    gfs_launches = launches(weighted_select_dot=SELECT_PER_CALL,
                            spec_band_dot=SPEC_PER_CALL)
    check(counts == gfs_launches, f"GFS call: launches {counts}, expected "
          f"{gfs_launches}")
    bad, worst = [], 0.0
    for k, w in want.items():
        if not torch.is_tensor(w):
            continue
        g = got[k]
        check(torch.isfinite(g).all().item(), f"GFS call: non-finite {k}")
        scale = w.abs().max().item()
        rel = ((g - w).abs().max().item() / scale if scale > 0
               else float((g != w).any()))
        worst = max(worst, rel)
        if not rel <= GFS_RTOL:
            bad.append(f"{k} rel {rel:.3e}")
    check(not bad, f"GFS call, kernels against plain: {bad}")
    day = (got["coszen"] > 1e-4).sum().item()
    log(f"  GFS call (C{NPX}, {got['coszen'].numel()} columns, {day} daylit; "
        f"float64): {len(want) - 1} outputs within {worst:.3e} of their "
        f"scale of the plain call (bound {GFS_RTOL}); launches {counts}")
    phase_radiation_summation(rec)
    f64_lines = ktable_lines_of_call(rec)
    del rec
    walls = {impl: [] for impl in ("torch", None)}
    for _ in range(GFS_REPS):
        for impl in (None, "torch"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(impl)
            torch.cuda.synchronize()
            walls[impl].append(time.perf_counter() - t0)
    ms = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    log(f"  GFS call: {ms[None]:.1f} ms with the kernels, {ms['torch']:.1f} "
        f"ms with the plain versions (host clock, medians of {GFS_REPS}); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        "since the start")
    return per_step, counts, f64_lines


def ktable_lines_of_call(rec, reps=20):
    """Kernel-line numbers of K4 and K3 on one recorded radiation call
    (the GFS chain's float64 call): the call of each kernel with the
    largest output against its plain version and ``embedding_bag``,
    device times and bound, and all of the call's calls timed together
    with their summed bound (path_ms, path_bound_ms)."""
    from fv3net_torch.ops import ktable_cuda

    lines = {}
    for name, calls, plain, cost, kernel, library in (
            ("weighted_select_dot", rec.select, _select_plain,
             lambda a, out: _select_cost(*a, out),
             ktable_cuda.weighted_select_dot_cuda, _embedding_bag_select),
            ("spec_band_dot", rec.spec, _spec_plain, _spec_cost,
             ktable_cuda.spec_band_dot_cuda, _embedding_bag_spec)):
        worst, path_bound = 0.0, 0.0
        dtype_name = str(calls[0][1].dtype).replace("torch.", "")
        for i, (a, out) in enumerate(calls):
            err, scale = max_diff(out, plain(*a), f"{name} call {i}")
            check(err <= KTABLE_RTOL[dtype_name] * scale,
                  f"{name} {dtype_name} call {i}: max|kernel-plain| {err} > "
                  f"{KTABLE_RTOL[dtype_name]} * {scale}")
            worst = max(worst, err)
            path_bound += bound(*cost(a, out), dtype_name)[0]
        a, out = max(calls, key=lambda c: c[1].numel())
        lib = library(*a)
        lib_err = max_diff(lib(), out, f"embedding_bag {name}")[0]
        before = read_counts()[name]
        ms = device_ms({"kernel": lambda: kernel(*a),
                        "plain": lambda: plain(*a), "library": lib}, reps)

        def run_path(calls=calls, kernel=kernel):
            for args, _ in calls:
                kernel(*args)

        path_ms = device_ms({"path": run_path}, 4, warmup=1)["path"]
        check(read_counts()[name] > before, f"{name} did not launch")
        bound_ms, by = bound(*cost(a, out), dtype_name)
        log(f"  {name} {dtype_name} (GFS chain, {len(calls)} calls a call; "
            f"the largest, out {tuple(out.shape)}): kernel {ms['kernel']:.4f}"
            f" ms, plain {ms['plain']:.4f} ms, embedding_bag "
            f"{ms['library']:.4f} ms (max|diff| {lib_err:.3e}), bound "
            f"{bound_ms:.4f} ms ({by}, {100 * bound_ms / ms['kernel']:.1f}%"
            f"); all {len(calls)} calls {path_ms:.4f} ms against "
            f"{path_bound:.4f} ms; kernel against plain within {worst:.3e}")
        lines[name] = {"max_abs_err": worst, "ms": ms["kernel"],
                       "plain_ms": ms["plain"], "bound_ms": bound_ms,
                       "bound_by": by, "library_ms": ms["library"],
                       "path_ms": path_ms, "path_bound_ms": path_bound}
    return lines


# -- phase 23: the dense trainer on the card ------------------------------
TRAIN_F64_RTOL = 1e-10  # the card's float64 training against the CPU's
TRAIN_REPS = 3


def phase_trainer(device):
    """``entry.train_entry_model`` for the flagship (2 x 128, 256 samples)
    and production (1 x 16, 64 samples) models, one epoch each, on the
    card in float32 and float64: finite weights of the entries' shapes,
    float64 within TRAIN_F64_RTOL of scale of the same training on the
    CPU (the initial weights are drawn on the CPU, so both start alike),
    ms a training (host clock, median of TRAIN_REPS).  Earlier phases
    already drove the entries with these trained models (phases 4-5 and
    12-20 build them through ``entry`` and ``production_model``)."""
    import torch
    from fv3net_torch import entry

    models = {"flagship": dict(hidden=(128, 128), n=256,
                               dq_scale=(1e-5, 1e-8)),
              "production": dict(hidden=(16,), n=64,
                                 dq_scale=(1e-6, 1e-9))}
    times = {}
    for label, kw in models.items():
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).replace("torch.", "")
            walls = []
            for _ in range(TRAIN_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model = entry.train_entry_model(NPZ, dtype, device, 0, **kw)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            times[f"{label} {dname}"] = statistics.median(walls) * 1e3
            shapes = [tuple(layer.weight.shape) for layer in model.layers]
            want = [(w, v) for v, w in zip(
                [2 * NPZ, *kw["hidden"]], [*kw["hidden"], 2 * NPZ])]
            check(shapes == want, f"{label} {dname}: layers {shapes}, "
                  f"expected {want}")
            check(all(torch.isfinite(p).all().item()
                      for p in model.parameters()),
                  f"{label} {dname}: non-finite weights")
            if dtype == torch.float64:
                cpu = entry.train_entry_model(NPZ, dtype, "cpu", 0, **kw)
                worst = 0.0
                for a, b in zip(model.parameters(), cpu.parameters()):
                    worst = max(worst, ((a.cpu() - b).abs().max()
                                        / b.abs().max()).item())
                check(worst <= TRAIN_F64_RTOL, f"{label} float64: card "
                      f"against CPU {worst:.3e} > {TRAIN_F64_RTOL}")
                log(f"  {label} float64: the card's trained weights within "
                    f"{worst:.3e} of scale of the CPU's (bound "
                    f"{TRAIN_F64_RTOL})")
    log("  training one epoch on the card (host clock, median of "
        f"{TRAIN_REPS}): " + ", ".join(f"{k} {v:.1f} ms"
                                       for k, v in times.items()))
    return times


# -- phase 24: the sharded dry run, four ranks on the one card -------------
DRYRUN_RANKS = 4


def phase_sharded_dryrun(device):
    """``entry.dryrun_multigpu(4)`` with its C384 case in four processes
    over gloo on the one card (NCCL takes one rank a device): every rank
    computes its block on the card with the hand kernels.  Prints each
    check's reading beside its bound and the per-rank K1/K4/K3 launches,
    which must equal the single-device run's (rank 0's), and the sharded
    step's and chunk's times against one device's: four processes
    sharing one card, not a multi-card speed.  A rank that fails fails
    the phase."""
    import torch
    from fv3net_torch import entry
    from fv3net_torch.parallel import sharded

    results = sharded.launch(entry.dryrun_multigpu, DRYRUN_RANKS,
                             (DRYRUN_RANKS, torch.float32, str(device)),
                             backend="gloo")
    summary = results[0]
    check(not summary["failures"], f"dry run: {summary['failures']}")
    for key in ("multichip_numerics", "production_chunk_numerics",
                "write_sharded_roundtrip", "dp_training_step",
                "c384_production_chunk"):
        sec = summary[key]
        log(f"  {key}: max rel " + ", ".join(
            f"{k} {v:.3e}" for k, v in
            sec["max_rel_diff_vs_single_device"].items())
            + " (abs " + ", ".join(
                f"{k} {v:.3e}" for k, v in
                sec["max_abs_diff_vs_single_device"].items())
            + f"); bound {sec['bound']}")
    single = summary["counts"]
    for case in ("step", "production_chunk", "c384"):
        key = "single_step" if case == "step" else f"{case}_single"
        sharded_key = ("sharded_step" if case == "step"
                       else f"{case}_sharded")
        want = tuple(single[key])
        for res in results:
            got = tuple(res["counts"][sharded_key])
            check(got == want, f"rank {res['rank']} {case}: K1/K4/K3 "
                  f"launches {got}, one device {want}")
        log(f"  {case}: K1/K4/K3 launches on each of the "
            f"{DRYRUN_RANKS} ranks " + ", ".join(
                str(tuple(r["counts"][sharded_key])) for r in results)
            + f", one device {want}")
    check(sum(single["single_step"]) > 0, "the dry run launched no kernel")
    w = summary["wall_seconds"]
    log(f"  wall: sharded step {w['sharded_step']:.3f} s, one device "
        f"{w['single_step']:.3f} s; sharded chunk "
        f"{w['production_chunk_sharded']:.3f} s, one device "
        f"{w['production_chunk_single']:.3f} s; C384 sharded "
        f"{w['c384_sharded']:.3f} s, one device {w['c384_single']:.3f} s; "
        f"training step {w['dp_training_step']:.3f} s (each the first call, "
        f"its setup in; {DRYRUN_RANKS} processes share one card and its "
        "host: not a multi-card speed)")
    return summary


# -- phase 22: synthband and Held-Suarez ---------------------------------
SYNTHBAND_TIMED_CHUNKS = 2
HELD_SUAREZ_RTOL = 1e-6


def phase_synthband(device):
    """The flagship chunk with the synthetic band radiation at C48: one
    warm-up and SYNTHBAND_TIMED_CHUNKS timed chunks (K1 only, exact), one
    profiled; the band radiation's heating and fluxes on the last state
    finite; a float64 chunk of 2 steps, kernels against plain (1e-8 of
    each field's scale); then held_suarez_forcing on the C48 JW06 state
    on the card against its CPU result (HELD_SUAREZ_RTOL)."""
    import torch
    from fv3net_torch import entry
    from fv3net_torch.dycore import testcases
    from fv3net_torch.dycore.state import temperature_from_theta_v
    from fv3net_torch.ops import thermo
    from fv3net_torch.physics import held_suarez
    from fv3net_torch.physics.driver import PhysicsConfig
    from fv3net_torch.runtime import fused

    step, (state, ml_params, sst, cosz) = entry.flagship(
        npx=NPX, npz=NPZ, radiation="synthband", chunk=CHUNK, device=device)
    grid = entry.make_grid(NPX)
    area = torch.tensor(grid.area, device=device)
    path = Path("synthband", step, state, (ml_params, sst, cosz), area,
                launches(remap_apply=CHUNK * REMAPS_PER_STEP))
    for _ in range(1 + SYNTHBAND_TIMED_CHUNKS):
        path.chunk()
    path.summary()
    reading = profile_chunk("synthband",
                            lambda: path.step(path.state, *path.args))
    log("  synthband profiled chunk: device busy "
        f"{reading['device_ms']:.1f} ms of {reading['wall_ms']:.1f} ms wall "
        f"(idle {100 * (1 - reading['device_ms'] / reading['wall_ms']):.1f}"
        f"%), {reading['activities']} device activities")
    band = fused._build_radiation_fn(
        PhysicsConfig(radiation_scheme="synthband"), device, torch.float32)
    lat = torch.tensor(grid.lat, dtype=torch.float32, device=device)
    heating, diags = band(*radiation_inputs(path.state, sst, cosz, lat))
    for k, v in dict(diags, heating=heating).items():
        check(torch.isfinite(v).all().item(), f"synthband: non-finite {k}")
    check((heating != 0).any().item(), "synthband: no heating")
    log(f"  synthband radiation on the last state: heating "
        f"{heating.min().item() * 86400:.2f} .. "
        f"{heating.max().item() * 86400:.2f} K/day, OLR "
        f"{diags['ULWRFtoa'].min().item():.1f} .. "
        f"{diags['ULWRFtoa'].max().item():.1f} W/m2")
    del path, step

    outs = {}
    for impl in ("torch", "cuda"):
        step, (st, mlp, sst64, cosz64) = entry.flagship(
            npx=NPX, npz=NPZ, radiation="synthband", chunk=2,
            radiation_interval=2, dtype=torch.float64, device=device,
            impl=impl)
        reset_counts()
        outs[impl] = fields(step(st, mlp, sst64, cosz64))
        counts = read_counts()
        want = (launches() if impl == "torch"
                else launches(remap_apply=2 * REMAPS_PER_STEP))
        check(counts == want, f"float64 synthband chunk ({impl}): launches "
              f"{counts}, expected {want}")
    worst = 0.0
    for k, want in outs["torch"].items():
        got = outs["cuda"][k]
        rel = (got - want).abs().max().item() / want.abs().max().clamp(
            min=1e-300).item()
        worst = max(worst, rel)
        check(rel <= PRODUCTION_CHUNK_RTOL, f"float64 synthband chunk, "
              f"kernels against plain: {k} rel {rel:.3e}")
    log(f"  float64 synthband chunk of 2 steps, kernels against plain: "
        f"{len(outs['torch'])} fields within {worst:.3e} of their scale "
        f"(bound {PRODUCTION_CHUNK_RTOL})")
    del outs

    jw, _, _ = testcases.baroclinic_wave_state(grid, NPZ,
                                               dtype=torch.float64,
                                               device=device)
    delp = jw.delp.movedim(1, -1)
    pmid = thermo.pressure_at_midpoint_log(delp)
    T = temperature_from_theta_v(jw.pt.movedim(1, -1), pmid,
                                 jw.tracers["sphum"].movedim(1, -1))
    wind = jw.wind.movedim(2, -1)
    ps = delp.sum(-1) + thermo.TOA_PRESSURE
    lat64 = torch.tensor(grid.lat, dtype=torch.float64, device=device)
    args = (T, wind, pmid, ps, lat64)
    got = held_suarez.held_suarez_forcing(*args, DT)
    want = held_suarez.held_suarez_forcing(*(a.cpu() for a in args), DT)
    for name, g, w in zip(("T", "wind"), got, want):
        check(torch.isfinite(g).all().item(), f"Held-Suarez: non-finite "
              f"{name}")
        rel = ((g.cpu() - w).abs().max() / w.abs().max()).item()
        check(rel <= HELD_SUAREZ_RTOL, f"Held-Suarez {name}: card against "
              f"CPU {rel:.3e}")
        log(f"  Held-Suarez {name} on the C{NPX} JW06 state: card against CPU "
            f"{rel:.3e} of scale (bound {HELD_SUAREZ_RTOL}); change up to "
            f"{(w - args[0 if name == 'T' else 1].cpu()).abs().max():.3e}")


# ------------------------------------------- the time loop's steppers
# the per-step path with RRTMG at C48: every step is a radiation step
# (the per-step loop calls the model's radiation each step, as the
# reference's does)
STEPPER_SEGMENT_STEPS = 4  # steps a segment of phases 25 and 27
NUDGED = ("air_temperature", "specific_humidity", "eastward_wind",
          "northward_wind", "pressure_thickness_of_atmospheric_layer")
NUDGE_TIMES = 9  # time indices of the reference store, one a step
NUDGE_TAU_HOURS = 3.0
NUDGE_RTOL = 1e-12  # the float64 step's tendencies against the host's
PRESCRIBED_TIMES = 9  # time indices of phase 26's dQ1/dQ2 store
PRESCRIBED_CHUNK = 4  # steps a fused chunk of phase 26
FUSED_VS_STEP_RTOL = 1e-10  # float64 fused chunk against per-step steps
BIAS_INTERVAL_S = 1800.0
RESERVOIR_STATE = 500  # the reference's default state size
RESERVOIR_L2 = 1.0  # the readout's ridge (see phase_reservoir)
COLUMN_SERIES = 200  # steps of the column series
CUBE_SERIES = 60  # steps of the cube series
RESERVOIR_TRAIN_RTOL = 1e-4  # float32 card training against the CPU's
RESERVOIR_PREDICT_RTOL = 1e-5  # a prediction against the host's
RESERVOIR_SYNC_STEPS = 2
RESERVOIR_STEP_S = 1800.0
INCREMENT_REPS = 20


def per_step_launches():
    """The launches of a per-step step at C48 with RRTMG: K1 on the
    dycore's 3 remaps, K4 and K3 in the step's radiation call."""
    return launches(remap_apply=REMAPS_PER_STEP,
                    weighted_select_dot=SELECT_PER_CALL,
                    spec_band_dot=SPEC_PER_CALL)


class StepRecorder:
    """While active, every step of the per-step path a TimeLoop takes is
    recorded: its launches (counts set to 0 just before the step, read
    just after), its wall time (ending in a synchronize), the keys of its
    diagnostics, and the loops that took them; ``after(loop, diags)``,
    if given, runs after each step."""

    def __init__(self, after=None):
        from fv3net_torch.runtime import loop

        self.cls, self.orig = loop.TimeLoop, loop.TimeLoop._step
        self.after = after
        self.steps, self.loops = [], []

    def __enter__(self):
        import torch

        orig, rec = self.orig, self

        def step(loop):
            if not rec.loops or rec.loops[-1] is not loop:
                rec.loops.append(loop)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(loop)
            torch.cuda.synchronize()
            rec.steps.append((read_counts(), time.perf_counter() - t0,
                              set(out[1])))
            if rec.after is not None:
                rec.after(loop, out[1])
            return out

        self.cls._step = step
        return self

    def __exit__(self, *exc):
        self.cls._step = self.orig

    def gate(self, label, n_steps):
        """Gates: ``n_steps`` steps, each with the per-step launches, one
        loop whose state is finite; returns (launches summed, walls)."""
        check(len(self.steps) == n_steps,
              f"{label}: {len(self.steps)} steps, expected {n_steps}")
        want = per_step_launches()
        total = launches()
        for i, (counts, _, _) in enumerate(self.steps):
            check(counts == want, f"{label} step {i + 1}: launches "
                  f"{counts}, expected {want}")
            total = {k: v + counts[k] for k, v in total.items()}
        loop = self.loops[-1]
        check(not loop.fusable(), f"{label}: not the per-step path")
        for name, x in state_tensors(loop.state).items():
            check(x.isfinite().all().item(), f"{label}: non-finite {name}")
        return total, [w for _, w, _ in self.steps]


def stepper_run_config(tmp, steps, **extra):
    """Phase 15's configuration (C48, npz=32, RRTMG, slab ocean, sea ice,
    the "set" SST prescriber) without its ML model, run per step for
    ``steps`` steps, without diagnostics files; ``extra`` keys added."""
    cfg = segment_config(tmp)
    cfg.pop("scikit_learn")
    cfg.update(duration_seconds=steps * DT, fused_chunk_steps=0,
               diagnostics=[], fortran_diagnostics=[])
    cfg.update(extra)
    return cfg


def median_ms(walls):
    return statistics.median(walls) * 1e3


def rel_err(got, want):
    """max |got - want| over max |want|, in float64 on the host."""
    import torch

    got = torch.as_tensor(got).double().cpu()
    want = torch.as_tensor(want).double().cpu()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    return err / scale if scale > 0 else (0.0 if err == 0 else math.inf)


def nudging_store(tmp, loop):
    """The reference store of the nudged run: NUDGE_TIMES time indices
    (one a model step from the start) of the nudged fields, each the
    run's initial field plus a fixed seeded perturbation (2 K in T, 10%
    in q, 3 m/s in the winds, 0.5% in delp, uniform) of which a tenth is
    drawn anew at each time; float32 zarr.  Returns its path and the
    host float64 arrays."""
    import numpy as np
    from fv3net_torch.core import zarrio
    from fv3net_torch.core.dataset import Dataset
    from fv3net_torch.core.quantity import Quantity

    rng = np.random.RandomState(25)
    st = loop._derived()
    amp = {"air_temperature": 2.0, "eastward_wind": 3.0,
           "northward_wind": 3.0}
    ref = {}
    for k in NUDGED:
        x = st[k].data.double().cpu().numpy()
        fixed = rng.uniform(-1.0, 1.0, x.shape)
        noise = fixed + 0.1 * rng.uniform(-1.0, 1.0,
                                          (NUDGE_TIMES,) + x.shape)
        if k == "specific_humidity":
            v = x * (1.0 + 0.1 * noise)
        elif k == "pressure_thickness_of_atmospheric_layer":
            v = x * (1.0 + 0.005 * noise)
        else:
            v = x + amp[k] * noise
        ref[k] = v.astype(np.float32)
    path = os.path.join(tmp, "nudge.zarr")
    zarrio.to_zarr(Dataset({k: Quantity(v, ("time", "tile", "z", "y", "x"))
                            for k, v in ref.items()}), path)
    return path, ref


def phase_nudged_run(device):
    """The nudged run (``nudging``) through ``append_segment`` at C48:
    phase 15's configuration without the ML model, nudging T, q, both
    winds and delp toward a seeded reference store (:func:`nudging_store`)
    with a 3-hour timescale, 2 segments of STEPPER_SEGMENT_STEPS steps on
    the per-step path, then one segment of twice the steps from the same
    start and one without nudging.  Gates: every step's launches (K1 3,
    K4 44, K3 23: RRTMG each step) and finite fields; the nudging
    diagnostics in the zarr store; 2 x 4 steps against 1 x 8 bit for bit;
    T nearer its reference after 8 steps than without nudging (RMS); one
    float64 step with the kernels and with the plain versions within
    PRODUCTION_CHUNK_RTOL, its nudging tendencies equal to (ref -
    state) / tau computed on the host in float64 within NUDGE_RTOL.
    Returns the ms a step with and without nudging."""
    import datetime
    import shutil
    import tempfile

    import numpy as np
    import torch
    from fv3net_torch.core import zarrio
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.segmented_run import api
    from fv3net_torch.runtime.steppers.nudging import PureNudger

    steps = STEPPER_SEGMENT_STEPS
    tmp = tempfile.mkdtemp(prefix="nudged_run_")
    try:
        free_cfg = stepper_run_config(tmp, 2 * steps)
        loop = TimeLoop(get_config(free_cfg))
        store, ref = nudging_store(tmp, loop)
        del loop
        tau = NUDGE_TAU_HOURS * 3600.0
        diag_vars = ["dQ1_nudging", "dQp_nudging",
                     "net_mass_tendency_due_to_nudging",
                     "column_heating_due_to_nudging",
                     "air_temperature_reference",
                     "pressure_thickness_of_atmospheric_layer_reference"]
        # the timescales in sorted order, as the run config's yaml holds
        # them: the tendencies apply in that order, and it matters (the
        # humidity and delp setters move delp)
        nudged = stepper_run_config(
            tmp, steps,
            nudging={"restarts_path": store, "timescale_hours": {
                k: NUDGE_TAU_HOURS for k in sorted(NUDGED)}},
            diagnostics=[{"name": "nudging.zarr", "variables": diag_vars,
                          "times": {"kind": "every"}}])
        url = os.path.join(tmp, "run")
        api.create(url, nudged)
        total, walls, loops = launches(), [], []
        for s in (1, 2):
            with StepRecorder() as rec:
                seg = api.append_segment(url)
            counts, w = rec.gate(f"nudged segment {s}", steps)
            check(type(rec.loops[0]._postphysics_stepper) is PureNudger,
                  f"nudged segment {s}: the nudger is not the postphysics "
                  "stepper")
            total = {k: v + counts[k] for k, v in total.items()}
            walls += w
            loops.append(rec.loops[0])
            ds = zarrio.open_zarr(os.path.join(seg, "nudging.zarr"))
            check(sorted(ds) == sorted(diag_vars),
                  f"nudged segment {s}: store variables {sorted(ds)}")
            for k in diag_vars:
                check(ds[k].shape[0] == steps
                      and np.isfinite(ds[k].values).all(),
                      f"nudged segment {s}: {k} shape {ds[k].shape}")
            log(f"  nudged segment {s}: {steps} steps, "
                f"{median_ms(w):.1f} ms a step (median; "
                + ", ".join(f"{x * 1e3:.1f}" for x in w)
                + f"), launches {counts}; store {sorted(ds)}")
        with StepRecorder() as rec:
            long = api.run_segment(
                get_config(dict(nudged, duration_seconds=2 * steps * DT,
                                diagnostics=[])),
                os.path.join(tmp, "long"))
        rec.gate("nudged 1 x 8", 2 * steps)
        same_bits(loops[1].state, long.state,
                  f"nudged 2 x {steps} steps against 1 x {2 * steps}")
        with StepRecorder() as rec:
            free = api.run_segment(get_config(free_cfg),
                                   os.path.join(tmp, "free"))
        _, free_walls = rec.gate("without nudging", 2 * steps)
        t_ref = torch.tensor(ref["air_temperature"][2 * steps],
                             dtype=torch.float64)

        def rms(loop):
            T = loop._derived()["air_temperature"].data.double().cpu()
            return (T - t_ref).pow(2).mean().sqrt().item()

        rms_nudged, rms_free = rms(long), rms(free)
        check(rms_nudged < rms_free, f"nudged T RMS {rms_nudged:.4f} K "
              f"from its reference, not below {rms_free:.4f} K without")
        log(f"  after {2 * steps} steps, RMS of T - T_ref: nudged "
            f"{rms_nudged:.4f} K, without nudging {rms_free:.4f} K")
        del long, free, loops

        # one float64 step, kernels against plain; the nudger's calls
        # recorded: its tendencies against the host's float64
        calls, orig = [], PureNudger.__call__

        def record(self, time_, state):
            before = {k: state[k].data.double().cpu() for k in NUDGED}
            out = orig(self, time_, state)
            calls.append((time_, before, out))
            return out

        PureNudger.__call__ = record
        try:
            loop_kernels_vs_plain(
                "float64 nudged loop",
                dict(nudged, duration_seconds=DT, diagnostics=[]),
                per_step_launches())
        finally:
            PureNudger.__call__ = orig
        check(len(calls) == 2, f"{len(calls)} nudger calls")
        t_call, before, (tend, diags, _) = calls[-1]
        t_start = datetime.datetime.fromisoformat(
            get_config(nudged).initial_time)
        idx = int(round((t_call - t_start).total_seconds() / DT))
        worst = 0.0
        names_ = {"air_temperature": "dQ1", "specific_humidity": "dQ2",
                  "eastward_wind": "dQu", "northward_wind": "dQv",
                  "pressure_thickness_of_atmospheric_layer": "dQp"}
        for k, tname in names_.items():
            want = (torch.tensor(ref[k][idx], dtype=torch.float64)
                    - before[k]) / tau
            err = rel_err(tend[tname].data, want)
            worst = max(worst, err)
            check(err <= NUDGE_RTOL, f"nudging {tname}: {err:.3e} of scale "
                  f"from (ref - state) / tau on the host")
            check(f"{k}_reference" in diags, f"no {k}_reference")
        log(f"  float64 step: the nudging tendencies within {worst:.3e} of "
            f"their scale of (ref - state) / tau on the host (bound "
            f"{NUDGE_RTOL}; reference index {idx})")

        loop = TimeLoop(get_config(nudged))
        it = iter(loop)
        next(it)
        reading = profile_chunk("nudged step", lambda: next(it))
        del loop, it
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ms, ms_free = median_ms(walls), median_ms(free_walls)
    log(f"  nudged run: {ms:.1f} ms a step ({DT / (ms / 1e3) / 365.0:.3f} "
        f"SYPD; median of {len(walls)}), without nudging {ms_free:.1f} ms "
        f"({DT / (ms_free / 1e3) / 365.0:.3f} SYPD); profiled step: wall "
        f"{reading['wall_ms']:.1f} ms, device busy "
        f"{reading['device_ms']:.1f} ms, {reading['activities']} "
        f"activities; launches in the appended segments {total}")
    return ms, ms_free


def tendency_store(tmp):
    """PRESCRIBED_TIMES time indices of seeded dQ1 / dQ2 at C48 (float32
    zarr) whose tails hold outliers beyond their 1% and 99% quantiles
    (1% of the cells at +-100 times the spread)."""
    import numpy as np
    from fv3net_torch.core import zarrio
    from fv3net_torch.core.dataset import Dataset
    from fv3net_torch.core.quantity import Quantity

    rng = np.random.RandomState(26)
    shape = (PRESCRIBED_TIMES, 6, NPZ, NPX, NPX)
    data = {}
    for name, spread in (("dQ1", 2e-5), ("dQ2", 2e-9)):
        x = spread * rng.randn(*shape)
        flat = x.reshape(PRESCRIBED_TIMES, -1)
        n = flat.shape[1] // 100
        idx = rng.choice(flat.shape[1], n, replace=False)
        flat[:, idx] = 100.0 * spread * np.sign(rng.randn(n))
        data[name] = x.astype(np.float32)
    path = os.path.join(tmp, "tendencies.zarr")
    zarrio.to_zarr(Dataset({k: Quantity(v, ("time", "tile", "z", "y", "x"))
                            for k, v in data.items()}), path)
    return path, data


def phase_prescribed_tendencies(device):
    """Prescribed tendencies at C48 on the production configuration (the
    trained 1 x 16 ML stepper, slab ocean, sea ice, the SST prescriber):
    (a) with a limited prephysics ``tendency_prescriber`` (dQ1, dQ2,
    quantiles 0.01 and 0.99) through ``append_segment`` as 2 fused
    chunks of PRESCRIBED_CHUNK steps; (b) the same config in 8 per-step
    steps; (c) 8 per-step steps with the top-level
    ``tendency_prescriber`` and ``bias_correction`` every
    BIAS_INTERVAL_S; (d) float64, (a)'s 2 fused chunks against (b)'s 8
    per-step steps, radiation every step (the per-step path has no
    radiation interval), each per-step step given its chunk's cos-zenith
    (a chunk takes its midpoint's). Gates: exact launches (a chunk K1
    12, K4 44, K3 23; a step K1 3, K4 44, K3 23); the limiter's bounds
    equal to np.quantile of the store's first prescribed time; no
    prescribed value outside them; bias correction on steps 1, 3, 5, 7
    only; (d) within FUSED_VS_STEP_RTOL of each field's scale. Returns
    (ms a fused chunk, ms a per-step step)."""
    import datetime
    import shutil
    import tempfile

    import numpy as np
    import torch
    from fv3net_torch.runtime import timing
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.segmented_run import api
    from fv3net_torch.runtime.steppers.tendency_prescriber import (
        TendencyPrescriber,
    )

    n_steps = 2 * PRESCRIBED_CHUNK
    tmp = tempfile.mkdtemp(prefix="prescribed_")
    try:
        store, data = tendency_store(tmp)
        base = segment_config(tmp)
        entry_ = {"kind": "tendency_prescriber", "dataset": store,
                  "variables": ["dQ1", "dQ2"],
                  "limit_quantiles": {"upper": 0.99, "lower": 0.01}}
        cfg_a = dict(base, prephysics=base["prephysics"] + [entry_],
                     fused_chunk_steps=PRESCRIBED_CHUNK,
                     duration_seconds=n_steps * DT, diagnostics=[],
                     fortran_diagnostics=[])
        # (a) fused
        url = os.path.join(tmp, "fused")
        api.create(url, cfg_a)
        with ChunkRecorder() as rec:
            t0 = time.perf_counter()
            api.append_segment(url)
            seconds = time.perf_counter() - t0
        per_chunk = log_segment("fused prescribed run", timing.phase_report(),
                                2, seconds, PRESCRIBED_CHUNK)
        loop = rec.loops[0]
        check(loop.fusable() and len(rec.chunks) == 2,
              "the prescribed run did not take 2 fused chunks")
        tp = loop._prephysics_steppers[1]
        check(isinstance(tp, TendencyPrescriber) and tp.limiter is not None,
              "no fitted tendency prescriber in the fused loop")
        want = production_launches(PRESCRIBED_CHUNK, 1)
        bounds = tp.limiter.bounds
        for i, (n, args, out, counts) in enumerate(rec.chunks):
            check(counts == want, f"fused chunk {i}: launches {counts}, "
                  f"expected {want}")
            for name, x in fields(out[0]).items():
                check(torch.isfinite(x).all().item(),
                      f"fused chunk {i}: non-finite {name}")
            prescribed = args[3][1]
            for k, (lo, hi) in bounds.items():
                x = prescribed[k]
                check(x.min().item() >= np.float32(lo)
                      and x.max().item() <= np.float32(hi),
                      f"fused chunk {i}: {k} outside [{lo}, {hi}]")
        for k in ("dQ1", "dQ2"):
            q = (np.quantile(data[k][1], 0.01), np.quantile(data[k][1], 0.99))
            check(tuple(bounds[k]) == q, f"limiter bounds of {k} "
                  f"{bounds[k]} against np.quantile {q}")
            outside = ((data[k][1:n_steps + 1] < q[0])
                       | (data[k][1:n_steps + 1] > q[1])).mean()
            log(f"  {k}: bounds [{q[0]:.4e}, {q[1]:.4e}] equal to "
                f"np.quantile of the store's first prescribed time; "
                f"{100 * outside:.2f}% of the prescribed values clipped")
        del rec, loop, tp
        # (b) per step
        with StepRecorder() as rec:
            api.run_segment(get_config(dict(cfg_a, fused_chunk_steps=0)),
                            os.path.join(tmp, "per_step"))
        _, walls = rec.gate("per-step prescribed run", n_steps)
        # (c) the top-level prescriber and bias correction
        cfg_c = dict(stepper_run_config(tmp, n_steps),
                     tendency_prescriber={
                         "dataset": store, "variables": ["dQ2"],
                         "limit_quantiles": {"upper": 0.99, "lower": 0.01}},
                     bias_correction={
                         "dataset": store, "variables": ["dQ1"],
                         "apply_interval_seconds": BIAS_INTERVAL_S})
        with StepRecorder() as rec:
            api.run_segment(get_config(cfg_c), os.path.join(tmp, "bias"))
        rec.gate("bias-corrected run", n_steps)
        fired = [i + 1 for i, (_, _, keys) in enumerate(rec.steps)
                 if "dQ1_interval_bias_correction" in keys]
        check(fired == [1, 3, 5, 7], f"bias correction fired on steps "
              f"{fired}, expected 1, 3, 5, 7")
        check(all("dQ2_tendency_prescriber" in keys
                  for _, _, keys in rec.steps),
              "the top-level tendency prescriber missed a step")
        log(f"  bias correction fired on steps {fired}; the top-level "
            "tendency prescriber on every step")
        del rec
        # (d) float64: run (a)'s 2 fused chunks against (b)'s 8 per-step
        # steps.  Radiation every step: the per-step path (the
        # reference's too) has no radiation interval, so (a)'s cached
        # heating between radiation steps has no per-step counterpart.
        # Each per-step step takes its chunk's cos-zenith (a chunk holds
        # its midpoint's).
        cfg64 = dict(cfg_a, radiation_interval_steps=1)
        fused = TimeLoop(get_config(cfg64), dtype=torch.float64)
        start = fused.time
        cosz = []
        for c in range(2):
            fused.time = start + datetime.timedelta(
                seconds=c * PRESCRIBED_CHUNK * DT)
            cosz.append(fused.chunk_cos_zenith(PRESCRIBED_CHUNK))
        fused.time = start
        stepped = TimeLoop(get_config(dict(cfg64, fused_chunk_steps=0)),
                           dtype=torch.float64)

        def chunk_cos_zenith(time_):
            # the loop's time is the step's end when its physics runs
            step = round((time_ - start).total_seconds() / DT) - 1
            return cosz[step // PRESCRIBED_CHUNK]

        stepped._cos_zenith = chunk_cos_zenith
        check(fused.fusable() and not stepped.fusable(),
              "the float64 pair is not fused against per step")
        n_chunks = sum(1 for _ in fused)
        n_stepped = sum(1 for _ in stepped)
        check(n_chunks == 2 and n_stepped == n_steps
              and fused.time == stepped.time,
              f"float64 pair: {n_chunks} chunks against {n_stepped} steps")
        a, b = state_tensors(fused.state), state_tensors(stepped.state)
        check(set(a) == set(b), f"fields {sorted(a)} against {sorted(b)}")
        worst = max(rel_err(a[k], b[k]) for k in b)
        check(worst <= FUSED_VS_STEP_RTOL, f"float64 fused chunks against "
              f"per-step steps: {worst:.3e} > {FUSED_VS_STEP_RTOL}")
        log(f"  float64: 2 fused chunks of {PRESCRIBED_CHUNK} steps (tend, "
            f"radiation every step) within {worst:.3e} of scale of "
            f"{n_steps} per-step steps, all {len(b)} fields (bound "
            f"{FUSED_VS_STEP_RTOL})")
        del fused, stepped
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ms_step = median_ms(walls)
    log(f"  prescribed tendencies: fused {per_chunk * 1e3:.1f} ms a chunk "
        f"of {PRESCRIBED_CHUNK} steps in run_segment "
        f"({per_chunk * 1e3 / PRESCRIBED_CHUNK:.1f} ms a step), per step "
        f"{ms_step:.1f} ms a step (median of {len(walls)})")
    return per_chunk * 1e3, ms_step


def reservoir_series(loop):
    """The training series of phase 27 from the run's initial state
    (host, float32): (i) COLUMN_SERIES columns of T and q, each a random
    column of the state plus 1 K and 5% noise, with the clean column's T
    as its target; (ii) CUBE_SERIES cube fields of T and q plus the same
    noise, [t, 6, ny, nx, 2 npz] (~212 MB), with their T as targets.
    Returns both, and held-out inputs of each (3 apiece)."""
    import numpy as np
    from fv3net_torch.fit.packer import stack_columns

    rng = np.random.RandomState(27)
    st = loop._derived()
    T = st["air_temperature"].data.float().cpu()
    q = st["specific_humidity"].data.float().cpu()
    cols = np.concatenate([stack_columns(T).numpy(),
                           stack_columns(q).numpy()], axis=1)

    def perturb(x):
        y = x.copy()
        y[..., :NPZ] += rng.randn(*y[..., :NPZ].shape).astype(np.float32)
        y[..., NPZ:] *= 1.0 + 0.05 * rng.randn(
            *y[..., NPZ:].shape).astype(np.float32)
        return y

    pick = rng.randint(cols.shape[0], size=COLUMN_SERIES)
    column = (perturb(cols[pick]), cols[pick, :NPZ].copy())
    column_held = [perturb(cols) for _ in range(3)]
    cube0 = np.concatenate([T.movedim(1, -1).numpy(),
                            q.movedim(1, -1).numpy()], axis=-1)
    u = np.empty((CUBE_SERIES,) + cube0.shape, np.float32)
    for t in range(CUBE_SERIES):
        u[t] = perturb(cube0)
    cube = (u, u[..., :NPZ])
    cube_held = [perturb(cube0) for _ in range(3)]
    return column, column_held, cube, cube_held


def phase_reservoir(device, ms_without):
    """The reservoir corrector at C48.  Trains on the card and on the
    CPU, float32 (the reference's): a ``hybrid_reservoir`` and a
    ``reservoir`` (state RESERVOIR_STATE) on COLUMN_SERIES columns of T
    and q (64 features, T out) and a ``subdomain_reservoir`` ((2, 2)
    subdomains a tile, overlap 1, state RESERVOIR_STATE) on CUBE_SERIES
    cube fields of them (:func:`reservoir_series`), each with the ridge
    RESERVOIR_L2 (the readouts have more features than samples, and the
    reference's 1e-6 leaves them far off the series on held-out
    columns); the card's held-out
    predictions within RESERVOIR_TRAIN_RTOL of the CPU's.  Then the
    hybrid and the subdomain model each as ``reservoir_corrector``
    (synchronize_steps 2, a reservoir step of 1800 s) through
    ``append_segment`` over 2 segments of STEPPER_SEGMENT_STEPS steps,
    the second warm-started from ``save_reservoir_state``; and one step
    with ``diagnostic_only``.  Gates: each step's launches (phase 25's);
    the incrementer before the predictor on every step that predicts;
    predictions only after the synchronization (on the second segment's
    steps 1 and 3) and equal to the model's readout recomputed on the
    host in float64 from its state within RESERVOIR_PREDICT_RTOL; T after
    such a step equal to the prediction (within 1e-6, through theta_v);
    under ``diagnostic_only`` the prediction a diagnostic and no state
    update.  Readings: the trainers' seconds, ms of one increment at
    13,824 columns (pure, hybrid) and at 24 subdomains, ms a step with
    the corrector against ``ms_without``."""
    import shutil
    import tempfile

    import torch
    from fv3net_torch.core.dataset import Dataset
    from fv3net_torch.core.quantity import Quantity
    from fv3net_torch.fit import reservoir as tres
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop

    names_in = ["air_temperature", "specific_humidity"]
    tmp = tempfile.mkdtemp(prefix="reservoir_")
    try:
        loop = TimeLoop(get_config(stepper_run_config(tmp, 1)))
        column, column_held, cube, cube_held = reservoir_series(loop)
        del loop
        hp = dict(input_variables=names_in,
                  output_variables=["air_temperature"],
                  state_size=RESERVOIR_STATE,
                  l2_regularization=RESERVOIR_L2)

        def dataset(pair, dims, where):
            return Dataset({k: Quantity(torch.tensor(v, device=where), dims)
                            for k, v in zip(("inputs", "outputs"), pair)})

        trainers = {
            "pure": lambda w: tres.train_reservoir_model(
                tres.ReservoirHyperparameters(**hp),
                [dataset(column, ("time", "f"), w)]),
            "hybrid": lambda w: tres.train_hybrid_reservoir_model(
                tres.ReservoirHyperparameters(**hp),
                [dataset(column, ("time", "f"), w)]),
            "subdomain": lambda w: tres.train_subdomain_reservoir(
                tres.SubdomainReservoirHyperparameters(
                    input_variables=names_in,
                    output_variables=["air_temperature"],
                    subdomain_layout=(2, 2), overlap=1,
                    reservoir=tres.ReservoirHyperparameters(
                        state_size=RESERVOIR_STATE,
                        l2_regularization=RESERVOIR_L2)),
                [dataset(cube, ("time", "tile", "y", "x", "f"), w)]),
        }
        models, seconds = {}, {}
        for label, train in trainers.items():
            got = {}
            for where, name in ((device, "card"), ("cpu", "cpu")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[name] = train(where)
                torch.cuda.synchronize()
                seconds[f"{label} {name}"] = time.perf_counter() - t0
            held = column_held if label != "subdomain" else cube_held
            preds = {}
            for name, m in got.items():
                if label == "subdomain":
                    m.reset_state()
                else:
                    m.reset_state(batch_shape=(held[0].shape[0],))
                for x in held[:2]:
                    m.increment(torch.tensor(x, device=m.W.device))
                preds[name] = m.predict_from_state(
                    torch.tensor(held[2], device=m.W.device))
            err = rel_err(preds["card"], preds["cpu"])
            lo, hi = preds["cpu"].min().item(), preds["cpu"].max().item()
            check(torch.isfinite(preds["card"]).all().item(),
                  f"{label} reservoir: non-finite predictions")
            check(err <= RESERVOIR_TRAIN_RTOL, f"{label} reservoir: card "
                  f"against CPU {err:.3e} > {RESERVOIR_TRAIN_RTOL}")
            log(f"  {label} reservoir trained: card {seconds[label + ' card']:.2f} "
                f"s, CPU {seconds[label + ' cpu']:.2f} s; held-out "
                f"predictions card against CPU {err:.3e} of scale (bound "
                f"{RESERVOIR_TRAIN_RTOL}), {lo:.1f} .. {hi:.1f} K")
            models[label] = got["card"]

        # one increment at the run's shapes
        increment_ms = {}
        ncol = 6 * NPX * NPX
        for label, m in models.items():
            if label == "subdomain":
                m.reset_state()
                u = torch.tensor(cube_held[0], device=device)
            else:
                m.reset_state(batch_shape=(ncol,))
                u = torch.tensor(column_held[0], device=device)
            increment_ms[label] = cuda_ms(lambda: m.increment(u),
                                          INCREMENT_REPS)
        log("  one increment (CUDA events, median of "
            f"{INCREMENT_REPS}): pure {increment_ms['pure']:.3f} ms and "
            f"hybrid {increment_ms['hybrid']:.3f} ms at {ncol} columns, "
            f"subdomain {increment_ms['subdomain']:.3f} ms at "
            f"{models['subdomain'].divider.n_subdomains} subdomains")

        walls = {}
        for label in ("hybrid", "subdomain"):
            walls[label] = reservoir_segments(label, tmp, models[label])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  ms a step with the corrector (median): "
        + ", ".join(f"{k} {median_ms(v):.1f}" for k, v in walls.items())
        + f"; without (phase 25) {ms_without:.1f}; trainers' seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    return increment_ms


def reservoir_segments(label, tmp, model):
    """One model as the reservoir corrector: 2 appended segments (the
    second warm-started from the state the first left) and one
    diagnostic-only step, gated as :func:`phase_reservoir` says; returns
    the walls of the segments' steps."""
    import torch
    from fv3net_torch.fit import io
    from fv3net_torch.fit.packer import unstack_columns
    from fv3net_torch.runtime import factories
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.segmented_run import api
    from fv3net_torch.runtime.steppers import reservoir as rsteppers

    model_dir = os.path.join(tmp, f"{label}_model")
    io.dump(model, model_dir)
    steps = STEPPER_SEGMENT_STEPS
    rc = {"model_path": model_dir, "synchronize_steps": RESERVOIR_SYNC_STEPS,
          "reservoir_timestep_seconds": RESERVOIR_STEP_S}
    cfg = stepper_run_config(tmp, steps, reservoir_corrector=rc)
    events, built = [], []
    orig_build = factories.get_reservoir_steppers
    orig_inc = rsteppers.ReservoirIncrementOnlyStepper.__call__
    orig_pred = rsteppers.ReservoirPredictStepper.__call__

    def build(*a, **k):
        pair = orig_build(*a, **k)
        built.append(pair)
        return pair

    def inc(self, time_, state):
        fired = self._fsm.completed_increments
        out = orig_inc(self, time_, state)
        events.append(("increment", time_,
                       self._fsm.completed_increments > fired))
        return out

    def pred(self, time_, state):
        u = self._pull_inputs(state)
        r = self.model.state.clone()
        out = orig_pred(self, time_, state)
        events.append(("predict", time_, (u, r, out)))
        return out

    landed = []

    def after(loop, diags):
        upd = [e for e in events if e[0] == "predict" and e[1] == loop.time
               and (e[2][2][2] or e[2][2][1])]
        if upd:
            q = upd[-1][2][2][2].get("air_temperature")
            if q is not None:
                landed.append(rel_err(
                    loop._derived()["air_temperature"].data, q.data))

    factories.get_reservoir_steppers = build
    rsteppers.ReservoirIncrementOnlyStepper.__call__ = inc
    rsteppers.ReservoirPredictStepper.__call__ = pred
    walls = []
    try:
        url = os.path.join(tmp, f"{label}_run")
        api.create(url, cfg)
        for s in (1, 2):
            with StepRecorder(after=after) as rec:
                api.append_segment(url)
            _, w = rec.gate(f"{label} corrector segment {s}", steps)
            walls += w
            if s == 1:
                rsteppers.save_reservoir_state(built[-1][1].model,
                                               model_dir)
                api.create(url, dict(cfg, reservoir_corrector=dict(
                    rc, warm_start=True)))
        # diagnostic only: one warm-started step
        with StepRecorder() as rec:
            api.run_segment(get_config(stepper_run_config(
                tmp, 1, reservoir_corrector=dict(
                    rc, warm_start=True, diagnostic_only=True))),
                os.path.join(tmp, f"{label}_diagnostic"))
        rec.gate(f"{label} diagnostic-only step", 1)
    finally:
        factories.get_reservoir_steppers = orig_build
        rsteppers.ReservoirIncrementOnlyStepper.__call__ = orig_inc
        rsteppers.ReservoirPredictStepper.__call__ = orig_pred
    # the order: each step's increment before its predict
    kinds = [e[0] for e in events]
    check(kinds == ["increment", "predict"] * (2 * steps + 1),
          f"{label}: stepper calls {kinds}")
    predicted = [i // 2 + 1 for i, e in enumerate(events)
                 if e[0] == "predict" and (e[2][2][1] or e[2][2][2])]
    want = [steps + 1, steps + 3, 2 * steps + 1]
    check(predicted == want, f"{label}: predictions on steps {predicted}, "
          f"expected {want} (the second segment's 1st and 3rd, the "
          "diagnostic step)")
    for i, e in enumerate(events):
        if e[0] == "predict" and i // 2 + 1 in predicted:
            check(events[i - 1][2], f"{label}: step {i // 2 + 1} predicted "
                  "without an increment firing before it")
    # each prediction against the host's float64 readout of the state
    host = model.to(device="cpu", dtype=torch.float64)
    worst = 0.0
    for i, e in enumerate(events):
        if e[0] != "predict" or i // 2 + 1 not in predicted:
            continue
        u, r, (_, diags, updates) = e[2]
        got = (updates.get("air_temperature")
               or diags.get("air_temperature_reservoir_prediction")).data
        host.state = r.double().cpu()
        want_pred = host.predict_from_state(u.double().cpu())
        if hasattr(host, "divider"):
            want_t = want_pred.movedim(-1, 1)
        else:
            want_t = unstack_columns(want_pred, (6, NPX, NPX))
        err = rel_err(got, want_t)
        worst = max(worst, err)
        check(err <= RESERVOIR_PREDICT_RTOL, f"{label} step {i // 2 + 1}: "
              f"prediction {err:.3e} of scale from the host's readout")
    diag_pred = events[-1][2][2]
    check(diag_pred[2] == {} and "air_temperature_reservoir_prediction"
          in diag_pred[1], f"{label}: diagnostic_only updated the state or "
          "lacks its diagnostic")
    check(len(landed) == 2 and max(landed) <= 1e-6,
          f"{label}: T after the predicting steps against the prediction "
          f"{landed}")
    log(f"  {label} corrector: predictions on steps {predicted} (the last "
        "diagnostic only), each within "
        f"{worst:.3e} of scale of the host's float64 readout (bound "
        f"{RESERVOIR_PREDICT_RTOL}); T after the step within "
        f"{max(landed):.3e} of the prediction; {median_ms(walls):.1f} ms a "
        "step (median of " f"{len(walls)})")
    return walls



# phase 28: the offline ops and pipelines at
# C384 -> C48, factor 8, float32, on a state made from a seed on the card
OFFLINE_NZ = 79  # the reference's levels (the diagnostics' 79)
OFFLINE_TRACERS = {"sphum": 1e-2, "cloud_water": 1e-4, "ice_wat": 1e-4,
                   "rainwat": 1e-4, "snowwat": 1e-4, "graupel": 1e-4,
                   "o3mr": 1e-5}  # the GFDL tracer set and its scales
OFFLINE_F64_NZ = 8  # levels of the float64 kernel-against-plain calls
OFFLINE_F64_RTOL = 1e-12  # float64, kernel against plain, of scale
# a float32 sum of a block's 64 terms errs by at most 63 roundings of 2^-24,
# and an average divides two such sums: the bound of a float32 K5 call
# against its plain version (of the output's scale) and of the coarse
# column mass against the fine.  Whole float32 coarsenings are held to
# their plain runs by NaN and finiteness only: on pressure levels the
# plain run's coarse pressures part by an ulp, which may flip a fine
# cell's below-the-surface mask (a 1e-5 chance a cell) or move a thin
# layer's edge, so each K5 call is held on its own arguments instead
F32_SUM_RTOL = 128 * 2.0 ** -24
LATLON = (180, 360)
LATLON_RTOL = 1e-6  # conservative_sum's total against sum(field * area)
SURFACE_SUBTILES = 2  # subtiles a side: 4 shards a tile
SURFACE_VARS = ("PRATEsfc", "TMP2m", "ULWRFsfc")
SURFACE_TIMES = 2
SURFACE_WORKERS = 4
RESTART_COARSENINGS = {"sigma": "coarsen_state_on_sigma",
                       "pressure": "coarsen_state_on_pressure",
                       "blended": "coarsen_state_blended"}
# code the coarsen_restarts CLI's child process runs first (empty on the
# card; a CPU rehearsal puts its stubs here)
CLI_PRELUDE = ""


def offline_launches(method, n_tracers):
    """K5 launches of one restart coarsening, counted from
    ``pipelines/coarsen_restarts.py``: on sigma delp, pt, each tracer, the
    3 wind components and phis; on pressure the same plus the coarse delp
    of the regrid (``ops/regridz.py::regrid_to_area_weighted_pressure``);
    the blend both and the coarse delp of its weights."""
    sigma = 6 + n_tracers
    pressure = 7 + n_tracers
    return {"sigma": sigma, "pressure": pressure,
            "blended": sigma + pressure + 1}[method]


BUDGET_LAUNCHES = 5  # compute_budget: the coarse delp, 4 fields' averages


class PlainK5:
    """Inside the block, K5's dispatcher runs its plain version
    (``impl="torch"``) wherever the offline modules call it."""

    def __enter__(self):
        import functools

        from fv3net_torch.ops import coarsen

        self.orig = coarsen.weighted_block_average
        coarsen.weighted_block_average = functools.partial(self.orig,
                                                           impl="torch")

    def __exit__(self, *exc):
        from fv3net_torch.ops import coarsen

        coarsen.weighted_block_average = self.orig


class CheckedK5:
    """Inside the block each K5 launch is followed by its plain version on
    the same arguments, which must give NaN at the same places and the
    other values within ``rtol`` of the output's scale; counts the calls,
    the NaN values and the calls with weights of x's full shape, and
    keeps the worst error."""

    def __init__(self, rtol):
        self.rtol = rtol
        self.calls = self.nans = self.full_rank = 0
        self.worst = 0.0

    def __enter__(self):
        from fv3net_torch.ops import coarsen, coarsen_cuda

        self.orig = coarsen_cuda.weighted_block_average_cuda

        def checked(x, w, factor):
            got = self.orig(x, w, factor)
            want = coarsen.weighted_block_average_plain(x, w, factor)
            err, nans = nan_and_scale(
                f"K5 call {self.calls} (x {tuple(x.shape)}, w "
                f"{tuple(w.shape)}, {x.dtype})", got, want, self.rtol)
            self.calls += 1
            self.nans += nans
            self.full_rank += tuple(w.shape) == tuple(x.shape)
            self.worst = max(self.worst, err)
            return got

        coarsen_cuda.weighted_block_average_cuda = checked
        return self

    def __exit__(self, *exc):
        from fv3net_torch.ops import coarsen_cuda

        coarsen_cuda.weighted_block_average_cuda = self.orig


CUBE_GRIDS = {}


def cube_grid(n):
    """``make_grid(n)``, built once a resolution (C384 takes seconds)."""
    from fv3net_torch.grid.geometry import make_grid

    if n not in CUBE_GRIDS:
        CUBE_GRIDS[n] = make_grid(n)
    return CUBE_GRIDS[n]


def offline_state(device, dtype, nz, seed=0):
    """A seeded C384 dycore state on ``device``: hybrid-like levels under
    a surface pressure that varies by hPa from cell to cell (so that
    coarse layers reach below the fine surface of some cells of a block),
    random winds and the GFDL tracer set, and its cell areas."""
    import torch
    from fv3net_torch.core.constants import TOA_PRESSURE
    from fv3net_torch.dycore.state import DycoreState

    n = C384
    grid = cube_grid(n)
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device, dtype=dtype)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=dtype)

    lat = torch.as_tensor(grid.lat, dtype=dtype, device=device)
    lon = torch.as_tensor(grid.lon, dtype=dtype, device=device)
    ps = (1.0e5 + 1500.0 * torch.cos(2 * lat) * torch.sin(lon)
          + 1000.0 * randn(6, n, n))
    frac = torch.diff(torch.linspace(0.0, 1.0, nz + 1,
                                     dtype=torch.float64) ** 1.5)
    delp = (ps - TOA_PRESSURE)[:, None] * frac.to(dtype=dtype, device=device)[
        None, :, None, None]
    state = DycoreState(
        delp=delp, pt=280.0 + 40.0 * rand(6, nz, n, n),
        wind=10.0 * randn(3, 6, nz, n, n),
        tracers={k: s * rand(6, nz, n, n)
                 for k, s in OFFLINE_TRACERS.items()},
        phis=3.0e4 * rand(6, n, n))
    return state, torch.as_tensor(grid.area, dtype=dtype, device=device)


def offline_fields(state):
    out = {"delp": state.delp, "pt": state.pt, "phis": state.phis}
    out.update({f"wind_{c}": state.wind[c] for c in range(3)})
    out.update({f"tracer_{k}": v for k, v in state.tracers.items()})
    return out


def nan_and_scale(label, got, want, rtol):
    """NaN at the same places as ``want``, and the other values finite and
    within ``rtol`` of ``want``'s scale (its largest finite magnitude;
    ``math.inf``: not held); returns (error of scale, NaN count)."""
    import torch

    nan = torch.isnan(want)
    check(got.shape == want.shape and torch.equal(torch.isnan(got), nan),
          f"{label}: NaN where the plain version has none, or the other "
          "way round")
    check(bool(torch.isfinite(got[~nan]).all()), f"{label}: non-finite "
          "value where the plain version is finite")
    fin = ~nan
    if not fin.any():
        return 0.0, int(nan.sum())
    scale = want[fin].abs().max().double().item()
    err = (got[fin] - want[fin]).abs().max().double().item()
    err = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
    check(err <= rtol, f"{label}: kernel against plain {err:.3e} of scale "
          f"> {rtol}")
    return err, int(nan.sum())


def column_mass_error(delp_c, fine_mass, area_c):
    """max over coarse columns of |sum_z delp_c * area_c - the block's
    fine sum_z delp * area| relative to the latter."""
    coarse = delp_c.double().sum(1) * area_c
    return ((coarse - fine_mass).abs() / fine_mass).max().item()


def offline_restarts(state, area):
    """The three restart coarsenings of the float32 state: each timed,
    its K5 launches and its coarse column mass gated, each of its K5
    calls held against plain on its own arguments, and its fields
    against the whole plain run (NaN and finiteness); returns (launches,
    the sigma coarse state)."""
    import torch
    from fv3net_torch.ops import coarsen
    from fv3net_torch.pipelines import coarsen_restarts as cr

    nt = len(state.tracers)
    fine_mass = coarsen.block_sum(state.delp.double().sum(1)
                                  * area.double(), COARSEN_FACTOR)
    area_c = coarsen.block_sum(area.double(), COARSEN_FACTOR)
    launched, sigma = 0, None
    for method, name in RESTART_COARSENINGS.items():
        fn = getattr(cr, name)
        seconds = []  # a first call (the card's first use of some
        for _ in range(2):  # operations) and a second
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(state, area, COARSEN_FACTOR)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        counts = read_counts()
        want_counts = launches(weighted_block_average=offline_launches(
            method, nt))
        check(counts == want_counts, f"{method} coarsening: launches "
              f"{counts}, expected {want_counts}")
        launched += counts["weighted_block_average"]
        with CheckedK5(F32_SUM_RTOL) as calls:
            fn(state, area, COARSEN_FACTOR)
        check(calls.calls == want_counts["weighted_block_average"],
              f"{method}: {calls.calls} K5 calls checked")
        with PlainK5():
            want = fn(state, area, COARSEN_FACTOR)
        got_f, want_f = offline_fields(out), offline_fields(want)
        check(sorted(got_f) == sorted(want_f), f"{method}: fields")
        errs, nans = {}, {}
        for k in want_f:
            check(got_f[k].shape[-2:] == (C384 // COARSEN_FACTOR,) * 2,
                  f"{method} {k}: shape {tuple(got_f[k].shape)}")
            errs[k], nans[k] = nan_and_scale(f"{method} {k}", got_f[k],
                                             want_f[k], math.inf)
        mass = column_mass_error(out.delp, fine_mass, area_c)
        check(mass <= F32_SUM_RTOL, f"{method}: coarse column mass parts "
              f"from the fine by {mass:.3e} > {F32_SUM_RTOL:.3e}")
        worst = max(errs, key=errs.get)
        log(f"  restart coarsening on {method}: C{C384} -> "
            f"C{C384 // COARSEN_FACTOR}, {OFFLINE_NZ} levels, {nt} "
            f"tracers, float32: {seconds[0]:.3f} s, again "
            f"{seconds[1]:.3f} s, K5 launches "
            f"{counts['weighted_block_average']} (expected "
            f"{want_counts['weighted_block_average']}); each K5 call "
            f"against plain on its arguments at most {calls.worst:.3e} of "
            f"scale (bound {F32_SUM_RTOL:.2e}; {calls.full_rank} calls with "
            f"weights of x's full shape, {calls.nans} NaN values); the "
            f"whole plain run: NaN at the same {sum(nans.values())} places, "
            f"finite elsewhere, at most {errs[worst]:.3e} of scale apart "
            f"({worst}); column mass Σ delp·area within {mass:.3e} of the "
            f"fine (bound {F32_SUM_RTOL:.2e})")
        if method == "sigma":
            sigma = out
        del out, want, got_f, want_f
    return launched, sigma


def budget_inputs(state, seed=1):
    """The fine-resolution budget's z-last inputs from a state: T and q at
    the begin and end of an interval, and physics tendencies."""
    import torch

    g = torch.Generator(device=state.delp.device).manual_seed(seed)

    def randn(like):
        return torch.randn(like.shape, generator=g, device=like.device,
                           dtype=like.dtype)

    T0 = state.pt.movedim(1, -1)
    q0 = state.tracers["sphum"].movedim(1, -1)
    return (T0, T0 + 0.5 * randn(T0), q0, q0 * (1 + 0.01 * randn(q0)),
            1e-4 * randn(T0), 1e-7 * randn(q0), state.delp.movedim(1, -1))


def offline_budget(state, area):
    """compute_budget on the C384 state: timed, launches gated, each K5
    call against plain on its arguments, the outputs against the plain
    run by NaN and finiteness; returns the launches."""
    import torch
    from fv3net_torch.pipelines import fine_res_budget as fb

    args = budget_inputs(state)
    seconds = []  # a first call and a second
    for _ in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fb.compute_budget(*args, area, COARSEN_FACTOR, 900.0)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = read_counts()
    check(counts == launches(weighted_block_average=BUDGET_LAUNCHES),
          f"compute_budget: launches {counts}, expected {BUDGET_LAUNCHES} "
          "of K5")
    with CheckedK5(F32_SUM_RTOL) as calls:
        fb.compute_budget(*args, area, COARSEN_FACTOR, 900.0)
    check(calls.calls == BUDGET_LAUNCHES, f"compute_budget: {calls.calls} "
          "K5 calls checked")
    with PlainK5():
        want = fb.compute_budget(*args, area, COARSEN_FACTOR, 900.0)
    errs = {k: nan_and_scale(f"budget {k}", out[k], want[k], math.inf)[0]
            for k in want}
    worst = max(errs, key=errs.get)
    log(f"  compute_budget (Q1, Q2, dQ1, dQ2 and the storage terms): "
        f"C{C384} -> C{C384 // COARSEN_FACTOR}, {OFFLINE_NZ} levels, "
        f"float32: {seconds[0]:.3f} s, again {seconds[1]:.3f} s, K5 "
        f"launches {counts['weighted_block_average']}; each K5 call "
        f"against plain "
        f"at most {calls.worst:.3e} of scale (bound {F32_SUM_RTOL:.2e}); "
        f"the whole plain run at most {errs[worst]:.3e} of scale apart "
        f"({worst}), NaN and finite alike")
    return counts["weighted_block_average"]


def sfc_data_fields(device, seed=6):
    """GFS-named sfc_data fields at C384 on ``device``, with blocks
    without snow or sea ice, whose snow- and ice-weighted averages are K5
    calls with all-zero weight blocks (NaN, then 0)."""
    import torch

    n = C384
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape or (6, n, n), generator=g, device=device)

    slmsk = torch.where(rand() < 0.5, 0.0, torch.where(rand() < 0.7, 1.0,
                                                        2.0))
    fields = {
        "slmsk": slmsk, "vtype": (16 * rand()).floor(),
        "stype": (17 * rand()).floor(), "vfrac": rand(),
        "sncovr": torch.where(rand() > 0.6, rand(), 0.0),
        "fice": torch.where(slmsk == 2.0, 0.2 + 0.8 * rand(), 0.0),
        "tsea": 260 + 40 * rand(), "tg3": 260 + 30 * rand(),
        "canopy": rand(), "zorl": 100 * rand(), "sheleg": 50 * rand(),
        "hice": 3 * rand(), "tisfc": 250 + 40 * rand(),
        "srflag": (2 * rand()).floor(), "slope": 1 + (8 * rand()).floor(),
        "shdmin": 0.05 * rand(), "t2m": 260 + 40 * rand(),
        "smc": 0.1 + 0.4 * rand(6, 4, n, n),
        "stc": 260 + 40 * rand(6, 4, n, n),
    }
    fields["sncovr"][:, :n // 2] = 0.0  # no snow in half of each tile
    return fields


def offline_sfc_data(device, area):
    """coarsen_sfc_data_complex at C384: its K5 calls (some over blocks
    whose weights are all 0) against plain on their arguments, the output
    against the plain run; returns its launches."""
    import torch
    from fv3net_torch.pipelines import coarsen_restarts as cr

    fields = sfc_data_fields(device)
    reset_counts()
    t0 = time.perf_counter()
    out = cr.coarsen_sfc_data_complex(fields, area, COARSEN_FACTOR)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = read_counts()["weighted_block_average"]
    # the fields that ``coarsen_sfc_data_complex`` averages with K5 (the
    # categories slmsk, vtype and stype take block modes)
    area_fields = [k for k in fields if k not in ("slmsk", "vtype", "stype")
                   and cr.SFC_DATA_COARSENING_METHOD.get(k, "area") in (
                       "area", "area_sncovr", "area_fice")]
    check(n == len(area_fields), f"coarsen_sfc_data_complex: {n} K5 "
          f"launches, expected {len(area_fields)} ({area_fields})")
    with CheckedK5(F32_SUM_RTOL) as calls:
        cr.coarsen_sfc_data_complex(fields, area, COARSEN_FACTOR)
    check(calls.nans > 0, "coarsen_sfc_data_complex: no K5 call met a "
          "block of zero weights")
    with PlainK5():
        want = cr.coarsen_sfc_data_complex(fields, area, COARSEN_FACTOR)
    errs = {k: nan_and_scale(f"sfc_data {k}", out[k], want[k],
                             F32_SUM_RTOL)[0] for k in want}
    log(f"  coarsen_sfc_data_complex: C{C384} -> C{C384 // COARSEN_FACTOR}, "
        f"{len(fields)} fields, float32: {seconds:.3f} s, K5 launches {n}; "
        f"each K5 call against plain at most {calls.worst:.3e} of scale, "
        f"NaN (all-zero weight blocks) at the same {calls.nans} places; "
        f"the output against the plain run at most "
        f"{max(errs.values()):.3e} of scale")
    return n


def offline_float64(device):
    """One float64 sigma and pressure coarsening and one float64
    compute_budget at C384 on fewer levels, kernel against plain within
    1e-12 of each output's scale."""
    import torch
    from fv3net_torch.pipelines import coarsen_restarts as cr
    from fv3net_torch.pipelines import fine_res_budget as fb

    state, area = offline_state(device, torch.float64, OFFLINE_F64_NZ,
                                seed=2)
    nt = len(state.tracers)
    for method in ("sigma", "pressure"):
        fn = getattr(cr, RESTART_COARSENINGS[method])
        reset_counts()
        got = offline_fields(fn(state, area, COARSEN_FACTOR))
        check(read_counts() == launches(
            weighted_block_average=offline_launches(method, nt)),
            f"float64 {method}: launches {read_counts()}")
        with PlainK5():
            want = offline_fields(fn(state, area, COARSEN_FACTOR))
        errs = {k: nan_and_scale(f"float64 {method} {k}", got[k], want[k],
                                 OFFLINE_F64_RTOL)[0] for k in want}
        log(f"  float64 {method} coarsening, {OFFLINE_F64_NZ} levels: "
            f"kernel against plain at most {max(errs.values()):.3e} of "
            f"scale (bound {OFFLINE_F64_RTOL})")
    args = budget_inputs(state, seed=3)
    reset_counts()
    got = fb.compute_budget(*args, area, COARSEN_FACTOR, 900.0)
    check(read_counts() == launches(weighted_block_average=BUDGET_LAUNCHES),
          f"float64 compute_budget: launches {read_counts()}")
    with PlainK5():
        want = fb.compute_budget(*args, area, COARSEN_FACTOR, 900.0)
    errs = {k: nan_and_scale(f"float64 budget {k}", got[k], want[k],
                             OFFLINE_F64_RTOL)[0] for k in want}
    log(f"  float64 compute_budget, {OFFLINE_F64_NZ} levels: kernel against "
        f"plain at most {max(errs.values()):.3e} of scale (bound "
        f"{OFFLINE_F64_RTOL})")


def offline_cli(device, state, tmp):
    """The coarsen_restarts CLI end to end, as a user runs it, in a
    process of its own: on a Fortran-layout restart directory that
    ``save_fortran_restarts`` writes of the C384 state (all 79 levels);
    returns (K5 launches, the CLI process's peak RSS in bytes)."""
    import datetime

    import torch
    from fv3net_torch.core import netcdfio
    from fv3net_torch.ops import coarsen
    from fv3net_torch.runtime.checkpoint import (load_fortran_restarts,
                                                 save_fortran_restarts)
    from fv3net_torch.runtime.derived_state import ModelState

    import fv3net_torch

    n = C384
    g = torch.Generator(device=device).manual_seed(4)

    def rand():
        return torch.rand((6, n, n), generator=g, device=device)

    surface = {"surface_temperature": 270.0 + 30.0 * rand(),
               "land_sea_mask": (rand() > 0.7).float(),
               "ice_thickness": torch.where(rand() > 0.9, 2.0 * rand(),
                                            0.0)}
    src, dst = os.path.join(tmp, "restart_c384"), os.path.join(
        tmp, "restart_c48")
    t0 = time.perf_counter()
    save_fortran_restarts(ModelState(dycore=state, surface=surface),
                          datetime.datetime(2016, 8, 1, 3), src,
                          cube_grid(n))
    t_write = time.perf_counter() - t0
    n_surface = len(netcdfio.open_netcdf(os.path.join(
        src, "sfc_data.tile1.nc")))
    code = (CLI_PRELUDE
            + "import json, resource, sys\n"
            "from fv3net_torch.ops import coarsen_cuda\n"
            "from fv3net_torch.pipelines import coarsen_restarts\n"
            "rc = coarsen_restarts.main(sys.argv[1:])\n"
            "print(json.dumps({'rc': rc, 'launches': "
            "coarsen_cuda.WAVG_LAUNCHES, 'peak_rss_kb': "
            "resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}))\n")
    tree = os.path.dirname(os.path.dirname(fv3net_torch.__file__))
    # the CLI's process needs the card's memory that this process's
    # allocator still caches from earlier phases
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [tree] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", code, src, dst, "--factor",
         str(COARSEN_FACTOR), "--method", "blended"],
        capture_output=True, text=True, env=env)
    t_cli = time.perf_counter() - t0
    check(proc.returncode == 0, f"coarsen_restarts CLI failed "
          f"({proc.returncode}): {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    cli_line, child = json.loads(lines[-2]), json.loads(lines[-1])
    check(cli_line["resolution"] == n // COARSEN_FACTOR and child["rc"] == 0,
          f"coarsen_restarts CLI printed {lines[-2:]}")
    want = offline_launches("blended", len(state.tracers)) + n_surface
    check(child["launches"] == want, f"coarsen_restarts CLI: "
          f"{child['launches']} K5 launches, expected {want} (the blend of "
          f"{len(state.tracers)} tracers and {n_surface} surface fields)")
    out, time_c = load_fortran_restarts(dst)
    check(time_c == datetime.datetime(2016, 8, 1, 3),
          f"coarsen_restarts CLI: time {time_c}")
    nc = n // COARSEN_FACTOR
    check(out.dycore.delp.shape == state.delp.shape[:2] + (nc, nc),
          f"coarsen_restarts CLI: delp {tuple(out.dycore.delp.shape)}")
    check(bool(torch.isfinite(out.dycore.delp).all()),
          "coarsen_restarts CLI: non-finite coarse delp")
    area = torch.as_tensor(cube_grid(n).area, device=device)
    fine_mass = coarsen.block_sum(state.delp.double().sum(1) * area,
                                  COARSEN_FACTOR)
    mass = column_mass_error(out.dycore.delp.to(device), fine_mass,
                             coarsen.block_sum(area, COARSEN_FACTOR))
    check(mass <= F32_SUM_RTOL, f"coarsen_restarts CLI: coarse column mass "
          f"parts from the fine by {mass:.3e}")
    log(f"  coarsen_restarts CLI (--method blended, factor "
        f"{COARSEN_FACTOR}) on a C{n} Fortran-layout restart directory of "
        f"{state.delp.shape[1]} levels, {len(state.tracers)} tracers and "
        f"{n_surface} "
        f"surface fields: written in {t_write:.1f} s; the CLI process "
        f"{t_cli:.1f} s (start, load, coarsen on the card, write), K5 "
        f"launches {child['launches']}, its peak RSS "
        f"{child['peak_rss_kb'] / 2 ** 20:.2f} GiB; column mass within "
        f"{mass:.3e}")
    return child["launches"], child["peak_rss_kb"] * 1024


def write_surface_shards(root, seed=5):
    """C384 surface diagnostics cut into subtile shards
    (``{prefix}.tile{t}.nc.{SSSS}``, float32 data) and their grid_spec
    shards (the cell areas in float64); returns the whole tiles' data and
    areas."""
    import numpy as np
    from scipy.io import netcdf_file
    from fv3net_torch.core import netcdfio
    from fv3net_torch.core.dataset import Dataset
    from fv3net_torch.core.quantity import Quantity

    rng = np.random.default_rng(seed)
    n, s = C384, SURFACE_SUBTILES
    m = n // s
    area = cube_grid(n).area
    data = {v: (1.0 + rng.random((6, SURFACE_TIMES, n, n))).astype(
        np.float32) for v in SURFACE_VARS}
    for t in range(6):
        for k in range(s * s):
            iy, ix = divmod(k, s)
            ys, xs = slice(iy * m, (iy + 1) * m), slice(ix * m, (ix + 1) * m)
            xt, yt = np.arange(ix * m, (ix + 1) * m) + 1.0, np.arange(
                iy * m, (iy + 1) * m) + 1.0
            netcdfio.write_netcdf(Dataset(
                {v: Quantity(data[v][t][:, ys, xs],
                             ("time", "grid_yt", "grid_xt"))
                 for v in SURFACE_VARS},
                coords={"grid_xt": xt, "grid_yt": yt}),
                os.path.join(root, f"gfsphysics_15min_fine.tile{t + 1}.nc."
                                   f"{k:04d}"))
            with netcdf_file(os.path.join(
                    root, f"grid_spec.tile{t + 1}.nc.{k:04d}"), "w") as f:
                f.createDimension("grid_xt", m)
                f.createDimension("grid_yt", m)
                for name, vals in (("grid_xt", xt), ("grid_yt", yt)):
                    f.createVariable(name, "d", (name,))[:] = vals
                f.createVariable("area", "d", ("grid_yt", "grid_xt"))[:] = (
                    area[t, ys, xs])
    return data, area


def offline_surface(device, tmp):
    """coarsen_surface on C384 subtile shards through the runner's
    threads: every item ok on its first attempt, one K5 launch (its
    float64 instance: float64 areas) per variable and shard, the files
    equal to the block averages in float64 rounded to float32; returns
    (launches, seconds)."""
    import numpy as np
    import torch
    from fv3net_torch.core import netcdfio
    from fv3net_torch.pipelines import coarsen_surface as cs

    src, dst = os.path.join(tmp, "surface_in"), os.path.join(
        tmp, "surface_out")
    os.makedirs(src)
    data, area = write_surface_shards(src)
    reset_counts()
    t0 = time.perf_counter()
    results = cs.coarsen_surface(src, dst, coarsening=COARSEN_FACTOR,
                                 max_workers=SURFACE_WORKERS, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    shards = 6 * SURFACE_SUBTILES ** 2
    check([(r.key, r.ok, r.attempts) for r in results]
          == [(t, True, 1) for t in range(1, 7)],
          f"coarsen_surface: items {[(r.key, r.ok, r.attempts, r.error) for r in results]}"
          " (each must be ok on its first attempt)")
    check(counts == launches(weighted_block_average=shards
                             * len(SURFACE_VARS)),
          f"coarsen_surface: launches {counts}, expected "
          f"{shards * len(SURFACE_VARS)} (a variable a shard)")
    nc = C384 // COARSEN_FACTOR
    worst = 0.0
    for v in SURFACE_VARS:
        fine = data[v].astype(np.float64)
        w = area[:, None]
        num = (fine * w).reshape(6, SURFACE_TIMES, nc, COARSEN_FACTOR, nc,
                                 COARSEN_FACTOR).sum((3, 5))
        den = np.broadcast_to(w, fine.shape).reshape(
            6, SURFACE_TIMES, nc, COARSEN_FACTOR, nc, COARSEN_FACTOR).sum(
            (3, 5))
        want = (num / den).astype(np.float32)
        for t in range(6):
            ds = netcdfio.open_netcdf(os.path.join(dst, f"C{nc}",
                                                   f"{v}.tile{t + 1}.nc"))
            got = np.asarray(ds[v].values)
            check(got.shape == (SURFACE_TIMES, nc, nc) and got.dtype
                  == np.dtype(">f4"), f"coarsen_surface {v}: {got.shape} "
                  f"{got.dtype}")  # classic NetCDF is big-endian
            rel = np.abs(got.astype(np.float64) - want[t]) / want[t]
            worst = max(worst, float(rel.max()))
    check(worst <= 2.0 ** -23, f"coarsen_surface: a value parts from the "
          f"float64 block average by {worst:.3e} relative, more than a "
          "float32 rounding")
    log(f"  coarsen_surface: {shards} C{C384} subtile shards of "
        f"{len(SURFACE_VARS)} variables x {SURFACE_TIMES} times, "
        f"{SURFACE_WORKERS} worker threads: {seconds:.2f} s (reading and "
        f"writing included), every tile ok on attempt 1, K5 launches "
        f"{counts['weighted_block_average']}, files within {worst:.2e} "
        f"relative of the float64 block average")
    return counts["weighted_block_average"], seconds


def offline_latlon(device, coarse, tmp):
    """regrid_zarr_to_latlon of the C48 coarse state to 180 x 360 on the
    card, gated by conservation (the scatter-add is atomic: its float32
    order changes from run to run); returns seconds."""
    import numpy as np
    import torch
    from fv3net_torch.core import zarrio
    from fv3net_torch.core.dataset import Dataset
    from fv3net_torch.core.quantity import Quantity
    from fv3net_torch.ops.regrid_latlon import CubeToLatLon
    from fv3net_torch.post_process import regrid_zarr_to_latlon

    nc = C384 // COARSEN_FACTOR
    nlat, nlon = LATLON
    src, dst = os.path.join(tmp, "c48.zarr"), os.path.join(tmp, "latlon.zarr")
    zarrio.to_zarr(Dataset({
        "pt": Quantity(coarse.pt.cpu().numpy(), ("tile", "z", "y", "x")),
        "phis": Quantity(coarse.phis.cpu().numpy(), ("tile", "y", "x"))}),
        src)
    t0 = time.perf_counter()
    regrid_zarr_to_latlon(src, dst, nlat, nlon, device=device)
    seconds = time.perf_counter() - t0
    out = zarrio.open_zarr(dst)
    for name, shape in (("pt", (coarse.pt.shape[1], nlat, nlon)),
                        ("phis", (nlat, nlon))):
        check(out[name].shape == shape and bool(np.isfinite(
            out[name].values).all()), f"latlon {name}: {out[name].shape}")
    regridder = CubeToLatLon(cube_grid(nc), nlat, nlon, device=device)
    area = torch.as_tensor(cube_grid(nc).area, dtype=torch.float64,
                           device=device)
    worst = 0.0
    for field in (coarse.pt.movedim(0, 1), coarse.phis[None]):
        total = regridder.conservative_sum(field).double().sum((-2, -1))
        want = (field.double() * area).sum((-3, -2, -1))
        worst = max(worst, ((total - want).abs() / want.abs()).max().item())
    check(worst <= LATLON_RTOL, f"latlon: conservative_sum parts from "
          f"sum(field * area) by {worst:.3e} > {LATLON_RTOL}")
    log(f"  regrid_zarr_to_latlon: C{nc} ({coarse.pt.shape[1]} levels and "
        f"a surface field) -> {nlat} x {nlon} on the card in {seconds:.2f} "
        f"s (store read and written); conservative_sum within {worst:.3e} "
        f"of sum(field * area) (bound {LATLON_RTOL})")
    return seconds


def phase_offline(device):
    """Phase 28: the offline ops and pipelines at C384 -> C48; returns
    the K5 launches of its paths (the float64 comparisons left out)."""
    import resource
    import tempfile

    import torch

    torch.zeros(1, device=device)  # the allocator's stats need a context
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, area = offline_state(device, torch.float32, OFFLINE_NZ)
    torch.cuda.synchronize()
    log(f"  seeded C{C384} state, {OFFLINE_NZ} levels, "
        f"{len(state.tracers)} tracers, float32, on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    launched, sigma = offline_restarts(state, area)
    launched += offline_budget(state, area)
    launched += offline_sfc_data(device, area)
    offline_float64(device)
    with tempfile.TemporaryDirectory() as tmp:
        n, rss = offline_cli(device, state, tmp)
        launched += n
        del state
        n, _ = offline_surface(device, tmp)
        launched += n
        offline_latlon(device, sigma, tmp)
    log(f"  phase 28: K5 launches on its paths {launched}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB; host peak RSS of the CLI process {rss / 2 ** 30:.2f} GiB, "
        f"of this process so far "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20:.2f}"
        " GiB")
    return launched


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

    def phase(text):
        log(f"[{time.perf_counter() - t_start:.1f} s] phase {text}")

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

    phase("2: build")
    build_kernels()
    log_plans()

    phase("3: remap kernel K1 against its plain version")
    remap_line = phase_remap_kernel(device)

    phase("4: gray main path")
    phase_gray(device)

    phase("5: RRTMG main path, LW gas optics through K4/K3 and "
        "through K2")
    paths, states = phase_rrtmg(device)
    state = states[RADIATION_STATES_AFTER[-1]]
    counts, counts_mega = paths["ktable"].counts, paths["mega"].counts
    _, sst, cosz = paths["ktable"].args
    del paths

    phase("6: one RRTMG radiation call")
    rec, k2_args, tables64 = phase_radiation(
        device, states, sst, cosz, sw_columns=opts.sw_columns, smi=smi)

    phase("6 (continued): K4/K3 of that radiation call against plain "
        "within their summation roundoff")
    phase_radiation_summation(rec)

    phase("7: k-table kernels K4 and K3 against their plain versions")
    ktable_lines = phase_ktable(rec)
    del rec, states

    phase("8: one step, kernels against plain")
    phase_step_vs_plain(device, state)

    phase("9: LW gas-optics kernel K2 against its plain version")
    taumol_line = phase_taumol(k2_args, tables64)
    del k2_args, tables64

    phase("10: block-average kernel K5 against its plain version")
    wavg_line = phase_wavg(device)

    phase("11: C384 -> C48 coarsening pipeline")
    counts_pipeline = phase_pipeline(device)

    phase("12: production main path (slab ocean, sea ice, the SST "
        "prescriber and the ML stepper around the RRTMG step)")
    phase_production(device)

    phase("13: production chunk, kernels against plain (float64)")
    phase_production_vs_plain(device)

    phase("14: production land variant (Noah soil, gravity-wave drag)")
    phase_production_land(device)

    phase("15: the segmented run (run_segment, append_segment) of the "
        "production configuration")
    phase_segmented_run(device)

    phase("16: the RRTMG options (bf16 storage with K4/K3 in bfloat16, "
        "daylight compression, lookup tables, column blocking)")
    t16 = time.perf_counter()
    bf16_lines, bf16_launches, options = phase_rrtmg_options(
        device, state, sst, cosz)
    log(f"  phase 16 in {time.perf_counter() - t16:.1f} s")

    phase("17: the dycore options on the JW06 baroclinic wave (C48)")
    t17 = time.perf_counter()
    phase_dycore_options(device)
    log(f"  phase 17 in {time.perf_counter() - t17:.1f} s")

    phase("18: K2 under bf16 storage (the mega route with the "
        "reference's accelerator radiation settings)")
    t18 = time.perf_counter()
    taumol_bf16_line, taumol_bf16_launches = phase_taumol_bf16(
        device, state, sst, cosz, options["bf16"]["profile"])
    log(f"  phase 18 in {time.perf_counter() - t18:.1f} s")

    phase("19: the FV3GFS-style C48 namelist (nonhydrostatic, GFDL "
        "microphysics, prognostic ozone, stratospheric water) through the "
        "segmented run")
    t19 = time.perf_counter()
    phase_namelist_run(device)
    log(f"  phase 19 in {time.perf_counter() - t19:.1f} s")

    phase("20: the online microphysics emulator through the segmented run")
    t20 = time.perf_counter()
    phase_emulated_run(device)
    log(f"  phase 20 in {time.perf_counter() - t20:.1f} s")

    phase("21: the Python radiation stepper in the per-step loop, and the "
          "GFS radiation chain")
    t21 = time.perf_counter()
    _, gfs_launches, f64_lines = phase_radiation_stepper(device)
    log(f"  phase 21 in {time.perf_counter() - t21:.1f} s")

    phase("22: the synthetic band radiation and Held-Suarez")
    t22 = time.perf_counter()
    phase_synthband(device)
    log(f"  phase 22 in {time.perf_counter() - t22:.1f} s")

    phase("23: the dense trainer on the card (the entries' models)")
    t23 = time.perf_counter()
    phase_trainer(device)
    log(f"  phase 23 in {time.perf_counter() - t23:.1f} s")

    phase(f"24: the sharded dry run ({DRYRUN_RANKS} ranks over gloo on "
          "the one card)")
    t24 = time.perf_counter()
    phase_sharded_dryrun(device)
    log(f"  phase 24 in {time.perf_counter() - t24:.1f} s")

    phase("25: the nudged run through the segmented run")
    t25 = time.perf_counter()
    _, ms_without = phase_nudged_run(device)
    log(f"  phase 25 in {time.perf_counter() - t25:.1f} s")

    phase("26: prescribed tendencies (the tendency prescriber, fused and "
          "per step, and bias correction)")
    t26 = time.perf_counter()
    phase_prescribed_tendencies(device)
    log(f"  phase 26 in {time.perf_counter() - t26:.1f} s")

    phase("27: the reservoir corrector (its trainers on the card, the "
          "hybrid and subdomain models through the segmented run)")
    t27 = time.perf_counter()
    phase_reservoir(device, ms_without)
    log(f"  phase 27 in {time.perf_counter() - t27:.1f} s")

    phase("28: the offline ops and pipelines at C384 -> C48 (restart "
          "coarsening on sigma, pressure and blended levels, the fine-res "
          "budget, the coarsen_restarts CLI, surface shards, lat-lon)")
    t28 = time.perf_counter()
    offline_k5 = phase_offline(device)
    log(f"  phase 28 in {time.perf_counter() - t28:.1f} s")

    # each kernel's launches come from the run of the path it lies on
    counts = dict(counts, taumol_lw=counts_mega["taumol_lw"],
                  weighted_block_average=counts_pipeline[
                      "weighted_block_average"] + offline_k5,
                  weighted_select_dot_bf16=bf16_launches[
                      "weighted_select_dot"],
                  spec_band_dot_bf16=bf16_launches["spec_band_dot"],
                  taumol_lw_bf16=taumol_bf16_launches,
                  weighted_select_dot_f64=gfs_launches[
                      "weighted_select_dot"],
                  spec_band_dot_f64=gfs_launches["spec_band_dot"])
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
        # the bfloat16 instances, their launches from phase 16's bf16
        # chunks
        "weighted_select_dot_bf16": {
            "source": "fv3net_torch/csrc/ktable.cu",
            "replaces": "fv3net_tpu/ops/pallas_ktable.py:35",
            **bf16_lines["weighted_select_dot"]},
        "spec_band_dot_bf16": {
            "source": "fv3net_torch/csrc/ktable.cu",
            "replaces": "fv3net_tpu/ops/pallas_ktable.py:97",
            **bf16_lines["spec_band_dot"]},
        # K2's bfloat16 instance, its launches from phase 18's mega-route
        # bf16 chunks
        "taumol_lw_bf16": {
            "source": "fv3net_torch/csrc/taumol_lw.cu",
            "replaces": "fv3net_tpu/physics/radiation/rrtmg/"
                        "pallas_taumol.py:73",
            **taumol_bf16_line},
        # the float64 instances, their launches from phase 21's float64
        # GFS radiation call
        "weighted_select_dot_f64": {
            "source": "fv3net_torch/csrc/ktable.cu",
            "replaces": "fv3net_tpu/ops/pallas_ktable.py:35",
            **f64_lines["weighted_select_dot"]},
        "spec_band_dot_f64": {
            "source": "fv3net_torch/csrc/ktable.cu",
            "replaces": "fv3net_tpu/ops/pallas_ktable.py:97",
            **f64_lines["spec_band_dot"]},
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
