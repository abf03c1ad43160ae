#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fv3net_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, and no result line is printed):

1. device: a CUDA card is required (there is no CPU path); prints the
   card's name and power limit and the torch / CUDA versions;
2. build: compiles the port's two CUDA sources for sm_90a from this
   checkout, one ``nvcc`` each, both at once: ``remap_apply.cu`` (K1) and
   ``ktable.cu`` (K4 and K3), with nvcc's register and spill lines;
3. K1 against its plain PyTorch version on the card at the flagship's
   shapes (C48, npz=32, F = 1, 2, 3 fields; float32 and float64), with
   times (median of CUDA-event timings);
4. gray main path: ``entry.flagship(radiation="gray")`` -- C48, npz=32,
   float32 on cuda:0 -- one warm-up and one timed 8-step chunk, with its
   K1 launch count;
5. RRTMG main path: ``entry.flagship()`` (RRTMG LW+SW every 4th step,
   dense ML 2x128, 8-step chunks, float32) -- one warm-up chunk and 3
   timed chunks: ms per chunk, SYPD, finite fields, air-mass drift and
   the exact launch counts of K1, K4 and K3 per chunk; then one chunk
   under ``torch.profiler`` with its device time split by the step's
   ranges (dynamics, radiation, physics, ml);
6. one RRTMG radiation call alone on the chunk's final state: its time,
   OLR and the SW fluxes (the down-flux at the top from the driver
   itself) inside physical ranges, and the same call with the plain
   versions (heating and fluxes within stated bounds), beside two
   controls (the plain call in float64, and with bfloat16 tables);
7. K4 and K3 against their plain versions on every call that radiation
   call made, then, on four of its calls (K4 on ``selfref_all`` and
   ``mtab_lo1``, K3 on an LW lower and an SW upper band), float32 and
   float64 times of the kernel, the plain version and
   ``torch.nn.functional.embedding_bag`` (the library-call yardstick,
   never used by the port), with the bytes each call must move;
8. the same state through one step with the kernels and with the plain
   versions: the float32 dynamics step and the float64 gray step within
   1e-5, the float64 RRTMG step (radiation in float64) within 1e-10 of
   each field's scale (the float32 RRTMG step is logged only).

The line before the last two is the ``kernels`` JSON line; then the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of jax or
of ``fv3net_tpu``.
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
RRTMG_TIMED_CHUNKS = 3
REMAPS_PER_STEP = 3  # winds, tracers, total energy (dycore/core.py)
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
F32_RTOL = 1e-5  # float32: summation order of the prefix and band sums
F64_RTOL = 1e-12
KTABLE_RTOL = {"float32": 2e-6, "float64": 1e-13}  # summation order only
RRTMG_STEP_RTOL = 1e-10  # float64 RRTMG step, kernels against plain
# float32 radiation call, kernels against plain: set from the readings
# on an H100 (max 1.348e-2 K/day of SW heating, in the top layer, and
# 1.025e-2 W/m2 of surface SW down-flux), with headroom for another
# build.  Phase 6 logs two controls beside them: plain float32 against
# plain float64 read larger in every quantity there (7.4e-2 K/day,
# 6.8e-2 W/m2), so the kernels part by less than float32 itself errs;
# plain with bfloat16 tables exceeds both bounds in heating and in the
# LW fluxes, so the gate catches a table-precision fault
RAD_F32_HEATING_K_DAY = 2e-2
RAD_F32_FLUX_W_M2 = 2e-2
RANGES = ("dynamics", "radiation", "physics", "ml")  # runtime/fused.py
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, dtype_name):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_kernels():
    """Both CUDA sources, one nvcc each, started together."""
    from fv3net_torch.ops import ktable_cuda, remap_cuda

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {m.SOURCE: pool.submit(m.build)
                   for m in (remap_cuda, ktable_cuda)}
        for source, fut in futures.items():
            info = fut.result()
            log(f"  built {info.path.name} from {source} in "
                f"{info.seconds:.2f} s")
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"  nvcc: {line.strip()}")


def flagship_edges(device, dtype, seed=0):
    """pe1 / pe2 [6, 48, 48, 33]: the C48, npz=32 hybrid coordinate over a
    varying surface pressure (pe2) and a Lagrangian perturbation of its
    interior edges by 0.3 layer thicknesses times a normal draw clipped to
    +-2.5, which keeps them inside the column (pe1)."""
    import numpy as np
    import torch
    from fv3net_torch.dycore.vertical import hybrid_coordinate
    from fv3net_torch.grid.geometry import make_grid

    rng = np.random.RandomState(seed)
    grid = make_grid(NPX)
    ak, bk = hybrid_coordinate(NPZ)
    ps = 1.0e5 + 1500.0 * np.cos(2 * grid.lat) * np.sin(grid.lon)
    pe2 = ak + bk * ps[..., None]
    pe1 = pe2.copy()
    pe1[..., 1:-1] += (
        0.3 * np.diff(pe2, axis=-1)[..., :-1] * np.clip(rng.randn(*ps.shape, NPZ - 1), -2.5, 2.5)
    )
    pe1.sort(-1)

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)

    return t(pe1), t(pe2), rng


def phase_remap_kernel(device, reps=30):
    """K1 against its plain version; returns its kernel-line numbers."""
    import torch
    from fv3net_torch.ops import remap as rm
    from fv3net_torch.ops import remap_cuda

    worst = 0.0
    line = {}
    for dtype, rtol in ((torch.float32, F32_RTOL), (torch.float64, F64_RTOL)):
        pe1, pe2, rng = flagship_edges(device, dtype)
        search = rm.banded_search(pe1, pe2, window=2)
        dp1 = search["dp1"]
        dp2 = pe2[..., 1:] - pe2[..., :-1]
        for F in (1, 2, 3):
            q = torch.tensor(250.0 + 30.0 * rng.rand(F, 6, NPX, NPX, NPZ),
                             dtype=dtype, device=device)
            al, ar, a6 = rm.cs_profile(q, dp1, 1, 9)

            def kernel():
                return remap_cuda.remap_apply_cuda(search, q, al, ar, a6)

            def plain():
                return rm.remap_apply_plain(search, q, al, ar, a6)

            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            check(torch.isfinite(got).all().item(), f"K1 F={F} {dtype}: "
                  "non-finite output")
            check(err <= rtol * scale,
                  f"K1 F={F} {dtype}: max|kernel-plain| {err} > "
                  f"{rtol} * {scale}")
            m1 = (q * dp1).sum(-1)
            m2 = (got * dp2).sum(-1)
            cons = ((m2 - m1).abs() / m1.abs()).max().item()
            check(cons <= rtol, f"K1 F={F} {dtype}: column mass rel "
                  f"error {cons} > {rtol}")
            ms = interleaved_ms({"plain": plain, "kernel": kernel}, reps)
            name = str(dtype).replace("torch.", "")
            # each input read once, the output written once
            moved = nbytes(q, al, ar, a6, dp1, search["w"], search["p"],
                           search["pe1"], search["pe2"], got)
            log(f"  K1 {name} F={F}: max|diff| {err:.3e} (scale "
                f"{scale:.3e}, rtol {rtol}), column-mass rel err "
                f"{cons:.3e}; kernel {ms['kernel']:.4f} ms, plain "
                f"{ms['plain']:.4f} ms (median of {reps}, lower of two); "
                f"{moved} bytes moved")
            if dtype == torch.float32:
                worst = max(worst, err)
            if dtype == torch.float32 and F == 3:
                # work is data-independent: ~60 flops per output value
                bound_ms, by = bound(moved, 60 * got.numel(), name)
                line = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                        "bound_ms": bound_ms, "bound_by": by}
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


def reset_counts():
    from fv3net_torch.ops import ktable_cuda, remap_cuda

    remap_cuda.LAUNCHES = 0
    ktable_cuda.SELECT_LAUNCHES = 0
    ktable_cuda.SPEC_LAUNCHES = 0


def read_counts():
    from fv3net_torch.ops import ktable_cuda, remap_cuda

    return {"remap_apply": remap_cuda.LAUNCHES,
            "weighted_select_dot": ktable_cuda.SELECT_LAUNCHES,
            "spec_band_dot": ktable_cuda.SPEC_LAUNCHES}


def drive_chunks(label, step, state, args, area, timed, per_chunk):
    """One warm-up and ``timed`` chunks from counts reset to 0; gates the
    counts after each chunk against ``per_chunk``.  Returns (final state,
    counts, median ms per chunk)."""
    import torch

    reset_counts()
    wall = []
    for i in range(1 + timed):
        m0 = air_mass(state, area)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(state, *args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        want = {k: v * (i + 1) for k, v in per_chunk.items()}
        check(counts == want, f"{label} chunk {i}: launches {counts}, "
              f"expected {want}")
        for name, x in fields(state).items():
            check(torch.isfinite(x).all().item(),
                  f"{label} chunk {i}: non-finite {name}")
        drift = abs(air_mass(state, area) - m0) / m0
        check(drift <= 1e-5, f"{label} chunk {i}: air-mass drift "
              f"{drift:.3e} > 1e-5")
        log(f"  {label} chunk {i} ({'warm-up' if i == 0 else 'timed'}): "
            f"{dt * 1e3:.1f} ms, air-mass drift {drift:.3e}, launches so "
            f"far {counts}")
        if i:
            wall.append(dt)
    counts = read_counts()
    ms = statistics.median(wall) * 1e3
    sypd = (CHUNK * DT / (ms / 1e3)) / 365.0
    log(f"  {label} main path: {ms:.1f} ms per {CHUNK}-step chunk (median "
        f"of {timed}), {sypd:.3f} SYPD; launches in {1 + timed} chunks "
        f"{counts}")
    return state, counts, ms


def phase_gray(device):
    import torch
    from fv3net_torch import entry

    step, (state, ml_params, sst, cosz) = entry.flagship(
        npx=NPX, npz=NPZ, radiation="gray", chunk=CHUNK, device=device)
    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    per_chunk = {"remap_apply": CHUNK * REMAPS_PER_STEP,
                 "weighted_select_dot": 0, "spec_band_dot": 0}
    _, counts, _ = drive_chunks("gray", step, state, (ml_params, sst, cosz),
                                area, GRAY_TIMED_CHUNKS, per_chunk)
    check(counts["remap_apply"] > 0, "gray path: K1 never launched")


def phase_rrtmg(device):
    """The RRTMG main path; returns (counts, final state, its inputs)."""
    import torch
    from fv3net_torch import entry

    t0 = time.perf_counter()
    step, (state, ml_params, sst, cosz) = entry.flagship(
        npx=NPX, npz=NPZ, chunk=CHUNK, device=device)
    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    log(f"  built the RRTMG flagship chunk in {time.perf_counter() - t0:.2f}"
        " s")
    calls = RADIATION_CALLS_PER_CHUNK
    per_chunk = {"remap_apply": CHUNK * REMAPS_PER_STEP,
                 "weighted_select_dot": calls * SELECT_PER_CALL,
                 "spec_band_dot": calls * SPEC_PER_CALL}
    state, counts, _ = drive_chunks("rrtmg", step, state,
                                    (ml_params, sst, cosz), area,
                                    RRTMG_TIMED_CHUNKS, per_chunk)
    for name, n in counts.items():
        check(n > 0, f"rrtmg path: {name} never launched")
    profile_chunk(step, state, ml_params, sst, cosz)
    return counts, state, (sst, cosz)


def profile_chunk(step, state, ml_params, sst, cosz):
    """One chunk under torch.profiler: the device's busy share of the
    wall time, the device time of each of the step's ranges and the
    device time by op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, ml_params, sst, cosz)
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
    log(f"  profile (one rrtmg chunk, profiler on): wall "
        f"{wall_us / 1e3:.1f} ms, device busy {device_us / 1e3:.1f} ms "
        f"({100 * device_us / wall_us:.1f}%), {n_kernels} device "
        f"activities")
    host = {e.key: e for e in events
            if e.key in RANGES and e.cpu_time_total > 0}
    span = {e.key: e for e in events
            if e.key in RANGES and e.cpu_time_total == 0}
    for name in RANGES:
        if name not in host:
            continue
        e = host[name]
        busy = getattr(e, key)  # the kernels launched inside the range
        span_us = getattr(span[name], key) if name in span else float("nan")
        log(f"  range {name}: {e.count} calls, host "
            f"{e.cpu_time_total / 1e3:.1f} ms, device busy "
            f"{busy / 1e3:.1f} ms ({100 * busy / max(device_us, 1e-9):.1f}% "
            f"of device busy), device span {span_us / 1e3:.1f} ms")
    for e in device:
        for kname in ("remap_apply_kernel", "weighted_select_kernel",
                      "spec_band_kernel"):
            if kname in e.key:
                log(f"  kernel {kname}: {e.count} launches, "
                    f"{getattr(e, self_key) / 1e3:.3f} ms")
    for line in events.table(sort_by=self_key, row_limit=15).splitlines():
        log(f"  | {line}")


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
    """Wraps the K4/K3 wrappers to keep the arguments of every call."""

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


def phase_radiation(device, state, sst, cosz):
    """One RRTMG call alone; returns the recorded K4/K3 calls."""
    import datetime

    import torch
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.physics import PhysicsConfig
    from fv3net_torch.physics.radiation.rrtmg import params as P
    from fv3net_torch.physics.radiation.rrtmg.driver import (
        RRTMGConfig,
        RRTMGDriver,
    )
    from fv3net_torch.runtime import fused

    lat = torch.tensor(make_grid(NPX).lat, dtype=torch.float32,
                       device=device)
    cfg = PhysicsConfig(radiation_scheme="rrtmg")
    rad = fused._build_radiation_fn(cfg, device, torch.float32)
    rad_plain = fused._build_radiation_fn(cfg, device, torch.float32,
                                          impl="torch")
    args = radiation_inputs(state, sst, cosz, lat)

    reset_counts()
    with Recorder() as rec:
        heating, diags = rad(*args)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == {"remap_apply": 0,
                     "weighted_select_dot": SELECT_PER_CALL,
                     "spec_band_dot": SPEC_PER_CALL},
          f"one radiation call: launches {counts}")
    check(torch.isfinite(heating).all().item(), "non-finite heating")
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
                         "plain": lambda: rad_plain(*args)}, 3, warmup=1)
    log(f"  one RRTMG call (C48, npz=32, float32): {ms['kernels']:.1f} ms "
        f"with the kernels, {ms['plain']:.1f} ms with the plain versions "
        "(median of 3, lower of two)")

    # the same columns through the driver with the kernels, with the
    # plain versions, and two controls, both with the plain versions and
    # the same McICA draws: in float64 (what float32 roundoff itself
    # moves) and with every selection reading its table rounded to
    # bfloat16 (a precision fault the gate must catch)
    rcfg = RRTMGConfig(solcon=1368.22 * cfg.solcon_scale)
    drivers = {
        "kernels": RRTMGDriver(rcfg, device=device),
        "plain": RRTMGDriver(rcfg, device=device, impl="torch"),
        "float64": RRTMGDriver(rcfg, dtype=torch.float64, device=device,
                               impl="torch"),
    }
    draws = drivers["kernels"].draw_mcica
    drivers["float64"].draw_mcica = lambda fold, ncol, nz: tuple(
        x.double() for x in draws(fold, ncol, nz))
    T, delp, q, qc = args[:4]
    inputs = {
        "air_temperature": T,
        "pressure_thickness_of_atmospheric_layer": delp,
        "specific_humidity": q,
        "cloud_water_mixing_ratio": qc,
        "surface_temperature": sst,
        "latitude": lat,
        "longitude": torch.zeros_like(lat),
    }
    when = datetime.datetime(2016, 7, 1)
    out = {name: d(when, inputs, cosz=cosz) for name, d in drivers.items()}
    with BFloat16Tables():
        out["bfloat16 tables"] = drivers["plain"](when, inputs, cosz=cosz)

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

    def dmax(a, b):
        return (a.double() - b.double()).abs().max().item()

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
             for name in ("kernels", "float64", "bfloat16 tables")}
        log(f"  float32 {label}: kernels against plain {d['kernels']:.3e} "
            f"{unit} (bound {limit}); controls, plain float32 against "
            f"float64 {d['float64']:.3e}, against bfloat16 tables "
            f"{d['bfloat16 tables']:.3e}")
        if not d["kernels"] <= limit:
            bad.append(f"{label} {d['kernels']} {unit}")

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
    ulp = torch.finfo(torch.float32).eps * f_top
    log(f"  largest heating difference at column {at[0]}, level {at[1]} of "
        f"{NPZ} (0 = top), dp {dp_mb:.4f} mb: a flux-divergence difference "
        f"of {d_flux:.3e} W/m2, {d_flux / ulp:.1f} float32 ulps of the "
        f"column's {f_top:.2f} W/m2 at the top")
    check(not bad, f"kernels and plain versions part: {bad}")
    return rec


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


def _select_plain(ids, w, tab):
    from fv3net_torch.ops import ktable

    return ktable.weighted_select_dot_plain(
        [(ids[k], w[k]) for k in range(ids.shape[0])], tab)


def _spec_plain(wids, ww, sids, sw, tab, n_paths, nspa):
    from fv3net_torch.ops import ktable

    kw, st = wids.shape[0] // n_paths, sids.shape[0] // n_paths
    w_paths = [[(wids[p * kw + k], ww[p * kw + k]) for k in range(kw)]
               for p in range(n_paths)]
    s_paths = [[(sids[p * st + s], sw[p * st + s]) for s in range(st)]
               for p in range(n_paths)]
    return ktable.spec_band_dot_plain(w_paths, s_paths, tab, nspa)


def _embedding_bag_select(ids, w, tab):
    """K4 as one library call: bags of the K rows of each point."""
    import torch.nn.functional as F

    idx, psw = ids.T.contiguous(), w.T.contiguous()
    return lambda: F.embedding_bag(idx, tab, per_sample_weights=psw,
                                   mode="sum")


def _embedding_bag_spec(wids, ww, sids, sw, tab, n_paths, nspa):
    """K3 as one library call over the [nbase*nspa, ng] view: index
    row*nspa + pos, weight ww*sw, for every (path, stencil, base) term."""
    import torch
    import torch.nn.functional as F

    kw, st = wids.shape[0] // n_paths, sids.shape[0] // n_paths
    nbase = tab.shape[0]
    idx, wts = [], []
    for p in range(n_paths):
        for s in range(st):
            pos = sids[p * st + s].long().clamp(0, nspa - 1)
            for k in range(kw):
                row = wids[p * kw + k].long().clamp(0, nbase - 1)
                idx.append(row * nspa + pos)
                wts.append(ww[p * kw + k] * sw[p * st + s])
    idx = torch.stack(idx, 1).contiguous()
    wts = torch.stack(wts, 1).contiguous()
    view = tab.reshape(nbase * nspa, tab.shape[1] // nspa)
    return lambda: F.embedding_bag(idx, view, per_sample_weights=wts,
                                   mode="sum")


def phase_ktable(rec, reps=20):
    """K4 and K3 against their plain versions on every recorded call, and
    timings on four of them.  Returns the two kernel lines' numbers."""
    import torch
    from fv3net_torch.ops import ktable_cuda

    worst = {"weighted_select_dot": 0.0, "spec_band_dot": 0.0}
    for name, calls, plain in (
            ("weighted_select_dot", rec.select, _select_plain),
            ("spec_band_dot", rec.spec, _spec_plain)):
        for i, (a, out) in enumerate(calls):
            err, scale = max_diff(out, plain(*a), f"{name} call {i}")
            check(err <= KTABLE_RTOL["float32"] * scale,
                  f"{name} call {i} (tab {tuple(a[2 if len(a) == 3 else 4].shape)}):"
                  f" max|kernel-plain| {err} > {KTABLE_RTOL['float32']} * "
                  f"{scale}")
            worst[name] = max(worst[name], err)
        log(f"  {name}: {len(calls)} calls of one radiation call, kernel "
            f"against plain within {worst[name]:.3e} (float32)")

    def pick_select(shape):
        for a, _ in rec.select:
            if tuple(a[2].shape) == shape:
                return a
        raise SmokeFailure(f"no K4 call on a {shape} table")

    def pick_spec(shape, n_paths):
        for a, _ in rec.spec:
            if tuple(a[4].shape) == shape and a[5] == n_paths:
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
            a_dt = tuple(x.to(dtype) if torch.is_tensor(x)
                         and x.is_floating_point() else x for x in a)
            if name == "weighted_select_dot":
                ids, w, tab = a_dt
                kernel = ktable_cuda.weighted_select_dot_cuda

                def plain(a=a_dt):
                    return _select_plain(*a)

                lib = _embedding_bag_select(ids, w, tab)
                K, N = ids.shape
                flops = 2 * K * N * tab.shape[1]
            else:
                wids, ww, sids, sw, tab, n_paths, nspa = a_dt
                kernel = ktable_cuda.spec_band_dot_cuda

                def plain(a=a_dt):
                    return _spec_plain(*a)

                lib = _embedding_bag_spec(*a_dt)
                kw, st = wids.shape[0] // n_paths, sids.shape[0] // n_paths
                N, ng = wids.shape[1], tab.shape[1] // nspa
                flops = N * ng * n_paths * st * (2 * kw + 2)
            before = read_counts()
            got = kernel(*a_dt)
            torch.cuda.synchronize()
            want = plain()
            err, scale = max_diff(got, want, f"{name} {label} {dname}")
            rtol = KTABLE_RTOL[dname]
            check(err <= rtol * scale, f"{name} {label} {dname}: "
                  f"max|kernel-plain| {err} > {rtol} * {scale}")
            lib_err = max_diff(lib(), want, f"embedding_bag {label}")[0]
            ms = interleaved_ms({"plain": plain,
                                 "kernel": lambda: kernel(*a_dt),
                                 "library": lib}, reps)
            check(read_counts() != before, f"{name} did not launch")
            moved = nbytes(*[x for x in a_dt if torch.is_tensor(x)], got)
            bound_ms, by = bound(moved, flops, dname)
            log(f"  {name} {label} {dname}: N={got.shape[0]}, out "
                f"{tuple(got.shape)}; max|diff| {err:.3e} (scale "
                f"{scale:.3e}, rtol {rtol}); embedding_bag max|diff| "
                f"{lib_err:.3e}; kernel {ms['kernel']:.4f} ms, plain "
                f"{ms['plain']:.4f} ms, embedding_bag {ms['library']:.4f} "
                f"ms (median of {reps}, lower of two); {moved} bytes "
                f"moved, {flops} flops, bound {bound_ms:.4f} ms ({by})")
            # the kernel line reads the float32 call of the largest
            # output of each kernel on the main path
            if dtype == torch.float32 and label.startswith(
                    ("mtab_lo1", "LW band 3")):
                lines[name] = {"max_abs_err": worst[name],
                               "ms": ms["kernel"], "plain_ms": ms["plain"],
                               "bound_ms": bound_ms, "bound_by": by,
                               "library_ms": ms["library"]}
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
    float64 RRTMG step (radiation in float64) within 1e-10.  The float32
    RRTMG step is logged only: its column physics (near-surface humidity,
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

    cases = (("gray", torch.float64, F32_RTOL),
             ("rrtmg", torch.float32, None),
             ("rrtmg", torch.float64, RRTMG_STEP_RTOL))
    for radiation, dtype, rtol in cases:
        s = DycoreState(
            delp=state.delp.to(dtype), pt=state.pt.to(dtype),
            wind=state.wind.to(dtype),
            tracers={k: v.to(dtype) for k, v in state.tracers.items()},
            phis=state.phis.to(dtype),
        )
        out = {}
        name = str(dtype).replace("torch.", "")
        for impl in ("cuda", "torch"):
            reset_counts()
            step, (_, mlp, sst, cosz) = entry.flagship(
                npx=NPX, npz=NPZ, radiation=radiation, chunk=None,
                device=device, dtype=dtype, impl=impl,
            )
            out[impl] = step(s, mlp, sst, cosz)
            torch.cuda.synchronize()
            counts = read_counts()
            if impl == "torch":
                check(not any(counts.values()), f"plain {name} {radiation} "
                      f"step launched kernels: {counts}")
            else:
                rrtmg = radiation == "rrtmg"
                want = {"remap_apply": REMAPS_PER_STEP,
                        "weighted_select_dot": SELECT_PER_CALL * rrtmg,
                        "spec_band_dot": SPEC_PER_CALL * rrtmg}
                check(counts == want, f"{name} {radiation} step: launches "
                      f"{counts}, expected {want}")
        bad += _diffs(out["cuda"], out["torch"], f"{name} {radiation} step",
                      rtol)
    check(not bad, f"kernel and plain paths part: {bad}")


def main():
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
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import fv3net_torch.entry  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"fv3net_torch is not beside this script: {e}")
    device = torch.device(DEVICE)
    t_start = time.perf_counter()

    log("phase 2: build")
    build_kernels()

    log("phase 3: remap kernel K1 against its plain version")
    remap_line = phase_remap_kernel(device)

    log("phase 4: gray main path")
    phase_gray(device)

    log("phase 5: RRTMG main path")
    counts, state, (sst, cosz) = phase_rrtmg(device)

    log("phase 6: one RRTMG radiation call")
    rec = phase_radiation(device, state, sst, cosz)

    log("phase 7: k-table kernels K4 and K3 against their plain versions")
    ktable_lines = phase_ktable(rec)
    del rec

    log("phase 8: one step, kernels against plain")
    phase_step_vs_plain(device, state)

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
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": v["source"],
         "replaces": v["replaces"], "launches": counts[name],
         "max_abs_err": v["max_abs_err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
         "bound_by": v["bound_by"], "library_ms": v["library_ms"]}
        for name, v in common.items()
    ]}
    for k in line["kernels"]:
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
