#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fv3net_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, and no result line is printed):

1. device: a CUDA card is required (there is no CPU path); prints the
   card's name and power limit and the torch / CUDA versions;
2. build: compiles the remap kernel ``fv3net_torch/csrc/remap_apply.cu``
   for sm_90a from this checkout;
3. kernel: the remap kernel against its plain PyTorch version on the card
   at the flagship's shapes (C48, npz=32, F = 1, 2, 3 fields; float32 and
   float64), with times (median of CUDA-event timings);
4. main path: ``fv3net_torch.entry.flagship()`` -- C48, npz=32, gray
   radiation every 4th step, dense ML 2x128, 8-step chunks, float32 on
   cuda:0 -- one warm-up chunk and 3 timed chunks: ms per chunk, SYPD,
   finite fields, air-mass drift, and the kernel's launch count (3 remaps
   per dycore step); then one more chunk under ``torch.profiler``, whose
   device time by op is printed;
5. the same state through one step with the kernel and with the plain
   version: the float32 dynamics step and the float64 fused step within
   1e-5 of each field's scale (the float32 fused step is logged only).

The line before the last is the card's ``nvidia-smi`` name and power
limit; the last line is ``{"ok": true, "device": {...}}``.  The script
imports nothing of jax or of ``fv3net_tpu``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

NPX, NPZ = 48, 32  # the flagship's C48 cube and levels
DT = 900.0  # s, the flagship's dynamics interval
CHUNK = 8  # steps per chunk
TIMED_CHUNKS = 3  # after one warm-up chunk
REMAPS_PER_STEP = 3  # winds, tracers, total energy (dycore/core.py)
F32_RTOL = 1e-5  # float32: summation order of the prefix and band sums
F64_RTOL = 1e-12


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


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings
    (after 3 warm-up calls)."""
    import torch

    for _ in range(3):
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


def phase_kernel(device, reps=30):
    """K1 against its plain version; returns the kernel-line numbers."""
    import torch
    from fv3net_torch.ops import remap as rm
    from fv3net_torch.ops import remap_cuda

    worst = 0.0
    timing = {}
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
            # interleaved timings of the two versions
            ms_plain = cuda_ms(plain, reps)
            ms_kernel = cuda_ms(kernel, reps)
            ms_plain2 = cuda_ms(plain, reps)
            ms_kernel2 = cuda_ms(kernel, reps)
            kms = min(ms_kernel, ms_kernel2)
            pms = min(ms_plain, ms_plain2)
            name = str(dtype).replace("torch.", "")
            log(f"  K1 {name} F={F}: max|diff| {err:.3e} (scale {scale:.3e},"
                f" rtol {rtol}), column-mass rel err {cons:.3e}; kernel "
                f"{ms_kernel:.4f}/{ms_kernel2:.4f} ms, plain "
                f"{ms_plain:.4f}/{ms_plain2:.4f} ms (median of {reps})")
            if dtype == torch.float32:
                worst = max(worst, err)
            timing[(name, F)] = (kms, pms)
    kms, pms = timing[("float32", 3)]
    return {"max_abs_err": worst, "ms": kms, "plain_ms": pms}


def air_mass(state, area):
    import torch

    return (state.delp.to(torch.float64).sum(dim=1)
            * area.to(torch.float64)).sum().item()


def fields(state):
    out = {"delp": state.delp, "pt": state.pt, "wind": state.wind}
    out.update(state.tracers)
    return out


def phase_main_path(device):
    """Drive the flagship chunk; returns (kernel launches, final state)."""
    import torch
    from fv3net_torch import entry
    from fv3net_torch.ops import remap_cuda

    t0 = time.perf_counter()
    step, (state, ml_params, sst, cosz) = entry.flagship(
        npx=NPX, npz=NPZ, chunk=CHUNK, device=device
    )
    area = torch.tensor(entry.make_grid(NPX).area, device=device)
    log(f"  built the flagship chunk in {time.perf_counter() - t0:.2f} s")

    per_chunk = CHUNK * REMAPS_PER_STEP
    remap_cuda.LAUNCHES = 0
    wall = []
    for i in range(1 + TIMED_CHUNKS):
        m0 = air_mass(state, area)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(state, ml_params, sst, cosz)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = remap_cuda.LAUNCHES
        check(launches == per_chunk * (i + 1),
              f"chunk {i}: {launches} kernel launches, expected "
              f"{per_chunk * (i + 1)}")
        for name, x in fields(state).items():
            check(torch.isfinite(x).all().item(),
                  f"chunk {i}: non-finite {name}")
        drift = abs(air_mass(state, area) - m0) / m0
        check(drift <= 1e-5, f"chunk {i}: air-mass drift {drift:.3e} > 1e-5")
        log(f"  chunk {i} ({'warm-up' if i == 0 else 'timed'}): "
            f"{dt * 1e3:.1f} ms, air-mass drift {drift:.3e}, kernel "
            f"launches so far {launches}")
        if i:
            wall.append(dt)
    launches = remap_cuda.LAUNCHES
    ms = statistics.median(wall) * 1e3
    sypd = (CHUNK * DT / (ms / 1e3)) / 365.0
    log(f"  main path: {ms:.1f} ms per {CHUNK}-step chunk (median of "
        f"{TIMED_CHUNKS}), {sypd:.3f} SYPD; {launches} kernel launches in "
        f"{1 + TIMED_CHUNKS} chunks ({per_chunk} per chunk)")

    profile_chunk(step, state, ml_params, sst, cosz)
    return launches, state


def profile_chunk(step, state, ml_params, sst, cosz):
    """One chunk under torch.profiler: the device's busy share of the wall
    time, the device activities it launched and the device time by op."""
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
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device activities (kernels, copies) are the events without CPU time
    device = [e for e in events
              if getattr(e, key) > 0 and e.self_cpu_time_total == 0]
    device_us = sum(getattr(e, key) for e in device)
    remap_us = sum(getattr(e, key) for e in device
                   if "remap_apply_kernel" in e.key)
    n_kernels = sum(e.count for e in device)
    log(f"  profile (one chunk, profiler on): wall {wall_us / 1e3:.1f} ms, "
        f"device busy {device_us / 1e3:.1f} ms "
        f"({100 * device_us / wall_us:.1f}%), {n_kernels} device "
        f"activities, remap kernel {remap_us / 1e3:.3f} ms")
    for line in events.table(sort_by=key, row_limit=15).splitlines():
        log(f"  | {line}")


def _diffs(got, want, label, rtol):
    """Log each field's max |got - want| against its scale; returns the
    fields beyond ``rtol`` of their scale."""
    bad = []
    got, want = fields(got), fields(want)
    for name in ("pt", "delp", "wind", "sphum"):
        err = (got[name] - want[name]).abs().max().item()
        scale = want[name].abs().max().item()
        log(f"  {label} {name}: max|kernel-plain| {err:.3e} (scale "
            f"{scale:.3e}, rel {err / scale:.3e})")
        if rtol is not None and err > rtol * scale:
            bad.append(f"{name} rel {err / scale:.3e}")
    return bad


def phase_step_vs_plain(device, state):
    """The same state through one fused step with the kernel and with the
    plain version.

    Gated at 1e-5 of each field's scale: the float32 dynamics step (the
    part of the step that calls the kernel) and the full fused step in
    float64.  The float32 full step is logged only: its column physics
    (near-surface humidity, convection triggers) amplifies roundoff-level
    differences past 1e-5 (see PERF.md).
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

    for dtype, rtol in ((torch.float32, None), (torch.float64, F32_RTOL)):
        s = DycoreState(
            delp=state.delp.to(dtype), pt=state.pt.to(dtype),
            wind=state.wind.to(dtype),
            tracers={k: v.to(dtype) for k, v in state.tracers.items()},
            phis=state.phis.to(dtype),
        )
        out = {}
        for impl in ("cuda", "torch"):
            step, (_, mlp, sst, cosz) = entry.flagship(
                npx=NPX, npz=NPZ, chunk=None, device=device, dtype=dtype,
                impl=impl,
            )
            out[impl] = step(s, mlp, sst, cosz)
        name = str(dtype).replace("torch.", "")
        bad += _diffs(out["cuda"], out["torch"], f"{name} fused step", rtol)
    check(not bad, f"kernel and plain paths part beyond {F32_RTOL}: {bad}")


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
        from fv3net_torch.ops import remap_cuda
    except ImportError as e:
        raise SmokeFailure(f"fv3net_torch is not beside this script: {e}")
    device = torch.device("cuda:0")

    log("phase 2: build")
    info = remap_cuda.build()
    log(f"  built {info.path.name} in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  nvcc: {line.strip()}")

    log("phase 3: remap kernel against its plain version")
    kernel = phase_kernel(device)

    log("phase 4: main path")
    launches, state = phase_main_path(device)

    log("phase 5: one fused step, kernel against plain")
    phase_step_vs_plain(device, state)

    line = {"kernels": [{
        "name": "remap_apply",
        "route": "cuda",
        "source": "fv3net_torch/csrc/remap_apply.cu",
        "replaces": "fv3net_tpu/ops/pallas_remap.py:58",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}
    for value in line["kernels"][0].values():
        check(not isinstance(value, float) or math.isfinite(value),
              "non-finite number in the kernel line")
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
