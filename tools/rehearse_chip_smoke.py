"""Rehearse a phase of ``chip_smoke.py`` on the CPU at a small size, with
no card, before a run on the H100.

    python tools/rehearse_chip_smoke.py 34   # the optax tail, full width
    python tools/rehearse_chip_smoke.py 33   # the entry points, C6
    python tools/rehearse_chip_smoke.py 32   # the diagnostics, C6
    python tools/rehearse_chip_smoke.py 31   # the scikit-learn models, C6
    python tools/rehearse_chip_smoke.py 30   # the ML library's rest, C6
    python tools/rehearse_chip_smoke.py 29   # the ML loop, C6, npz=8
    python tools/rehearse_chip_smoke.py 28   # the offline ops, C32 -> C4

Each CUDA kernel wrapper on the phase's path is replaced by its plain
version that bumps the wrapper's launch count, the dispatchers pick the
kernel where they would on the card, the entry points' default device is
the CPU, the ``torch.cuda`` calls that need a card do nothing, and the
CLI processes the phase starts get the same replacements through
``chip_smoke.CLI_PRELUDE`` plus ``--device cpu``.  Sizes: ``NPX`` and
``NPZ`` (phases 29 and 30), ``N`` and ``NZ`` (phase 28) in the
environment; phase 30 runs phases 27 and 29 first for its data, phase
31 phase 29, phase 32 phases 20, 27 and 29 (its CLIs called with
``--device cpu``); phase 33 runs the SCREAM case at ne3pg2 (C6) on
``NPZ`` levels and its templates' subprocesses with ``device`` cpu;
phase 34 runs at the card's full width, the CPU standing in for the card
(its float64 gates then compare the CPU with itself);
``KEEP=1`` keeps the phase's temporary directory.  ``UNCLAMPED=1``
(phase 29) trains the dense models without ``ML_OUTPUT_LIMITS`` and
prints the largest temperature tendency of each online prediction, in K
a step.  Its numbers are not the card's: it checks that the phase runs
and that its gates hold.
"""
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

KERNELS_29 = """
from fv3net_torch.ops import ktable, ktable_cuda, remap, remap_cuda


def fake_remap(search, q1, al, ar, a6):
    remap_cuda.LAUNCHES += 1
    return remap.remap_apply_plain(search, q1, al, ar, a6)


def fake_select(terms, tab):
    ktable_cuda.SELECT_LAUNCHES += 1
    return ktable.weighted_select_dot_plain(terms, tab)


def fake_spec(w_paths, s_paths, tab, nspa):
    ktable_cuda.SPEC_LAUNCHES += 1
    return ktable.spec_band_dot_plain(w_paths, s_paths, tab, nspa)


remap_cuda.remap_apply_cuda = fake_remap
ktable_cuda.weighted_select_dot_cuda = fake_select
ktable_cuda.spec_band_dot_cuda = fake_spec
ktable._use_kernel = lambda tab, impl: impl != "torch"
_remap = remap.remap_apply
remap.remap_apply = (
    lambda search, q1, iv=1, kord=9, impl=None, qs=None: _remap(
        search, q1, iv, kord, "cuda" if impl is None else impl, qs))
"""

KERNELS_28 = """
from fv3net_torch.ops import coarsen, coarsen_cuda


def fake_wavg_many(xs, w, f):
    with coarsen_cuda._COUNT_LOCK:
        coarsen_cuda.WAVG_LAUNCHES += 1
    return coarsen.weighted_block_average_many_plain(xs, w, f)


coarsen_cuda.weighted_block_average_many_cuda = fake_wavg_many
_wavg_many = coarsen.weighted_block_average_many
coarsen.weighted_block_average_many = (
    lambda xs, w, f, impl=None: _wavg_many(
        xs, w, f, impl="cuda" if impl is None else impl))
"""

NO_CARD = """
import torch

torch.cuda.synchronize = lambda *a: None
torch.cuda.empty_cache = lambda: None
torch.cuda.reset_peak_memory_stats = lambda *a: None
torch.cuda.max_memory_allocated = lambda *a: 0
"""

CPU_DEFAULTS = """
from fv3net_torch.runtime import loop as _loop
from fv3net_torch.runtime.segmented_run import api as _api


def _cpu_defaults(fn):
    fn.__defaults__ = tuple("cpu" if d == "cuda" else d
                            for d in fn.__defaults__)


for _fn in (_loop.TimeLoop.__init__, _api.run_segment, _api.append_segment):
    _cpu_defaults(_fn)
"""


def unclamped():
    from fv3net_torch.fit import models

    cs.ML_OUTPUT_LIMITS = {}
    predict = models.TaperedModel.predict

    def logged(self, X):
        out = predict(self, X)
        print(f"largest dQ1 {float(out['dQ1'].data.abs().max()) * cs.DT:.4g} "
              "K a step", flush=True)
        return out

    models.TaperedModel.predict = logged


def main(argv):
    phase = argv[0] if argv else "29"
    if phase not in ("28", "29", "30", "31", "32", "33", "34"):
        raise SystemExit(f"no rehearsal of phase {phase} (28 to 34)")
    prelude = NO_CARD + (KERNELS_28 if phase == "28"
                         else KERNELS_29 + CPU_DEFAULTS)
    exec(prelude, {})
    cs.DEVICE = "cpu"
    cs.CLI_PRELUDE = ("import sys\nsys.argv += ['--device', 'cpu']\n"
                      + prelude)
    if os.environ.get("KEEP"):
        shutil.rmtree = lambda *a, **k: None
    t0 = time.perf_counter()
    device = torch.device("cpu")
    if phase in ("29", "30", "31", "32", "33"):
        cs.NPX = int(os.environ.get("NPX", 6))
        cs.NPZ = int(os.environ.get("NPZ", 8))
        if os.environ.get("UNCLAMPED"):
            unclamped()
    if phase == "29":
        out = cs.phase_ml_loop(device, 0.0)
    elif phase == "30":
        # CUDA events need a card: one call, no time
        cs.cuda_ms = lambda fn, reps, warmup=3: (fn(), 0.0)[1]
        _, cube, _, _ = cs.phase_reservoir(device, 0.0)
        _, data = cs.phase_ml_loop(device, 0.0, keep_data=True)
        t0 = time.perf_counter()
        out = cs.phase_ml_tail(device, cube, data)
        print(f"phase 30 alone: {time.perf_counter() - t0:.1f} s")
    elif phase == "31":
        _, data = cs.phase_ml_loop(device, 0.0, keep_data=True)
        t0 = time.perf_counter()
        out = cs.phase_sklearn_surface(device, data)
        print(f"phase 31 alone: {time.perf_counter() - t0:.1f} s")
    elif phase == "32":
        # CUDA events and the profiler need a card: one call, no time
        cs.cuda_ms = lambda fn, reps, warmup=3: (fn(), 0.0)[1]
        cs.profile_chunk = lambda label, run: (run(), {
            "wall_ms": 1.0, "device_ms": 0.0, "activities": 0,
            "ranges": {}, "kernels": {}})[1]
        cs.CLI_DEVICE = "cpu"
        _, _, emulated = cs.phase_emulated_run(device, keep_data=True)
        _, _, _, reservoir = cs.phase_reservoir(device, 0.0)
        _, data = cs.phase_ml_loop(device, 0.0, keep_data=True)
        t0 = time.perf_counter()
        out = cs.phase_diagnostics(device, data, emulated, reservoir)
        print(f"phase 32 alone: {time.perf_counter() - t0:.1f} s")
    elif phase == "34":
        out = cs.phase_optax_tail(device, "CPU rehearsal")
    elif phase == "33":
        cs.CLI_DEVICE = cs.WORKFLOW_DEVICE = "cpu"
        cs.SCREAM_CONFIG = dict(cs.SCREAM_CONFIG,
                                RESOLUTION=f"ne{cs.NPX // 2}pg2_ne{cs.NPX // 2}pg2",
                                npz=cs.NPZ)
        out = cs.phase_entry_points(device, cs.os.path.dirname(
            cs.os.path.abspath(cs.__file__)), "CPU rehearsal")
    else:
        cs.C384, cs.COARSEN_FACTOR = int(os.environ.get("N", 32)), 8
        cs.OFFLINE_NZ = int(os.environ.get("NZ", 6))
        cs.OFFLINE_F64_NZ = 5  # kord-1 remaps need 5 levels or more
        out = cs.phase_offline(device)
    print(f"phase {phase} rehearsed on the CPU in "
          f"{time.perf_counter() - t0:.1f} s: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
