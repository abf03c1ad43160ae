"""Wall-clock timing of the run's phases (port of
``fv3net_tpu/runtime/timing.py``; reference: pace.util.Timer around
every TimeLoop substep, runtime/loop.py:140,662, with a timing table
logged at the run's end, loop.py:439-455).

A context-manager :class:`Timer` accumulates named clocks; ``phases`` is
the segmented run's, which ``run_segment`` resets at its start.  The
clocks are host clocks: on the card, a phase that queues device work
returns before the device has done it, and the next phase that copies
to the host waits for it.  ``profile_trace`` records a
``torch.profiler`` trace of the device; ``log_times`` logs a timer's
table as JSON.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict


class Timer:
    """Accumulates wall-clock durations by name (pace.util.Timer API)."""

    def __init__(self):
        self._times: Dict[str, float] = {}
        self._hits: Dict[str, int] = {}
        self._active: Dict[str, float] = {}

    def start(self, name: str) -> None:
        if name in self._active:
            raise ValueError(f"clock {name!r} already started")
        self._active[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        t0 = self._active.pop(name)
        dt = time.perf_counter() - t0
        self._times[name] = self._times.get(name, 0.0) + dt
        self._hits[name] = self._hits.get(name, 0) + 1

    @contextlib.contextmanager
    def clock(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    @property
    def times(self) -> Dict[str, float]:
        return dict(self._times)

    @property
    def hits(self) -> Dict[str, int]:
        return dict(self._hits)

    def reset(self) -> None:
        self._times.clear()
        self._hits.clear()
        self._active.clear()


logger = logging.getLogger("profiles")

# the segmented run's phase clocks and byte counters: run_segment resets
# them at its start; the loop, the diagnostics writers and the restart
# writer add to them.  perf_counter pairs at chunk granularity cost
# nothing worth counting, so they are always on.
phases = Timer()
counters: Dict[str, float] = {}


def add_counter(name: str, value: float) -> None:
    counters[name] = counters.get(name, 0.0) + value


def reset_phases() -> None:
    phases.reset()
    counters.clear()


def phase_report() -> Dict:
    rep = {
        name: {
            "total_seconds": round(total, 4),
            "hits": phases.hits[name],
        }
        for name, total in phases.times.items()
    }
    for k, v in counters.items():
        rep[k] = v
    return rep


def log_times(timer: Timer, label: str = "cumulative_timings") -> Dict:
    """JSON timing report (the loop.py:439-455 analog; min/max/mean
    degenerate to the single-host value without an MPI communicator)."""
    report = {
        name: {
            "total_seconds": total,
            "hits": timer.hits[name],
            "mean_seconds": total / max(timer.hits[name], 1),
        }
        for name, total in timer.times.items()
    }
    logger.info(json.dumps({label: report}))
    return report


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Record a ``torch.profiler`` trace (the host, and the card where
    there is one) of everything inside the context, written as a Chrome
    trace to ``<logdir>/trace.json`` (open it in Perfetto or
    chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def step_annotation(step: int):
    """Mark one model step (or chunk) in the profiler timeline."""
    from torch.profiler import record_function

    return record_function(f"model_step_{step}")
