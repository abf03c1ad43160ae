"""The create/append segmented-run API (port of
``fv3net_tpu/runtime/segmented_run/api.py``; reference:
runtime/segmented_run/api.py + append.py:17-88).

A run directory holds ``fv3config.yml`` and ``artifacts/<start time>/``
per segment, each with its zarr diagnostics and a ``RESTART`` (the
reference's ``state.npz`` format and its Fortran NetCDF layout);
``append_segment`` continues from the last segment's RESTART.  Runs go
on the card by default.
"""
from __future__ import annotations

import contextlib
import datetime
import logging
import os
from typing import Optional

import torch
import yaml

from fv3net_torch.parallel.halo import set_active_mesh
from fv3net_torch.runtime import metrics, timing
from fv3net_torch.runtime.checkpoint import (
    load_state,
    pull_state,
    restart_time,
    save_fortran_restarts,
    save_state,
)
from fv3net_torch.runtime.config import UserConfig, get_config
from fv3net_torch.runtime.diagnostics.manager import DiagnosticsManager
from fv3net_torch.runtime.loop import TimeLoop

logger = logging.getLogger(__name__)

CONFIG_NAME = "fv3config.yml"


def create(url: str, config: dict) -> str:
    """Initialize a run directory with its (validated) config."""
    os.makedirs(url, exist_ok=True)
    get_config(dict(config))  # validate
    with open(os.path.join(url, CONFIG_NAME), "w") as f:
        yaml.safe_dump(config, f)
    return url


def read_run_config(url: str) -> UserConfig:
    with open(os.path.join(url, CONFIG_NAME)) as f:
        return get_config(yaml.safe_load(f))


def read_last_segment(url: str) -> Optional[str]:
    """The last artifacts/<timestamp> directory holding a RESTART."""
    artifacts = os.path.join(url, "artifacts")
    if not os.path.isdir(artifacts):
        return None
    for seg in reversed(sorted(os.listdir(artifacts))):
        if os.path.isdir(os.path.join(artifacts, seg, "RESTART")):
            return os.path.join(artifacts, seg)
    return None


def run_segment(
    config: UserConfig,
    output_dir: str,
    restart_from: Optional[str] = None,
    profile: bool = False,
    device="cuda",
    dtype=torch.float32,
) -> TimeLoop:
    """Run one segment on ``device``, writing its diagnostics, its scalar
    log lines and its RESTART to ``output_dir``; returns the loop, whose
    ``phase_report`` holds the host seconds of the segment's phases
    (``setup``: the loop's construction with its chunk, RRTMG tables and
    ML model; ``loop_dispatch``; ``diag_observe``; ``scalar_flush``;
    ``restart_write``).

    A segment that fails after its first step or chunk is a warning, not
    a loss: the diagnostics written so far and the last completed state's
    RESTART are kept (the reference's partial-segment recovery).  Under a
    sharded layout a failed step raises on its rank instead: the other
    ranks are then inside the step's halo exchanges and reductions,
    which a recovery's gathers could not line up with, so the process
    group is torn down and every rank fails (under ``torchrun`` the
    agent ends the others).
    ``profile=True`` records a ``torch.profiler`` trace of the segment to
    ``<output_dir>/profile``.  ``dtype`` is float32 in production (the
    reference's run is float32); the tests take float64.
    """
    os.makedirs(output_dir, exist_ok=True)
    timing.reset_phases()
    with timing.phases.clock("setup"):
        loop = TimeLoop(config, dtype=dtype, device=device)
        if restart_from is not None:
            state, loop.time = load_state(
                os.path.join(restart_from, "RESTART"))
            loop.state = loop.place(state)
    diag_mgr = DiagnosticsManager(
        list(config.diagnostics) + list(config.fortran_diagnostics),
        loop.time,
        output_dir,
    )
    trace_ctx = (
        timing.profile_trace(os.path.join(output_dir, "profile"))
        if profile
        else contextlib.nullcontext()
    )
    failure: Optional[BaseException] = None
    step = 0
    with trace_ctx:
        it = iter(loop)
        while True:
            with (timing.step_annotation(step) if profile
                  else contextlib.nullcontext()):
                try:
                    with timing.phases.clock("loop_dispatch"):
                        nxt = next(it, None)
                    if nxt is None:
                        break
                    time, diags = nxt
                    with timing.phases.clock("diag_observe"):
                        diag_mgr.observe(time, diags)
                    with timing.phases.clock("scalar_flush"):
                        names_, vec = metrics.global_means(diags, loop.area)
                        row = [] if vec is None else vec.cpu().tolist()
                        if loop.mesh is None or loop.mesh.rank == 0:
                            metrics.log_scalar(time,
                                               dict(zip(names_, row)))
                except Exception as e:  # noqa: BLE001
                    if loop.mesh is not None:
                        import torch.distributed as dist

                        logger.error("segment failed at step %d on rank "
                                     "%d (%s)", step, loop.mesh.rank, e)
                        set_active_mesh(None)
                        dist.destroy_process_group()
                        raise
                    # coarse recovery: keep the diagnostics written so
                    # far and the last completed state's RESTART
                    logger.warning(
                        "segment failed at step %d (%s); writing partial "
                        "segment", step, e,
                    )
                    failure = e
                    break
            step += 1
    with timing.phases.clock("diag_observe"):
        diag_mgr.close()
    if failure is not None and step == 0:
        # nothing completed: there is no partial segment to keep
        raise failure
    restart_dir = os.path.join(output_dir, "RESTART")
    with timing.phases.clock("restart_write"):
        # one device->host copy; under a sharded layout rank 0 writes the
        # state gathered from every rank's block
        host_state = pull_state(loop.global_state())
        if loop.mesh is None or loop.mesh.rank == 0:
            save_state(host_state, loop.time, restart_dir)
            save_fortran_restarts(host_state, loop.time, restart_dir,
                                  loop.grid)
        if loop.mesh is not None:
            import torch.distributed as dist

            dist.barrier(group=loop.mesh.group)
    loop.phase_report = timing.phase_report()
    return loop


def append_segment(url: str, profile: bool = False, device="cuda",
                   dtype=torch.float32) -> str:
    """Run the next segment of the run at ``url``; returns its directory,
    ``artifacts/<its start time>``."""
    config = read_run_config(url)
    last = read_last_segment(url)
    if last is not None:
        start_time = restart_time(os.path.join(last, "RESTART"))
    else:
        start_time = datetime.datetime.fromisoformat(config.initial_time)
    output_dir = os.path.join(url, "artifacts",
                              start_time.strftime("%Y%m%d.%H%M%S"))
    run_segment(config, output_dir, restart_from=last, profile=profile,
                device=device, dtype=dtype)
    return output_dir
