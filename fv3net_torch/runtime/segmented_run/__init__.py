"""Segmented runs: a run is a series of restartable segments (port of
``fv3net_tpu/runtime/segmented_run``; reference:
workflows/prognostic_c48_run/runtime/segmented_run/): each ``append``
continues from the last segment's RESTART."""
from fv3net_torch.runtime.segmented_run.api import (  # noqa: F401
    append_segment,
    create,
    run_segment,
)
