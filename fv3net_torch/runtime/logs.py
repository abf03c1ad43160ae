"""Structured run-log parsing + capture.

reference: the reference parses Fortran stdout into FV3Log objects
(external/vcm/vcm/fv3/logs.py:36-58) and captures C-level streams
(runtime/logs.py:13-88).  This framework has no Fortran stdout; its
equivalent observable is the per-step JSON "statistics"/"profiles"
stream (fv3net_torch.runtime.metrics / timing) — this module parses those
back into time series for diagnostics.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List


@dataclasses.dataclass
class RunLog:
    """Parsed per-step statistics (the FV3Log analog)."""

    times: List[str]
    scalars: Dict[str, List[float]]


def loads(text: str) -> RunLog:
    """Parse a stream of per-step JSON lines (one dict per line with a
    'time' key) into time series; non-JSON lines are ignored."""
    times: List[str] = []
    scalars: Dict[str, List[float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "time" not in d:
            continue
        times.append(d["time"])
        for key, value in d.items():
            if key == "time" or not isinstance(value, (int, float)):
                continue
            if key not in scalars:
                # key first seen mid-stream: backfill earlier steps
                scalars[key] = [float("nan")] * (len(times) - 1)
        for key in scalars:
            scalars[key].append(float(d.get(key, float("nan"))))
    return RunLog(times=times, scalars=scalars)
