"""Time selectors for diagnostic output (a copy of
``fv3net_tpu/runtime/diagnostics/times.py``).

reference: workflows/prognostic_c48_run/runtime/diagnostics/time.py:17-153
— kinds: every | interval | interval-average | selected.  A container
answers ``indicator(time)`` (should this time be stored / which averaging
bucket does it belong to).
"""
from __future__ import annotations

import datetime
from typing import Optional, Sequence


class All:
    """Store every timestep (kind: every)."""

    def indicator(self, time: datetime.datetime) -> Optional[datetime.datetime]:
        return time


class SelectedTimes:
    """Store only listed times (kind: selected), formatted %Y%m%d.%H%M%S."""

    TIME_FMT = "%Y%m%d.%H%M%S"

    def __init__(self, times: Sequence[str]):
        self._times = set(times)

    def indicator(self, time: datetime.datetime) -> Optional[datetime.datetime]:
        if time.strftime(self.TIME_FMT) in self._times:
            return time
        return None


class IntervalTimes:
    """Store every ``frequency_seconds`` (kind: interval), anchored to
    ``initial_time``."""

    def __init__(self, frequency_seconds: float,
                 initial_time: datetime.datetime):
        self._frequency = frequency_seconds
        self._initial_time = initial_time

    def indicator(self, time: datetime.datetime) -> Optional[datetime.datetime]:
        elapsed = (time - self._initial_time).total_seconds()
        if abs(elapsed % self._frequency) < 1e-6:
            return time
        return None


class IntervalAveragedTimes:
    """Average over windows of ``frequency_seconds`` (kind:
    interval-average); the indicator returns the window label for
    bucketing."""

    def __init__(self, frequency_seconds: float,
                 initial_time: datetime.datetime):
        self.frequency = frequency_seconds
        self._initial_time = initial_time

    def indicator(self, time: datetime.datetime) -> datetime.datetime:
        elapsed = (time - self._initial_time).total_seconds()
        bucket = int((elapsed - 1e-6) // self.frequency)
        return self._initial_time + datetime.timedelta(
            seconds=(bucket + 0.5) * self.frequency
        )

    def is_averaging(self) -> bool:
        return True


def time_container_from_config(cfg, initial_time: datetime.datetime):
    """Build a container from a TimeConfig (reference time.py factory)."""
    kind = cfg.kind
    if kind == "every":
        return All()
    if kind == "selected":
        return SelectedTimes(cfg.times or [])
    if kind == "interval":
        return IntervalTimes(cfg.frequency, initial_time)
    if kind == "interval-average":
        return IntervalAveragedTimes(cfg.frequency, initial_time)
    raise ValueError(f"unknown time kind {kind!r}")
