"""Stepper combinators (port of ``fv3net_tpu/runtime/steppers/combine.py``;
reference: workflows/prognostic_c48_run/runtime/steppers/combine.py and
steppers/interval.py)."""
from __future__ import annotations

import datetime
from typing import Optional, Sequence


class CombinedStepper:
    """Run steppers in order, merging their outputs.  Conflicting tendency
    keys raise (two steppers adjusting the same variable would silently
    drop one increment); diagnostics and direct state updates merge with
    later steppers winning."""

    label = "combined"

    def __init__(self, steppers: Sequence):
        self.steppers = list(steppers)

    def __call__(self, time, state):
        tendencies, diagnostics, state_updates = {}, {}, {}
        for stepper in self.steppers:
            t, d, s = stepper(time, state)
            overlap = set(tendencies) & set(t)
            if overlap:
                raise ValueError(
                    f"multiple steppers produce tendencies for {overlap}"
                )
            tendencies.update(t)
            diagnostics.update(d)
            state_updates.update(s)
        return tendencies, diagnostics, state_updates


class IntervalStepper:
    """Invoke the wrapped stepper only every ``apply_interval_seconds``,
    counted from the time of the first call (which fires)."""

    def __init__(self, apply_interval_seconds: float, stepper):
        self.interval = apply_interval_seconds
        self.stepper = stepper
        self.start_time: Optional[datetime.datetime] = None

    @property
    def label(self):
        return f"interval_{self.stepper.label}"

    def _needs_update(self, time) -> bool:
        if self.start_time is None:
            self.start_time = time
            return True
        elapsed = (time - self.start_time).total_seconds()
        return abs(elapsed % self.interval) < 1e-6

    def __call__(self, time, state):
        if self._needs_update(time):
            return self.stepper(time, state)
        return {}, {}, {}
