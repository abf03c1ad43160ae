"""optax 0.2.6's learning-rate schedules, as functions of the integer
update count (0 for the first update), under optax's names, with its
defaults and formulas: ``constant_schedule``, ``exponential_decay``,
``cosine_decay_schedule``, ``piecewise_constant_schedule``,
``polynomial_schedule``, ``linear_schedule``,
``piecewise_interpolate_schedule``, ``join_schedules``,
``warmup_constant_schedule``, ``warmup_cosine_decay_schedule``,
``warmup_exponential_decay_schedule``, ``sgdr_schedule``,
``cosine_onecycle_schedule`` and ``linear_onecycle_schedule``.

Each returns a Python float.  optax's count is an int32, which makes some
of its rates float32 values (a strongly typed float32 array) and others
float64 (strong, or weakly typed where only Python numbers enter): a
schedule whose rate is a strong float32 or float64 value carries that
numpy type as its ``dtype``, which :func:`join_schedules` promotes as
``jnp.where`` does and ``optimizers.fromage`` computes in.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np

Schedule = Callable[[int], float]

__all__ = [
    "constant_schedule",
    "cosine_decay_schedule",
    "cosine_onecycle_schedule",
    "exponential_decay",
    "join_schedules",
    "linear_onecycle_schedule",
    "linear_schedule",
    "piecewise_constant_schedule",
    "piecewise_interpolate_schedule",
    "polynomial_schedule",
    "sgdr_schedule",
    "warmup_constant_schedule",
    "warmup_cosine_decay_schedule",
    "warmup_exponential_decay_schedule",
]


def _typed(dtype, schedule: Schedule) -> Schedule:
    schedule.dtype = dtype
    return schedule


def dtype_of(schedule: Schedule):
    """np.float32 or np.float64 where optax's rate is a strongly typed
    array of that dtype, None where it is weakly typed."""
    return getattr(schedule, "dtype", None)


def power32(x, y) -> np.float32:
    """x ** y in float32, correctly rounded (XLA's float32 power, which
    optax's schedules use, is an ulp off it at some arguments)."""
    return np.power(np.float32(x), np.float32(y))


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, transition_begin: int = 0,
                      staircase: bool = False,
                      end_value: Optional[float] = None) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)
    f32 = np.float32

    def schedule(count):
        decreased = count - transition_begin
        p = f32(decreased) / f32(transition_steps)
        if staircase:
            p = np.floor(p)
        value = (f32(init_value) if decreased <= 0
                 else f32(init_value) * power32(decay_rate, p))
        if end_value is not None:
            value = (np.maximum if decay_rate < 1.0 else np.minimum)(
                value, f32(end_value))
        return float(value)

    return _typed(np.float32, schedule)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0
                          ) -> Schedule:
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        count = min(float(count), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales=None) -> Schedule:
    if boundaries_and_scales is not None and not all(
            s >= 0.0 for s in boundaries_and_scales.values()):
        raise ValueError("`piecewise_constant_schedule` expects "
                         "non-negative scale factors")

    def schedule(count):
        v = init_value
        for threshold, scale in sorted((boundaries_and_scales or {}).items()):
            if count >= threshold:
                v = v * scale
        return v

    return schedule


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int, transition_begin: int = 0
                        ) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)
    f32 = np.float32

    def schedule(count):
        count = min(max(count - transition_begin, 0), transition_steps)
        frac = f32(1) - f32(count) / f32(transition_steps)
        return float(f32(init_value - end_value) * (frac ** f32(power))
                     + f32(end_value))

    return _typed(np.float32, schedule)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int, transition_begin: int = 0
                    ) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps,
                               transition_begin)


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: from each boundary on, the next schedule,
    counted from that boundary.  optax joins with ``jnp.where``, so its
    rate takes the type the joined rates promote to: float64 if one is a
    strong float64, else float32 if one is a strong float32."""
    dtypes = {dtype_of(s) for s in schedules}
    dtype = (np.float64 if np.float64 in dtypes
             else np.float32 if np.float32 in dtypes else None)

    def schedule(count):
        value = schedules[0](count)
        for boundary, then in zip(boundaries, schedules[1:]):
            if count >= boundary:
                value = then(count - boundary)
        return value if dtype is None else float(dtype(value))

    return _typed(dtype, schedule)


def warmup_constant_schedule(init_value: float, peak_value: float,
                             warmup_steps: int) -> Schedule:
    return linear_schedule(init_value, peak_value, warmup_steps)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha=alpha, exponent=exponent)],
        [warmup_steps])


def warmup_exponential_decay_schedule(
        init_value: float, peak_value: float, warmup_steps: int,
        transition_steps: int, decay_rate: float, transition_begin: int = 0,
        staircase: bool = False, end_value: Optional[float] = None
) -> Schedule:
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         exponential_decay(peak_value, transition_steps, decay_rate,
                           transition_begin, staircase, end_value)],
        [warmup_steps])


def sgdr_schedule(cosine_kwargs: Iterable[Dict[str, float]]) -> Schedule:
    """optax.sgdr_schedule: warm-up cosine decays joined end to end, each
    after the previous one's ``decay_steps``."""
    boundaries, schedules, step = [], [], 0
    for kwargs in cosine_kwargs:
        schedules.append(warmup_cosine_decay_schedule(**kwargs))
        boundaries.append(step + kwargs["decay_steps"])
        step += kwargs["decay_steps"]
    return join_schedules(schedules, boundaries[:-1])


def piecewise_interpolate_schedule(interpolate_type: str, init_value: float,
                                   boundaries_and_scales=None) -> Schedule:
    """optax.piecewise_interpolate_schedule: linear or cosine steps between
    the cumulative products of the scales at the boundaries (float64, as
    optax's numpy bounds make it)."""
    if interpolate_type == "linear":
        def interpolate(start, end, pct):
            return (end - start) * pct + start
    elif interpolate_type == "cosine":
        def interpolate(start, end, pct):
            return end + (start - end) / 2.0 * (np.cos(np.pi * pct) + 1)
    else:
        raise ValueError(
            "`interpolate_type` must be either 'cosine' or 'linear'")
    if boundaries_and_scales:
        boundaries, scales = zip(*sorted(boundaries_and_scales.items()))
        if not all(scale >= 0.0 for scale in scales):
            raise ValueError("`piecewise_interpolate_schedule` expects "
                             "non-negative scale factors")
    else:
        boundaries, scales = (), ()
    bounds = np.stack((0,) + boundaries)
    values = np.cumprod(np.stack((init_value,) + scales))
    sizes = bounds[1:] - bounds[:-1]

    def schedule(count):
        with np.errstate(divide="ignore", invalid="ignore"):
            inside = (bounds[:-1] <= count) & (count < bounds[1:])
            pct = (count - bounds[:-1]) / sizes
            return float(inside.dot(interpolate(values[:-1], values[1:], pct))
                         + (bounds[-1] <= count) * values[-1])

    return _typed(np.float64, schedule)


def _check_transition_steps(transition_steps: int):
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a "
                         "non-positive `transition_steps`")


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    _check_transition_steps(transition_steps)
    return piecewise_interpolate_schedule(
        "cosine", peak_value / div_factor,
        {int(pct_start * transition_steps): div_factor,
         int(transition_steps): 1.0 / (div_factor * final_div_factor)})


def linear_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, pct_final: float = 0.85,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    _check_transition_steps(transition_steps)
    return piecewise_interpolate_schedule(
        "linear", peak_value / div_factor,
        {int(pct_start * transition_steps): div_factor,
         int(pct_final * transition_steps): 1.0 / div_factor,
         transition_steps: 1.0 / final_div_factor})


SCHEDULES = {f.__name__: f for f in (
    constant_schedule, exponential_decay, cosine_decay_schedule,
    piecewise_constant_schedule, polynomial_schedule, linear_schedule,
    piecewise_interpolate_schedule, join_schedules, warmup_constant_schedule,
    warmup_cosine_decay_schedule, warmup_exponential_decay_schedule,
    sgdr_schedule, cosine_onecycle_schedule, linear_onecycle_schedule)}
