"""Time interpolation of reference datasets (port of
``fv3net_tpu/runtime/interpolate.py``; reference:
workflows/prognostic_c48_run/runtime/interpolate.py:18-65):
``time_interpolate_func`` wraps a timestamp-keyed getter with linear
interpolation between the two bracketing snapshots; ``mapper_getter``
turns a mapper keyed by %Y%m%d.%H%M%S labels or by time indices into a
getter of time.  The arrays stay as the mapper holds them (numpy from a
zarr store, or tensors)."""
from __future__ import annotations

import datetime
from typing import Callable, Mapping

from fv3net_torch.core.convenience import parse_datetime_from_str
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity


def time_interpolate_func(
    func: Callable[[datetime.datetime], Dataset],
    frequency: datetime.timedelta,
    initial_time: datetime.datetime,
) -> Callable[[datetime.datetime], Dataset]:
    """Linear interpolation between snapshots available at
    initial_time + k * frequency."""

    def wrapped(time: datetime.datetime) -> Dataset:
        elapsed = (time - initial_time).total_seconds()
        freq = frequency.total_seconds()
        k = int(elapsed // freq)
        t0 = initial_time + datetime.timedelta(seconds=k * freq)
        t1 = t0 + frequency
        w = (time - t0).total_seconds() / freq
        if w == 0.0:
            return func(t0)
        ds0 = func(t0)
        ds1 = func(t1)
        out = {}
        for name in ds0:
            a = ds0[name].data
            b = ds1[name].data
            out[name] = Quantity(
                (1.0 - w) * a + w * b, ds0[name].dims, ds0[name].units
            )
        return Dataset(out)

    return wrapped


def mapper_getter(
    mapper: Mapping[str, Dataset],
    initial_time: datetime.datetime = None,
    frequency: datetime.timedelta = None,
) -> Callable:
    """time -> Dataset from a mapper keyed by %Y%m%d.%H%M%S labels, or,
    given ``initial_time`` and ``frequency``, by integer indices (clamped
    to the mapper's range)."""
    # integer-string keys (ZarrMapper uses str(i)) sort numerically:
    # lexicographic order would map step 2 to time slice 10 once
    # n_times >= 10
    if all(k.isdigit() for k in mapper):
        keys = sorted(mapper, key=int)
    else:
        keys = sorted(mapper)
    by_time = {}
    for k in keys:
        try:
            by_time[parse_datetime_from_str(k)] = k
        except ValueError:
            pass

    def getter(time: datetime.datetime) -> Dataset:
        if by_time:
            return mapper[by_time[time]]
        if initial_time is not None and frequency is not None:
            idx = round(
                (time - initial_time).total_seconds()
                / frequency.total_seconds()
            )
            idx = max(0, min(idx, len(keys) - 1))
            return mapper[keys[idx]]
        raise KeyError(time)

    return getter
