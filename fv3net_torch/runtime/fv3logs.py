"""Parser for GFDL FV3's Fortran stdout statistics blocks.

Input-compatibility shim for users migrating from the reference: their
existing Fortran run logs (the ``fv_diagnostics`` prints emitted every
``print_freq``) parse into the same shape the reference's
``vcm.fv3.logs.loads`` returns (reference:
external/vcm/vcm/fv3/logs.py:36-58 — FV3Log with dates / totals /
ranges), so downstream diagnostics code carries over.  This framework's
own runs emit structured JSON (`runtime/logs.py`), which is the native
path; this module exists purely to ingest legacy Fortran logs.

A statistics block looks like::

            2016           8           1           1           0           0
    ZS      6849.180      -412.0000       231.8707
    PS max =    1052.038      min =    439.9279
    Total surface pressure (mb) =    985.9462
    ...
    sphum max =   2.3002494E-02  min =   9.9999342E-10
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from datetime import datetime
from functools import reduce
from typing import Iterable, List, Mapping, Tuple

_DATE = re.compile(r"^\s*(\d{4})\s+(\d{1,2})\s+(\d{1,2})\s+(\d{1,2})\s+(\d{1,2})\s+(\d{1,2})\s*$")
_MINMAX = re.compile(
    r"^\s*(.+?)\s+max\s*=\s*([0-9.eE+\-]+)\s+min\s*=\s*([0-9.eE+\-]+)"
)
_FLOAT = r"([0-9.eE+\-]+)"
# scalar "name = value" lines worth keeping, keyed by the reference's
# totals naming
_TOTALS = [
    ("total surface pressure", re.compile(r"Total surface pressure \(mb\)\s*=\s*" + _FLOAT)),
    ("mean dry surface pressure", re.compile(r"mean dry surface pressure\s*=\s*" + _FLOAT)),
    ("total water vapor", re.compile(r"Total Water Vapor \(kg/m\*\*2\)\s*=\s*" + _FLOAT)),
    ("total cloud water", re.compile(r"Total cloud water\s*=\s*" + _FLOAT)),
    ("total rain water", re.compile(r"Total rain\s+water\s*=\s*" + _FLOAT)),
    ("total cloud ice", re.compile(r"Total cloud ice\s*=\s*" + _FLOAT)),
    ("total snow", re.compile(r"Total snow\s*=\s*" + _FLOAT)),
    ("total graupel", re.compile(r"Total graupel\s*=\s*" + _FLOAT)),
    ("total energy", re.compile(r"TE \( Joule/m\^2 \* E9\)\s*=\s*" + _FLOAT)),
]


@dataclasses.dataclass
class FV3Log:
    """Parsed statistics series (reference logs.py FV3Log shape)."""

    dates: List[datetime]
    totals: Mapping[str, List[float]]
    ranges: Mapping[str, List[Tuple[float, float]]]


def loads(log: str) -> FV3Log:
    """Parse the per-step statistics from a Fortran FV3 log."""
    dates: List[datetime] = []
    totals = defaultdict(list)
    ranges = defaultdict(list)
    for line in log.splitlines():
        m = _DATE.match(line)
        if m:
            y, mo, d, h, mi, s = (int(v) for v in m.groups())
            try:
                dates.append(datetime(y, mo, d, h, mi, s))
            except ValueError:
                pass  # a six-integer line that is not a date
            continue
        m = _MINMAX.match(line)
        if m:
            name = m.group(1).strip()
            try:
                ranges[name].append(
                    (float(m.group(3)), float(m.group(2)))  # (min, max)
                )
            except ValueError:
                pass
            continue
        for name, pat in _TOTALS:
            m = pat.search(line)
            if m:
                try:
                    totals[name].append(float(m.group(1)))
                except ValueError:
                    pass
                break
    return FV3Log(dates=dates, totals=dict(totals), ranges=dict(ranges))


def concatenate(logs: Iterable[FV3Log]) -> FV3Log:
    """Join segment logs end to end (shared keys only, as the reference
    does — a variable missing from one segment drops out)."""

    def join(a: FV3Log, b: FV3Log) -> FV3Log:
        return FV3Log(
            dates=a.dates + b.dates,
            totals={
                k: a.totals[k] + b.totals[k]
                for k in set(a.totals) & set(b.totals)
            },
            ranges={
                k: a.ranges[k] + b.ranges[k]
                for k in set(a.ranges) & set(b.ranges)
            },
        )

    return reduce(join, logs)
