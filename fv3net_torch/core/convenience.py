"""Time parsing and encoding conveniences (a copy of
``fv3net_tpu/core/convenience.py``; reference:
external/vcm/vcm/convenience.py), in the FV3 timestamp convention
%Y%m%d.%H%M%S."""
from __future__ import annotations

import datetime
import re

TIME_FMT = "%Y%m%d.%H%M%S"
TIMESTEP_RE = re.compile(r"(\d{8}\.\d{6})")


def encode_time(time: datetime.datetime) -> str:
    """datetime -> '20160801.003000' (reference convenience.encode_time)."""
    return time.strftime(TIME_FMT)


def parse_datetime_from_str(time_str: str) -> datetime.datetime:
    return datetime.datetime.strptime(time_str, TIME_FMT)


def parse_timestep_str_from_path(path: str) -> str:
    """Extract the timestamp token from a path like
    .../artifacts/20160801.003000/RESTART (reference
    convenience.parse_timestep_str_from_path)."""
    match = TIMESTEP_RE.search(path)
    if match is None:
        raise ValueError(f"no timestep found in {path!r}")
    return match.group(1)


def parse_current_date_from_str(time_str: str):
    """[Y, M, D, h, m, s] list as used by model namelists."""
    t = parse_datetime_from_str(time_str)
    return [t.year, t.month, t.day, t.hour, t.minute, t.second]


def shift_timestamp(time: str, seconds: float) -> str:
    """Add an offset in seconds to a '%Y%m%d.%H%M%S' timestamp
    (reference convenience.py:139-143)."""
    shifted = parse_datetime_from_str(time) + datetime.timedelta(seconds=seconds)
    return encode_time(shifted)


def round_time(t: datetime.datetime, to: float = 1.0) -> datetime.datetime:
    """Round to the nearest ``to`` seconds (reference convenience.round_time)."""
    epoch = datetime.datetime(1900, 1, 1)
    seconds = (t - epoch).total_seconds()
    rounded = round(seconds / to) * to
    return epoch + datetime.timedelta(seconds=rounded)


def cast_to_datetime(time) -> datetime.datetime:
    """Cast a datetime-like object (datetime, cftime-like, np.datetime64,
    or timestamp string/path) to a python datetime, assuming compatible
    calendars (reference convenience.py:98-131)."""
    import numpy as np

    if isinstance(time, datetime.datetime):
        return time
    if isinstance(time, str):
        return parse_datetime_from_str(parse_timestep_str_from_path(time))
    if isinstance(time, np.datetime64):
        seconds = (time - np.datetime64(0, "s")) / np.timedelta64(1, "s")
        return datetime.datetime(1970, 1, 1) + datetime.timedelta(
            seconds=float(seconds)
        )
    # cftime-like: duck-typed calendar fields
    return datetime.datetime(
        time.year,
        time.month,
        time.day,
        time.hour,
        time.minute,
        time.second,
        getattr(time, "microsecond", 0),
    )


def convert_timestamps(coord):
    """Vectorized parse of '%Y%m%d.%H%M%S' strings to datetimes
    (reference convenience.py:134-136); accepts any array-like of
    timestamp strings and returns an object ndarray."""
    import numpy as np

    parser = np.vectorize(parse_datetime_from_str)
    return parser(np.asarray(coord))


def gsrm_name_from_resolution_string(res: str) -> str:
    """'neXX' -> scream, 'cXX'/'CXX' -> fv3gfs (reference
    convenience.py:151-160)."""
    if res.startswith("ne"):
        return "scream"
    if res.lower().startswith("c"):
        return "fv3gfs"
    raise ValueError(
        f"This resolution {res} can not be mapped to either scream or fv3."
    )


def check_if_scream_dataset(ds) -> bool:
    """SCREAM output is on an unstructured 'ncol' dimension (reference
    convenience.py:164-168)."""
    return "ncol" in getattr(ds, "dims", {})
