"""Time parsing and encoding (a copy of what the segmented run needs of
``fv3net_tpu/core/convenience.py``; reference:
external/vcm/vcm/convenience.py), in the FV3 timestamp convention
%Y%m%d.%H%M%S."""
from __future__ import annotations

import datetime

TIME_FMT = "%Y%m%d.%H%M%S"


def encode_time(time: datetime.datetime) -> str:
    """datetime -> '20160801.003000'."""
    return time.strftime(TIME_FMT)


def parse_datetime_from_str(time_str: str) -> datetime.datetime:
    return datetime.datetime.strptime(time_str, TIME_FMT)
