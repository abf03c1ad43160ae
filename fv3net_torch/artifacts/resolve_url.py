"""Standard output-URL naming convention (a copy of the host-only
``fv3net_tpu/artifacts/resolve_url.py``; reference:
external/artifacts/fv3net/artifacts/resolve_url.py): bucket/project/
date-tag layout for experiment outputs."""
from __future__ import annotations

import datetime
import re


def resolve_url(bucket: str, project: str, tag: str,
                time: datetime.date = None) -> str:
    if not re.fullmatch(r"[a-z0-9\-]+", project):
        raise ValueError(
            f"project must be lowercase alphanumeric/dash, got {project!r}"
        )
    if time is None:
        time = datetime.date.today()
    return f"{bucket}/{project}/{time.isoformat()}/{tag}"
