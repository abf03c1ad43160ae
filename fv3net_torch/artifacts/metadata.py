"""Provenance metadata printed by every workflow step (a copy of the
host-only ``fv3net_tpu/artifacts/metadata.py``).

reference: external/artifacts/fv3net/artifacts/metadata.py — a
StepMetadata dataclass whose ``print_json`` emits one machine-parseable
line per step (used e.g. at fv3fit/train.py:190-192,
segmented_run/append.py:48-52).
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import List, Mapping, Optional


@dataclasses.dataclass
class StepMetadata:
    job_type: str
    url: str
    dependencies: Optional[Mapping[str, str]] = None
    args: Optional[List[str]] = None
    env_vars: Optional[Mapping[str, str]] = None

    def print_json(self, file=None) -> None:
        d = {k: v for k, v in dataclasses.asdict(self).items() if v is not None}
        print(json.dumps({"step_metadata": d}), file=file or sys.stdout)
