"""Collections of computed diagnostics/metrics across runs.

Reference semantics: workflows/diagnostics/fv3net/diagnostics/
prognostic_run/computed_diagnostics.py — ``detect_folders`` discovers
per-run diagnostic folders under a bucket, ``RunDiagnostics`` queries
variables across runs (missing variables come back NaN-shaped from a
donor run), and ``RunMetrics`` indexes ``type/variable`` scalar metrics.
These feed the multi-run comparison report.

Host copy of ``fv3net_tpu/diagnostics/computed.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.core.zarrio import open_zarr

__all__ = [
    "DiagnosticFolder",
    "detect_folders",
    "load_diagnostics",
    "load_metrics",
    "RunDiagnostics",
    "RunMetrics",
]


@dataclasses.dataclass
class DiagnosticFolder:
    """One run's computed outputs: ``diags.zarr`` (+ optional
    ``metrics.json``) in a directory named after the run (reference
    computed_diagnostics.py:318-346, netCDF there)."""

    path: str

    @property
    def run(self) -> str:
        return os.path.basename(os.path.normpath(self.path))

    @property
    def diagnostics(self) -> Dataset:
        ds = open_zarr(os.path.join(self.path, "diags.zarr"))
        ds.attrs.setdefault("run", self.run)
        return ds

    @property
    def metrics(self) -> Mapping[str, Mapping]:
        p = os.path.join(self.path, "metrics.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)


def detect_folders(bucket: str) -> Dict[str, DiagnosticFolder]:
    """Find ``<bucket>/<run>/diags.zarr`` folders (reference
    computed_diagnostics.py:339-346)."""
    out = {}
    for name in sorted(os.listdir(bucket)):
        p = os.path.join(bucket, name)
        if os.path.isdir(os.path.join(p, "diags.zarr")):
            out[name] = DiagnosticFolder(p)
    return out


def load_diagnostics(bucket: str) -> "RunDiagnostics":
    folders = detect_folders(bucket)
    return RunDiagnostics([f.diagnostics for f in folders.values()])


def load_metrics(bucket: str) -> "RunMetrics":
    rows = []
    for name, folder in detect_folders(bucket).items():
        for metric, payload in folder.metrics.items():
            if isinstance(payload, dict):
                value = payload.get("value", np.nan)
                units = payload.get("units", "")
            else:
                value, units = payload, ""
            rows.append((name, metric, float(value), units))
    return RunMetrics(rows)


class RunDiagnostics:
    """Cross-run variable queries (reference
    computed_diagnostics.py:99-183)."""

    def __init__(self, diagnostics: Sequence[Dataset]):
        self._runs: Dict[str, Dataset] = {
            ds.attrs.get("run", f"run{i}"): ds
            for i, ds in enumerate(diagnostics)
        }

    @property
    def runs(self) -> List[str]:
        return list(self._runs)

    @property
    def variables(self) -> Set[str]:
        out: Set[str] = set()
        for ds in self._runs.values():
            out |= set(ds.keys())
        return out

    @property
    def long_names(self) -> Mapping[str, str]:
        out = {}
        for v in self.variables:
            for ds in self._runs.values():
                if v in ds:
                    out[v] = ds[v].attrs.get("long_name", v)
                    break
        return out

    def get_variable(self, run: str, varname: str) -> Quantity:
        """The variable from ``run``; if absent there, a NaN field with a
        donor run's shape/metadata (reference :133-152)."""
        ds = self._runs[run]
        if varname in ds:
            return ds[varname]
        for other in self._runs.values():
            if varname in other:
                template = other[varname]
                return Quantity(
                    np.full(template.shape, np.nan, np.asarray(template.data).dtype),
                    template.dims,
                    template.units,
                    dict(template.attrs),
                )
        raise ValueError(f"{varname} not found in any run")

    def get_variables(self, run: str, varnames: Sequence[str]) -> Dataset:
        return Dataset({v: self.get_variable(run, v) for v in varnames})

    def matching_variables(
        self, varfilter: str, varnames: Optional[Sequence[str]] = None
    ) -> Set[str]:
        matching = {v for v in self.variables if varfilter in v}
        if varnames:
            matching = {v for v in matching if any(vn in v for vn in varnames)}
        return matching

    def is_baseline(self, run: str) -> bool:
        return bool(self._runs[run].attrs.get("baseline", False))

    @staticmethod
    def is_verification(run: str) -> bool:
        return run == "verification"


class RunMetrics:
    """``type/variable`` scalar metrics across runs (reference
    computed_diagnostics.py:186-246), as plain tuples instead of a
    pandas frame."""

    def __init__(self, rows: Sequence[Tuple[str, str, float, str]]):
        # rows: (run, metric, value, units)
        self._rows = list(rows)

    @property
    def empty(self) -> bool:
        return not self._rows

    @property
    def runs(self) -> List[str]:
        seen: List[str] = []
        for run, *_ in self._rows:
            if run not in seen:
                seen.append(run)
        return seen

    @property
    def types(self) -> Set[str]:
        return {m.split("/")[0] for _, m, *_ in self._rows}

    def get_metric_variables(self, metric_type: str) -> Set[str]:
        return {
            m.split("/", 1)[1]
            for _, m, *_ in self._rows
            if m.split("/")[0] == metric_type and "/" in m
        }

    @staticmethod
    def metric_name(metric_type: str, variable: str) -> str:
        return f"{metric_type}/{variable}"

    def get_metric_value(self, metric_type: str, variable: str, run: str) -> float:
        name = self.metric_name(metric_type, variable)
        for r, m, v, _ in self._rows:
            if r == run and m == name:
                return v
        return float("nan")

    def get_metric_units(self, metric_type: str, variable: str, run: str) -> str:
        name = self.metric_name(metric_type, variable)
        for r, m, _, u in self._rows:
            if r == run and m == name:
                return u
        return ""

    def get_metric_all_runs(self, metric_type: str, variable: str):
        name = self.metric_name(metric_type, variable)
        return [
            (r, m, v, u) for r, m, v, u in self._rows if m == name
        ]
