"""Local experiment tracking, the wandb slot (a copy of
``fv3net_tpu/fit/tracking.py``; reference: fv3fit's wandb integration,
external/fv3fit/fv3fit/train.py:119-134): JSON-lines run records under
a local directory (``FV3NET_TPU_TRACKING_DIR`` or ``./tracking``, the
reference's), which ``tracking-query-torch`` lists.  Host-only.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Any, Dict, Optional

_RUN: Optional["Run"] = None


@dataclasses.dataclass
class Run:
    project: str
    name: str
    dir: str
    config: Dict[str, Any]

    def __post_init__(self):
        os.makedirs(self.dir, exist_ok=True)
        self._history = open(os.path.join(self.dir, "history.jsonl"), "a")
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(self.config, f, indent=2, default=str)
        self._step = 0

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {
            "_step": self._step if step is None else step,
            "_time": datetime.datetime.now().isoformat(timespec="seconds"),
        }
        record.update({k: _scalar(v) for k, v in metrics.items()})
        self._history.write(json.dumps(record) + "\n")
        self._history.flush()
        self._step += 1

    def finish(self) -> None:
        self._history.close()
        global _RUN
        _RUN = None


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def init(
    project: str = "default",
    name: Optional[str] = None,
    config: Optional[Dict[str, Any]] = None,
    dir: Optional[str] = None,
) -> Run:
    """wandb.init-shaped entry point."""
    global _RUN
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    name = name or f"run_{stamp}"
    base = dir or os.environ.get("FV3NET_TPU_TRACKING_DIR", "./tracking")
    _RUN = Run(
        project=project,
        name=name,
        dir=os.path.join(base, project, name),
        config=dict(config or {}),
    )
    return _RUN


def log(metrics: Dict[str, Any], step: Optional[int] = None) -> None:
    if _RUN is not None:
        _RUN.log(metrics, step)


def finish() -> None:
    if _RUN is not None:
        _RUN.finish()


def read_history(run_dir: str):
    """Load a run's history.jsonl as a list of dicts."""
    out = []
    with open(os.path.join(run_dir, "history.jsonl")) as f:
        for line in f:
            out.append(json.loads(line))
    return out


# ---------------------------------------------------------------- query CLI
def _summarize_run(run_dir: str) -> Dict[str, Any]:
    """Last-logged metrics + config of one run directory."""
    config = {}
    cfg_path = os.path.join(run_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    summary: Dict[str, Any] = {}
    steps = 0
    hist = os.path.join(run_dir, "history.jsonl")
    if os.path.exists(hist):
        with open(hist) as f:
            for line in f:
                steps += 1
                summary.update(json.loads(line))
    return {
        "project": os.path.basename(os.path.dirname(run_dir)),
        "name": os.path.basename(run_dir),
        "path": run_dir,
        "steps": steps,
        "summary": summary,
        "config": config,
    }


def query_runs(
    base: Optional[str] = None,
    project: Optional[str] = None,
    name_regex: Optional[str] = None,
):
    """Iterate run records under the tracking directory (reference:
    external/wandb-query/wandb-query — the same list/filter surface over
    local JSONL records instead of the wandb API)."""
    import re

    base = base or os.environ.get("FV3NET_TPU_TRACKING_DIR", "./tracking")
    if not os.path.isdir(base):
        return
    for proj in sorted(os.listdir(base)):
        if project and proj != project:
            continue
        proj_dir = os.path.join(base, proj)
        if not os.path.isdir(proj_dir):
            continue
        for run_name in sorted(os.listdir(proj_dir)):
            if name_regex and not re.search(name_regex, run_name):
                continue
            run_dir = os.path.join(proj_dir, run_name)
            if os.path.isdir(run_dir):
                yield _summarize_run(run_dir)


def main(argv=None) -> int:
    """tracking-query CLI: list local experiment runs.

    Default output: `project name steps path` per line; `-o json` prints
    one JSON record per run (composable with jq, like the reference CLI).
    """
    import argparse

    p = argparse.ArgumentParser(prog="tracking-query", description=main.__doc__)
    p.add_argument("--dir", default=None, help="tracking base directory")
    p.add_argument("--project", default=None)
    p.add_argument("--name", default=None, help="run-name regex filter")
    p.add_argument("-o", "--output", default="", choices=["", "json"])
    args = p.parse_args(argv)
    for rec in query_runs(args.dir, args.project, args.name):
        if args.output == "json":
            print(json.dumps(rec, default=str))
        else:
            print(rec["project"], rec["name"], rec["steps"], rec["path"])
    return 0
