"""Hyperparameter sweeps (port of ``fv3net_tpu/fit/sweep.py``;
reference: fv3fit's wandb sweep integration,
external/fv3fit/fv3fit/train.py:119-134 and
workflows/argo/wandb-sweep.yaml).

The sweep config (grid or random over dotted-path parameter spaces)
expands as the reference's does; each trial trains with ``train_main``
through the port's pipeline runner (``pipelines/runner.py``) on the
batches it is given, and logs one tracking run (``fit/tracking.py``:
its assignment as config, its output path), which
``tracking-query-torch`` lists.  The reference's docstring promises that
run and its code logs none (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import copy
import itertools
import random as _random
from typing import Any, Dict, List

from fv3net_torch.pipelines.runner import run_pipeline


def _set_dotted(d: Dict[str, Any], path: str, value) -> None:
    keys = path.split(".")
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def expand_sweep(sweep_config: Dict[str, Any],
                 seed: int = 0) -> List[Dict[str, Any]]:
    """Sweep config -> list of parameter assignments.

    ``{"method": "grid"|"random", "count": N (random only),
       "parameters": {"dotted.path": {"values": [...]} |
                      {"min": a, "max": b}}}``
    (the wandb sweep-config subset the reference uses)."""
    method = sweep_config.get("method", "grid")
    params = sweep_config["parameters"]
    if method == "grid":
        names = list(params)
        value_lists = []
        for n in names:
            spec = params[n]
            if "values" not in spec:
                raise ValueError(f"grid sweeps need 'values' for {n}")
            value_lists.append(spec["values"])
        return [
            dict(zip(names, combo))
            for combo in itertools.product(*value_lists)
        ]
    if method == "random":
        rng = _random.Random(seed)
        count = int(sweep_config.get("count", 10))
        out = []
        for _ in range(count):
            trial = {}
            for n, spec in params.items():
                if "values" in spec:
                    trial[n] = rng.choice(spec["values"])
                else:
                    lo, hi = float(spec["min"]), float(spec["max"])
                    val = rng.uniform(lo, hi)
                    if spec.get("distribution") == "log_uniform":
                        import math

                        val = math.exp(
                            rng.uniform(math.log(lo), math.log(hi))
                        )
                    trial[n] = val
            out.append(trial)
        return out
    raise ValueError(f"unknown sweep method {method!r}")


def run_sweep(
    base_config: Dict[str, Any],
    sweep_config: Dict[str, Any],
    train_batches,
    output_root: str,
    validation_batches=None,
    max_workers: int = 1,
    seed: int = 0,
):
    """Train one model per sweep trial; returns pipeline ItemResults whose
    values are the per-trial output paths.  Each trial logs a tracking
    run ``trial_NNN`` of project "sweep" under ``output_root/tracking``."""
    import os

    from fv3net_torch.fit import tracking
    from fv3net_torch.fit.train import train_main

    trials = expand_sweep(sweep_config, seed=seed)
    base = os.path.join(output_root, "tracking")

    def one(indexed) -> str:
        i, assignment = indexed
        cfg = copy.deepcopy(base_config)
        for path, value in assignment.items():
            _set_dotted(cfg, path, value)
        out = os.path.join(output_root, f"trial_{i:03d}")
        train_main(cfg, train_batches, validation_batches, out)
        run = tracking.Run(project="sweep", name=f"trial_{i:03d}",
                           dir=os.path.join(base, "sweep", f"trial_{i:03d}"),
                           config={"assignment": assignment,
                                   "training": cfg})
        run.log({"trial": i, "output": out})
        run.finish()
        return out

    return run_pipeline(
        list(enumerate(trials)), one, max_workers=max_workers,
        num_retries=0,
    )


def main(argv=None) -> int:
    """python -m fv3net_torch.fit.sweep <sweep.yaml> <data.yaml> <output>
    [--device cuda|cpu] (the wandb-sweep Argo template role): the sweep
    yaml holds a ``base`` training config plus
    ``method``/``parameters``/``count``; the data config is read as
    ``fv3fit-train-torch`` reads it, the batches moved to ``--device``
    (default cuda: without a card it raises)."""
    import argparse
    import json

    import yaml

    from fv3net_torch.fit.train import (batches_on, config_variables,
                                        open_batches)
    from fv3net_torch.pipelines import resolve_device

    p = argparse.ArgumentParser(prog="fv3fit-sweep-torch")
    p.add_argument("sweep_config")
    p.add_argument("training_data_config")
    p.add_argument("output_root")
    p.add_argument("--max-workers", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    with open(args.sweep_config) as f:
        sweep_yaml = yaml.safe_load(f)
    base = sweep_yaml.pop("base")
    with open(args.training_data_config) as f:
        data_config = yaml.safe_load(f)
    batches = list(batches_on(
        open_batches(data_config, config_variables(base)), device))
    results = run_sweep(
        base, sweep_yaml, batches, args.output_root,
        max_workers=args.max_workers,
    )
    print(json.dumps({
        "trials": [r.value for r in results if r.ok],
        "failed": sum(1 for r in results if not r.ok),
    }))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
