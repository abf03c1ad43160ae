"""scream-run CLI (port of ``fv3net_tpu/scream_run/cli.py``, console
script ``scream-run-torch``; reference:
prognostic_scream_run/scream_run/cli.py:37-70 — `write_rundir CONFIG
RUNDIR` and `run CONFIG RUNDIR`).  ``run`` takes ``--device`` (default
``cuda``; without a card that raises: pass ``--device cpu``)."""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from fv3net_torch.scream_run.config import ScreamConfig

# the run's dtype, the models' and the TimeLoop's (the reference runs its
# TimeLoop in its default float32)
DTYPE = torch.float32


def _write_rundir(args) -> int:
    cfg = ScreamConfig.from_yaml(args.config)
    rundir = cfg.write_rundir(args.rundir)
    print(json.dumps({"rundir": rundir, "case": cfg.CASE_NAME}))
    return 0


def _run(args) -> int:
    """Run the case: the reference execs the CIME-built E3SM binary; here
    the atmosphere is this port's per-step TimeLoop on ``--device``, on
    an equivalent grid (ScreamConfig.npx maps the ne-resolution), with
    the SCREAM-named ML correction as its postphysics stepper when
    configured."""
    from fv3net_torch.pipelines import resolve_device
    from fv3net_torch.runtime.config import NamelistConfig, UserConfig
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.scream_run.scream_names import ScreamMLStepper

    device = resolve_device(args.device)
    dtype = DTYPE
    cfg = ScreamConfig.from_yaml(args.config)
    os.makedirs(args.rundir, exist_ok=True)

    stepper = None
    if cfg.machine_learning:
        from fv3net_torch.scream_run.ml import MachineLearningConfig, open_model

        ml_cfg = MachineLearningConfig(**cfg.machine_learning)
        stepper = ScreamMLStepper(
            open_model(ml_cfg, device=device, dtype=dtype), cfg.dt_atmos,
            ml_cfg
        )
    user_cfg = UserConfig(
        namelist=NamelistConfig(
            npx=cfg.npx, npz=cfg.npz, dt_atmos=cfg.dt_atmos
        ),
        duration_seconds=cfg.duration_seconds,
    )
    loop = TimeLoop(user_cfg, postphysics_stepper=stepper, dtype=dtype,
                    device=device)
    n = 0
    for _time, _diags in loop:
        n += 1
    print(json.dumps({"case": cfg.CASE_NAME, "steps_completed": n}))
    return 0


def _prepare_config(args) -> int:
    """Normalize an input (config-file path OR literal YAML text) into a
    config file; ``--precompiled-case`` forces ``create_newcase: false``
    (reference cli.py:71-91 prepare_config)."""
    import shutil

    import yaml

    if os.path.exists(args.input):
        shutil.copy(args.input, args.output_config)
    else:
        with open(args.output_config, "w") as f:
            f.write(args.input)
    if args.precompiled_case:
        with open(args.output_config) as f:
            cfg = yaml.safe_load(f) or {}
        cfg["create_newcase"] = False
        with open(args.output_config, "w") as f:
            yaml.safe_dump(cfg, f)
    print(json.dumps({"output_config": args.output_config}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scream-run-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("write-rundir", help="materialize the case rundir")
    w.add_argument("config")
    w.add_argument("rundir")
    w.set_defaults(fn=_write_rundir)
    r = sub.add_parser("run", help="run the case")
    r.add_argument("config")
    r.add_argument("rundir")
    r.add_argument("--device", default="cuda",
                   help="torch device of the run (default: cuda)")
    r.set_defaults(fn=_run)
    pc = sub.add_parser(
        "prepare-config",
        help="normalize a config path or literal YAML into a config file",
    )
    pc.add_argument("input")
    pc.add_argument("output_config")
    pc.add_argument("--precompiled-case", action="store_true")
    pc.set_defaults(fn=_prepare_config)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
