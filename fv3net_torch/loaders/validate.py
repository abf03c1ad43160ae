"""The validate-batches-config CLI (port of
``fv3net_tpu/loaders/validate.py``, console script
``validate-batches-config-torch``; reference:
external/loaders/setup.py:15): parse a batches yaml config and report
whether it is loadable, without reading the data unless --open is
passed."""
from __future__ import annotations

import argparse
import json
import sys

import yaml


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="validate-batches-config-torch")
    p.add_argument("config", help="YAML batches config")
    p.add_argument("--open", action="store_true",
                   help="also open the first batch")
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    problems = []
    loader = None
    if not isinstance(cfg, dict):
        problems.append("config must be a mapping")
    elif "mapper_config" in cfg or "function" in cfg:
        # reference-shaped BatchesLoader config (loaders/_config.py)
        from fv3net_torch.loaders import BatchesLoader

        try:
            loader = BatchesLoader.from_dict(cfg)
        except ValueError as e:
            problems.append(str(e))
    else:
        kind = cfg.get("kind", "zarr")
        if kind not in ("zarr",):
            problems.append(f"unknown kind {kind!r}")
        if "path" not in cfg:
            problems.append("missing required key 'path'")
        if "variables" not in cfg:
            problems.append("missing required key 'variables'")
    if not problems and args.open:
        from fv3net_torch.loaders import batches_from_config

        try:
            if loader is not None:
                _ = loader.load_batches()[0]
            else:
                _ = batches_from_config(cfg)[0]
        except Exception as e:  # noqa: BLE001 — report, don't crash
            problems.append(f"failed to open: {e}")
    print(json.dumps({"valid": not problems, "problems": problems}))
    return 0 if not problems else 1


if __name__ == "__main__":
    sys.exit(main())
