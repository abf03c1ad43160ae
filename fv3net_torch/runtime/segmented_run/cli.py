"""The segmented run's CLI (port of ``runfv3``,
``fv3net_tpu/runtime/segmented_run/cli.py``): subcommands create, append
and run-native, on the card unless ``--device`` says otherwise.

    python -m fv3net_torch.runtime.segmented_run.cli create URL CONFIG
    python -m fv3net_torch.runtime.segmented_run.cli append URL [--segments N]
    python -m fv3net_torch.runtime.segmented_run.cli run-native CONFIG URL
"""
from __future__ import annotations

import argparse
import sys

import yaml


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("runfv3-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_create = sub.add_parser("create", help="initialize a run directory")
    p_create.add_argument("url")
    p_create.add_argument("config", help="path to config yaml")

    p_append = sub.add_parser("append", help="run the next segment")
    p_append.add_argument("url")
    p_append.add_argument(
        "--segments", type=int, default=1, help="number of segments to run"
    )
    p_append.add_argument(
        "--profile",
        action="store_true",
        help="record a torch.profiler trace to <segment>/profile",
    )

    p_native = sub.add_parser(
        "run-native", help="create + run one segment in place"
    )
    p_native.add_argument("config")
    p_native.add_argument("url")
    for p in (p_append, p_native):
        p.add_argument("--device", default="cuda",
                       help="torch device of the run (default: cuda)")

    args = parser.parse_args(argv)
    from fv3net_torch.runtime.segmented_run import api

    if args.command == "create":
        with open(args.config) as f:
            config = yaml.safe_load(f)
        api.create(args.url, config)
    elif args.command == "append":
        for _ in range(args.segments):
            print(api.append_segment(args.url, profile=args.profile,
                                     device=args.device))
    elif args.command == "run-native":
        with open(args.config) as f:
            config = yaml.safe_load(f)
        api.create(args.url, config)
        print(api.append_segment(args.url, device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
