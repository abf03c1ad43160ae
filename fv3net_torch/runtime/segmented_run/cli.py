"""The segmented run's CLI (port of ``runfv3``,
``fv3net_tpu/runtime/segmented_run/cli.py``): subcommands create, append
and run-native, on the card unless ``--device`` says otherwise.

    python -m fv3net_torch.runtime.segmented_run.cli create URL CONFIG
    python -m fv3net_torch.runtime.segmented_run.cli append URL [--segments N]
    python -m fv3net_torch.runtime.segmented_run.cli run-native CONFIG URL

A config whose namelist ``layout`` is [py, px] runs as py * px processes
under ``torchrun`` (one per block), e.g.

    torchrun --nproc-per-node 4 -m fv3net_torch.runtime.segmented_run.cli \
        append URL

Each process joins the process group torchrun describes (NCCL on the
card, each rank on ``cuda:<local rank>``; gloo with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import os
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

    device = getattr(args, "device", "cuda")
    rank = _join_process_group(device)
    if device.startswith("cuda") and rank is not None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    if rank:  # only rank 0 creates the run directory
        if args.command == "create":
            return 0
        if args.command == "run-native":
            _barrier()  # rank 0's create
            args.command = "append"

    if args.command == "create":
        with open(args.config) as f:
            config = yaml.safe_load(f)
        api.create(args.url, config)
    elif args.command == "append":
        for _ in range(getattr(args, "segments", 1)):
            print(api.append_segment(args.url,
                                     profile=getattr(args, "profile", False),
                                     device=device))
    elif args.command == "run-native":
        with open(args.config) as f:
            config = yaml.safe_load(f)
        api.create(args.url, config)
        if rank is not None:
            _barrier()
        print(api.append_segment(args.url, device=device))
    return 0


def _join_process_group(device: str):
    """Under torchrun (WORLD_SIZE > 1 in the environment) join its process
    group and return this rank; None for a single process."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if not dist.is_initialized():
        if device.startswith("cuda"):
            import torch

            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if device.startswith("cuda") else "gloo")
    return dist.get_rank()


def _barrier():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


if __name__ == "__main__":
    sys.exit(main())
