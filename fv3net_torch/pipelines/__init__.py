"""Offline pipelines of the port (``fv3net_tpu/pipelines``): the
coarsenings of diagnostics, restarts and surface shards, the
fine-resolution budget, the zarr conversions and their runner."""
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device on a machine without a
    card raises (the port's pipelines do not fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} asked for, but torch sees no CUDA card; pass "
            "--device cpu to run on the CPU")
    return device
