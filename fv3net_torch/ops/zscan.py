"""Vertical prefix and suffix sums (port of ``fv3net_tpu/ops/zscan.py``).

The reference offers a triangular-matmul form for the TPU behind
``FV3NET_ZSCAN_MATMUL``; the port computes the sums directly.
"""
from __future__ import annotations

import torch


def cumsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inclusive cumulative sum along ``axis``."""
    return torch.cumsum(x, dim=axis)


def suffix_sum_strict(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """out[..., j] = sum_{i > j} x[..., i] (zero at the last index)."""
    rev = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis), (axis,))
    tail = rev.narrow(axis, 1, x.shape[axis] - 1)
    return torch.cat([tail, torch.zeros_like(x.narrow(axis, 0, 1))], dim=axis)
