"""Global scalar metrics: area-weighted means for the JSON step log
(port of ``fv3net_tpu/runtime/metrics.py``; reference:
workflows/prognostic_c48_run/runtime/metrics.py:18-56).

The means are computed on the device and stacked into one vector, which
its caller copies to the host once per chunk (:class:`GlobalMeans`).
The reference's batching of those copies across chunks
(``ScalarBatcher``), shaped by its TPU link, is not reproduced.
"""
from __future__ import annotations

import json
import logging
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from fv3net_torch.core.quantity import Quantity

logger = logging.getLogger("statistics")

#: the reserved diagnostics key under which a producer hands over means
#: it already computed (the fused chunk computes them in its own pass)
GLOBAL_MEANS_KEY = "__global_means__"


def mean_impl(f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Area-weighted mean over (tile, y, x); a 3-D field is first
    averaged over its levels (axis 1).  On a sharded block the sums of
    f w and w are all-reduced over the ranks."""
    from fv3net_torch.parallel import sharded

    if f.ndim == 4:
        f = f.mean(dim=1)
    if sharded.active() is None:
        return (f * w).sum() / w.sum()
    num, den = sharded.all_reduce(torch.stack([(f * w).sum(), w.sum()]))
    return num / den


class GlobalMeans:
    """Global scalar means riding along a diagnostics dict under
    :data:`GLOBAL_MEANS_KEY`: ``names`` (ordered) and ``data`` (a device
    vector, copied to the host by its reader)."""

    def __init__(self, names, data):
        self.names = list(names)
        self.data = data


def global_means(diagnostics: Mapping[str, Quantity], area: torch.Tensor
                 ) -> Tuple[List[str], Optional[torch.Tensor]]:
    """``(names, device vector)`` of the area-weighted means of every
    [tile, y, x] field of ``diagnostics``, by sorted name; those a
    producer computed already when it carries a :class:`GlobalMeans`."""
    pre = diagnostics.get(GLOBAL_MEANS_KEY)
    if isinstance(pre, GlobalMeans):
        return pre.names, pre.data
    fields = {}
    for name, q in diagnostics.items():
        if name == GLOBAL_MEANS_KEY:
            continue
        arr = torch.as_tensor(q.data if isinstance(q, Quantity) else q)
        if arr.ndim == 3 and tuple(arr.shape[-2:]) == tuple(area.shape[-2:]):
            fields[name] = arr
    if not fields:
        return [], None
    names = sorted(fields)  # the reference's order (a jitted dict's)
    return names, torch.stack(
        [mean_impl(fields[k].to(area.device), area) for k in names])


def log_scalar(time, scalars: Dict[str, float]) -> None:
    """One JSON line of the ``statistics`` logger: the time and the
    scalars."""
    logger.info(
        json.dumps({"time": str(time), **{k: float(v) for k, v in
                                          scalars.items()}})
    )
