"""Quantile limiting of dataset outliers (port of
``fv3net_tpu/ops/limit.py``; reference: external/vcm/vcm/limit.py
DatasetQuantileLimiter, used by the tendency prescriber).

The bounds are fitted once, on host data, with ``np.quantile`` (linear
interpolation, as ``jnp.quantile``): ``torch.quantile`` refuses inputs of
more than 2**24 elements, and a C48 store of a day's tendencies is
larger.  The clipping runs on tensors, on the device of the data (or the
one ``transform`` is given).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity


def _host(data) -> np.ndarray:
    if torch.is_tensor(data):
        return data.detach().cpu().numpy()
    return np.asarray(data)


class DatasetQuantileLimiter:
    """Clip each variable to fitted [lower, upper] quantiles."""

    def __init__(
        self,
        upper_quantile_limit: float,
        lower_quantile_limit: float,
        limit_only: Optional[Sequence[str]] = None,
    ):
        self._upper_q = upper_quantile_limit
        self._lower_q = lower_quantile_limit
        self._limit_only = limit_only
        self._lower: Optional[Dict[str, np.ndarray]] = None
        self._upper: Optional[Dict[str, np.ndarray]] = None

    @property
    def bounds(self) -> Dict[str, tuple]:
        """name -> (lower, upper) as fitted (numpy, host)."""
        if self._lower is None:
            raise ValueError("limiter must be fit before its bounds are read")
        return {k: (self._lower[k], self._upper[k]) for k in self._lower}

    def fit(self, ds: Dataset, feature_dims: Optional[Sequence[str]] = None
            ) -> "DatasetQuantileLimiter":
        """Quantiles computed over all dims not in ``feature_dims``."""
        names = self._limit_only if self._limit_only is not None else list(ds)
        self._lower = {}
        self._upper = {}
        for name in names:
            q = ds[name]
            if feature_dims:
                axes = tuple(
                    i for i, d in enumerate(q.dims) if d not in feature_dims
                )
            else:
                axes = tuple(range(q.ndim))
            arr = _host(q.data)
            self._lower[name] = np.quantile(arr, self._lower_q, axis=axes)
            self._upper[name] = np.quantile(arr, self._upper_q, axis=axes)
        return self

    def transform(self, ds: Dataset, deepcopy: bool = False,
                  device=None) -> Dataset:
        """``ds`` with each fitted variable clipped to its bounds, as a
        tensor on ``device`` (default: the data's own, the CPU for numpy
        data); other variables pass through."""
        if self._lower is None:
            raise ValueError("limiter must be fit before transform")
        out = {}
        for name in ds:
            q = ds[name]
            if name in self._lower:
                data = torch.as_tensor(q.data, device=device)

                def bound(b):
                    return torch.as_tensor(b, dtype=data.dtype,
                                           device=data.device)

                arr = torch.clamp(data, bound(self._lower[name]),
                                  bound(self._upper[name]))
                out[name] = Quantity(arr, q.dims, q.units, dict(q.attrs))
            else:
                out[name] = q
        return Dataset(out)
