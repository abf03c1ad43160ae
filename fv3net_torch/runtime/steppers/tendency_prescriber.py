"""Tendency prescriber: apply externally stored tendencies in the loop
(port of ``fv3net_tpu/runtime/steppers/tendency_prescriber.py``;
reference: workflows/prognostic_c48_run/runtime/tendency_prescriber.py,
built at runtime/factories.py:75-82 with a DatasetQuantileLimiter and a
time-interpolating dataset getter)."""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.ops.limit import DatasetQuantileLimiter
from fv3net_torch.runtime.derived_state import DerivedState


class TendencyPrescriber:
    """Add dataset-provided tendencies (dQ1/dQ2/...) each step, with
    optional quantile limiting of outliers.  The limiter is fitted on the
    first call's data and clips on ``device``; the tendencies come out as
    tensors on ``device`` (default: the CPU) in the data's dtype."""

    label = "tendency_prescriber"

    def __init__(
        self,
        data_getter: Callable,  # time -> Dataset of tendency Quantities
        variables: Sequence[str],
        limit_quantiles: Optional[Mapping[str, float]] = None,
        device=None,
    ):
        self.data_getter = data_getter
        self.variables = list(variables)
        self._limiter: Optional[DatasetQuantileLimiter] = None
        self._limit_quantiles = limit_quantiles
        self._device = device

    @property
    def limiter(self) -> Optional[DatasetQuantileLimiter]:
        """The fitted limiter (None before the first call or without
        ``limit_quantiles``)."""
        return self._limiter

    def _maybe_fit_limiter(self, ds: Dataset) -> Dataset:
        if self._limit_quantiles is None:
            return ds
        if self._limiter is None:
            self._limiter = DatasetQuantileLimiter(
                self._limit_quantiles["upper"],
                self._limit_quantiles["lower"],
                limit_only=self.variables,
            ).fit(ds)
        return self._limiter.transform(ds, device=self._device)

    def __call__(self, time, state: DerivedState):
        data = self.data_getter(time)
        ds = Dataset({v: data[v] for v in self.variables})
        ds = self._maybe_fit_limiter(ds)
        tendencies: Dict[str, Quantity] = {}
        for v in self.variables:
            q = ds[v]
            tendencies[v] = Quantity(
                torch.as_tensor(q.data, device=self._device), q.dims,
                q.units)
        return tendencies, {}, {}
