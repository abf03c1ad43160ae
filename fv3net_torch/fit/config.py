"""Optimizer, learning-rate schedule, regularizer and output-limit
configs (port of ``fv3net_tpu/fit/config.py``; reference:
external/fv3fit/fv3fit/_shared/config.py:39-80).

The reference resolves ``name`` with ``getattr(optax, name)``.  The port
resolves every optimizer of optax 0.2.6 (its 30 aliases, written in
``fit/optimizers.py``: adabelief, adadelta, adafactor, adagrad, adam,
adamax, adamaxw, adamw, adan, amsgrad, fromage, lamb, lars, lbfgs, lion,
nadam, nadamw, noisy_sgd, novograd, optimistic_adam, optimistic_adam_v2,
optimistic_gradient_descent, polyak_sgd, radam, rmsprop, rprop, sgd,
sign_sgd, sm3, yogi) and every schedule (its 14, in
``fit/schedules.py``: constant_schedule, cosine_decay_schedule,
cosine_onecycle_schedule, exponential_decay, join_schedules,
linear_onecycle_schedule, linear_schedule, piecewise_constant_schedule,
piecewise_interpolate_schedule, polynomial_schedule, sgdr_schedule,
warmup_constant_schedule, warmup_cosine_decay_schedule,
warmup_exponential_decay_schedule), with optax's defaults and formulas.
Any other name raises the reference's ``ValueError``; optax's
gradient-transformation building blocks (``scale_by_adam``,
``clip_by_global_norm``, ...), which the reference's ``getattr`` also
finds, are among them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from fv3net_torch.fit.optimizers import (  # noqa: F401  (the rules' names)
    OPTIMIZERS,
    AdaBelief,
    Adagrad,
    Adam,
    Adamax,
    AmsGrad,
    Lion,
    Optimizer,
    RAdam,
    RmsProp,
    Sgd,
    Yogi,
)
from fv3net_torch.fit.schedules import (  # noqa: F401  (the schedules)
    SCHEDULES,
    constant_schedule,
    cosine_decay_schedule,
    cosine_onecycle_schedule,
    exponential_decay,
    linear_schedule,
    piecewise_constant_schedule,
    polynomial_schedule,
    warmup_cosine_decay_schedule,
    warmup_exponential_decay_schedule,
)

__all__ = [
    "LearningRateScheduleConfig",
    "OptimizerConfig",
    "OutputLimit",
    "OutputLimitConfig",
    "RegularizerConfig",
]


@dataclasses.dataclass
class LearningRateScheduleConfig:
    """``name``: one of optax's schedules (the module docstring lists
    them); ``kwargs`` pass through."""

    name: str
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def instance(self) -> Callable[[int], float]:
        if self.name not in SCHEDULES:
            raise ValueError(f"unknown optax schedule {self.name!r}")
        return SCHEDULES[self.name](**self.kwargs)


@dataclasses.dataclass
class OptimizerConfig:
    """``name``: one of optax's optimizers (the module docstring lists
    them; the Keras names ``Adam``/``SGD`` map lowercase); ``kwargs``
    pass through; a ``learning_rate_schedule`` replaces
    ``learning_rate``."""

    name: str = "adam"
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    learning_rate_schedule: Optional[LearningRateScheduleConfig] = None

    @property
    def instance(self) -> Optimizer:
        name = self.name.lower()
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optax optimizer {self.name!r}")
        kwargs = dict(self.kwargs)
        if self.learning_rate_schedule is not None:
            kwargs["learning_rate"] = self.learning_rate_schedule.instance
        return OPTIMIZERS[name](**kwargs)


@dataclasses.dataclass
class OutputLimit:
    """Optional min/max bounds for one output variable; ``limit_array``
    clamps (the reference's nested tf.where is exactly a clip)."""

    min: Optional[float] = None
    max: Optional[float] = None

    def __post_init__(self):
        if self.min is not None and self.max is not None:
            if self.max <= self.min:
                raise ValueError(
                    f"max value ({self.max}) must be greater than min "
                    f"value ({self.min})."
                )

    def limit_array(self, x: torch.Tensor) -> torch.Tensor:
        if self.min is None and self.max is None:
            return x
        return torch.clamp(x, min=self.min, max=self.max)


@dataclasses.dataclass
class OutputLimitConfig:
    """Per-output-variable range limits of a model's predictions:
    ``limits`` maps output names to :class:`OutputLimit`; unlisted
    outputs pass through.  ``limit_packed`` clamps a packed [sample,
    feature] prediction in one ``torch.clamp`` against per-feature
    bounds."""

    limits: Mapping[str, OutputLimit] = dataclasses.field(
        default_factory=dict
    )

    def __post_init__(self):
        self.limits = {
            k: v if isinstance(v, OutputLimit) else OutputLimit(**dict(v))
            for k, v in dict(self.limits).items()
        }

    def __bool__(self) -> bool:
        return any(
            v.min is not None or v.max is not None
            for v in self.limits.values()
        )

    def apply_limits(self, outputs: Mapping[str, torch.Tensor]) -> dict:
        return {
            name: (self.limits[name].limit_array(arr)
                   if name in self.limits else arr)
            for name, arr in outputs.items()
        }

    def packed_bounds(self, names, features):
        """(min_vec, max_vec) float32 [total_features], +-inf where
        unbounded, in the packed feature layout."""
        lo, hi = [], []
        for name, nf in zip(names, features):
            lim = self.limits.get(name, OutputLimit())
            lo += [(-np.inf if lim.min is None else lim.min)] * nf
            hi += [(np.inf if lim.max is None else lim.max)] * nf
        return np.asarray(lo, np.float32), np.asarray(hi, np.float32)

    def limit_packed(self, Y: torch.Tensor, info) -> torch.Tensor:
        if not self:
            return Y
        lo, hi = self.packed_bounds(info.names, info.features)
        return torch.clamp(
            Y, torch.as_tensor(lo, dtype=Y.dtype, device=Y.device),
            torch.as_tensor(hi, dtype=Y.dtype, device=Y.device))

    def to_dict(self) -> dict:
        return {name: {"min": lim.min, "max": lim.max}
                for name, lim in self.limits.items()}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "OutputLimitConfig":
        return cls(limits=dict(d or {}))


@dataclasses.dataclass
class RegularizerConfig:
    """Weight penalty: 'none', 'l1', 'l2' or 'l1_l2' with strengths in
    ``kwargs`` (default 0.01).  ``penalty`` covers the weights only: the
    reference leaves out 1-D leaves (the biases)."""

    name: str = "none"
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def penalty(self, params) -> torch.Tensor:
        """params: a list of {"w": ..., ...} layers."""
        leaves = [x for layer in params for x in layer.values()]
        name = self.name.lower()
        if name == "none" or not leaves:
            return torch.zeros(())
        l1 = float(self.kwargs.get("l1", 0.01 if "l1" in name else 0.0))
        l2 = float(self.kwargs.get("l2", 0.01 if name.endswith("l2")
                                   else 0.0))
        total = torch.zeros((), dtype=leaves[0].dtype,
                            device=leaves[0].device)
        for leaf in leaves:
            if leaf.ndim < 2:
                continue
            if l1:
                total = total + l1 * torch.sum(torch.abs(leaf))
            if l2:
                total = total + l2 * torch.sum(leaf * leaf)
        return total
