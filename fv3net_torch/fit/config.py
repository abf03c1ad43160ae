"""Optimizer, learning-rate schedule, regularizer and output-limit
configs (port of ``fv3net_tpu/fit/config.py``; reference:
external/fv3fit/fv3fit/_shared/config.py:39-80).

The reference resolves ``name`` to any optax factory.  The port writes
the update rules of five optax optimizers (``adam``, ``adamw``, ``sgd``,
``rmsprop``, ``lion``) and four schedules (``constant_schedule``,
``exponential_decay``, ``cosine_decay_schedule``,
``piecewise_constant_schedule``) under optax's names, with optax's
defaults and formulas: ``torch.optim``'s classes of the same names
differ in places (AdamW decays by 1e-2 where optax's decays by 1e-4,
RMSprop's smoothing is 0.99 where optax's decay is 0.9 and takes its eps
outside the square root, and torch has no Lion).  Any other name raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, List, Mapping, Optional

import numpy as np
import torch

__all__ = [
    "LearningRateScheduleConfig",
    "OptimizerConfig",
    "OutputLimit",
    "OutputLimitConfig",
    "RegularizerConfig",
]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to fv3net_torch yet (ROADMAP.md Queue 1 "
        "item 9)"
    )


# ------------------------------------------------------------ schedules
# functions of the update count (0 for the first update), as optax's
def constant_schedule(value: float) -> Callable[[int], float]:
    return lambda count: value


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, transition_begin: int = 0,
                      staircase: bool = False,
                      end_value: Optional[float] = None
                      ) -> Callable[[int], float]:
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    # optax's count is an int32 and its quotient here a float32, so
    # the decayed rate is a float32 value
    f32 = np.float32

    def schedule(count):
        decreased = count - transition_begin
        p = f32(decreased) / f32(transition_steps)
        if staircase:
            p = np.floor(p)
        value = (f32(init_value) if decreased <= 0
                 else f32(init_value) * np.power(f32(decay_rate), p))
        if end_value is not None:
            value = (np.maximum if decay_rate < 1.0 else np.minimum)(
                value, f32(end_value))
        return float(value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0
                          ) -> Callable[[int], float]:
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        count = min(float(count), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales=None
                                ) -> Callable[[int], float]:
    if boundaries_and_scales is not None and not all(
            s >= 0.0 for s in boundaries_and_scales.values()):
        raise ValueError("`piecewise_constant_schedule` expects "
                         "non-negative scale factors")

    def schedule(count):
        v = init_value
        for threshold, scale in sorted((boundaries_and_scales or {}).items()):
            if count >= threshold:
                v = v * scale
        return v

    return schedule


_SCHEDULES = {f.__name__: f for f in (
    constant_schedule, exponential_decay, cosine_decay_schedule,
    piecewise_constant_schedule)}


# ----------------------------------------------------------- optimizers
class Optimizer:
    """An optax update rule on a list of tensors: ``step(params, grads)``
    updates the tensors in place (``params += -lr(count) * direction``)
    and advances the update count.  ``learning_rate`` is a float or a
    schedule of the count."""

    def __init__(self, learning_rate, weight_decay: float = 0.0):
        self._lr = learning_rate
        self.weight_decay = weight_decay
        self.count = 0
        self._state: Optional[List[dict]] = None

    def direction(self, g: torch.Tensor, p: torch.Tensor,
                  s: dict) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self, p: torch.Tensor) -> dict:
        return {}

    @torch.no_grad()
    def step(self, params: List[torch.Tensor],
             grads: List[torch.Tensor]) -> None:
        if self._state is None:
            self._state = [self.init_state(p) for p in params]
        lr = self._lr(self.count) if callable(self._lr) else self._lr
        self.count += 1
        for p, g, s in zip(params, grads, self._state):
            u = self.direction(g, p, s)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(-lr * u)


class Adam(Optimizer):
    """optax.adam (and adamw with ``weight_decay``): bias-corrected first
    and second moments, m_hat / (sqrt(v_hat + eps_root) + eps)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, weight_decay=0.0):
        super().__init__(learning_rate, weight_decay)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init_state(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def direction(self, g, p, s):
        s["mu"] = (1 - self.b1) * g + self.b1 * s["mu"]
        s["nu"] = (1 - self.b2) * (g * g) + self.b2 * s["nu"]
        mu_hat = s["mu"] / (1 - self.b1 ** self.count)
        nu_hat = s["nu"] / (1 - self.b2 ** self.count)
        return mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)


class Sgd(Optimizer):
    """optax.sgd: the gradient, or its trace with ``momentum``."""

    def __init__(self, learning_rate, momentum=None, nesterov=False):
        super().__init__(learning_rate)
        self.momentum, self.nesterov = momentum, nesterov

    def init_state(self, p):
        return {"trace": torch.zeros_like(p)}

    def direction(self, g, p, s):
        if self.momentum is None:
            return g
        s["trace"] = g + self.momentum * s["trace"]
        return (g + self.momentum * s["trace"]) if self.nesterov \
            else s["trace"]


class RmsProp(Optimizer):
    """optax.rmsprop (uncentered): g / sqrt(nu + eps) with nu the decayed
    mean square, then an optional momentum trace of the scaled step."""

    def __init__(self, learning_rate, decay=0.9, eps=1e-8,
                 initial_scale=0.0, eps_in_sqrt=True, centered=False,
                 momentum=None, nesterov=False, bias_correction=False):
        if centered or bias_correction:
            raise _not_ported("optax.rmsprop with centered or "
                              "bias_correction")
        super().__init__(learning_rate)
        self.decay, self.eps, self.eps_in_sqrt = decay, eps, eps_in_sqrt
        self.initial_scale = initial_scale
        self.momentum, self.nesterov = momentum, nesterov

    def init_state(self, p):
        return {"nu": torch.full_like(p, self.initial_scale),
                "trace": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, params, grads):
        # the momentum trace follows the learning-rate scaling in optax
        if self._state is None:
            self._state = [self.init_state(p) for p in params]
        lr = self._lr(self.count) if callable(self._lr) else self._lr
        self.count += 1
        for p, g, s in zip(params, grads, self._state):
            s["nu"] = (1 - self.decay) * (g * g) + self.decay * s["nu"]
            scaling = (torch.rsqrt(s["nu"] + self.eps) if self.eps_in_sqrt
                       else 1 / (torch.sqrt(s["nu"]) + self.eps))
            u = -lr * (scaling * g)
            if self.momentum is not None:
                s["trace"] = u + self.momentum * s["trace"]
                u = (u + self.momentum * s["trace"]) if self.nesterov \
                    else s["trace"]
            p.add_(u)


class Lion(Optimizer):
    """optax.lion: sign((1 - b1) g + b1 mu), mu decayed with b2, plus
    decoupled weight decay (1e-3)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.99, weight_decay=1e-3):
        super().__init__(learning_rate, weight_decay)
        self.b1, self.b2 = b1, b2

    def init_state(self, p):
        return {"mu": torch.zeros_like(p)}

    def direction(self, g, p, s):
        u = torch.sign((1.0 - self.b1) * g + self.b1 * s["mu"])
        s["mu"] = (1 - self.b2) * g + self.b2 * s["mu"]
        return u


#: optax's names; adamw is adam with optax's decoupled decay of 1e-4
_OPTIMIZERS = {"adam": Adam,
               "adamw": functools.partial(Adam, weight_decay=1e-4),
               "sgd": Sgd, "rmsprop": RmsProp, "lion": Lion}


@dataclasses.dataclass
class LearningRateScheduleConfig:
    """``name``: one of optax's schedule names the port has
    (constant_schedule, exponential_decay, cosine_decay_schedule,
    piecewise_constant_schedule); ``kwargs`` pass through."""

    name: str
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def instance(self) -> Callable[[int], float]:
        if self.name not in _SCHEDULES:
            raise _not_ported(f"the optax schedule {self.name!r}")
        return _SCHEDULES[self.name](**self.kwargs)


@dataclasses.dataclass
class OptimizerConfig:
    """``name``: adam, adamw, sgd, rmsprop or lion (optax's names; the
    Keras names ``Adam``/``SGD`` map lowercase); ``kwargs`` pass through;
    a ``learning_rate_schedule`` replaces ``learning_rate``."""

    name: str = "adam"
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    learning_rate_schedule: Optional[LearningRateScheduleConfig] = None

    @property
    def instance(self) -> Optimizer:
        name = self.name.lower()
        if name not in _OPTIMIZERS:
            raise _not_ported(f"the optax optimizer {self.name!r}")
        kwargs = dict(self.kwargs)
        if self.learning_rate_schedule is not None:
            kwargs["learning_rate"] = self.learning_rate_schedule.instance
        return _OPTIMIZERS[name](**kwargs)


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
