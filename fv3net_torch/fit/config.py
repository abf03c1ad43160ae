"""Optimizer, learning-rate schedule, regularizer and output-limit
configs (port of ``fv3net_tpu/fit/config.py``; reference:
external/fv3fit/fv3fit/_shared/config.py:39-80).

The reference resolves ``name`` to any optax factory.  The port writes
the update rules of optax 0.2.6's ``adam``, ``adamw``, ``nadam``,
``sgd``, ``rmsprop`` (centered, momentum, nesterov, bias correction),
``lion``, ``adagrad``, ``adamax``, ``radam``, ``amsgrad``, ``adabelief``
and ``yogi``, and its schedules ``constant_schedule``,
``exponential_decay``, ``cosine_decay_schedule``,
``piecewise_constant_schedule``, ``linear_schedule``,
``polynomial_schedule``, ``warmup_cosine_decay_schedule``,
``warmup_exponential_decay_schedule`` and ``cosine_onecycle_schedule``,
under optax's names, with optax's defaults and formulas:
``torch.optim``'s classes of the same names differ in places (AdamW
decays by 1e-2 where optax's decays by 1e-4, RMSprop's smoothing is 0.99
where optax's decay is 0.9 and takes its eps outside the square root,
Adagrad's accumulator starts at 0 where optax's starts at 0.1, and torch
has no Lion or Yogi).  Any other name raises ``NotImplementedError``.
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
        "item 9: the optax factories left)"
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


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int, transition_begin: int = 0
                        ) -> Callable[[int], float]:
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    # optax's count is an int32 and its quotient here a float32, so the
    # rate is a float32 value
    f32 = np.float32

    def schedule(count):
        count = min(max(count - transition_begin, 0), transition_steps)
        frac = f32(1) - f32(count) / f32(transition_steps)
        return float(f32(init_value - end_value) * (frac ** f32(power))
                     + f32(end_value))

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int, transition_begin: int = 0
                    ) -> Callable[[int], float]:
    return polynomial_schedule(init_value, end_value, 1, transition_steps,
                               transition_begin)


def _join_schedules(first, then, boundary: int) -> Callable[[int], float]:
    # optax.join_schedules of two: the second counts from its boundary.
    # Its jnp.where takes the dtype of the float32 warm-up (the second
    # schedule's value is weakly typed), so the joined rate is float32
    return lambda count: float(np.float32(
        first(count) if count < boundary else then(count - boundary)))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0
                                 ) -> Callable[[int], float]:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return _join_schedules(
        linear_schedule(init_value, peak_value, warmup_steps),
        cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                              alpha=alpha, exponent=exponent),
        warmup_steps)


def warmup_exponential_decay_schedule(
        init_value: float, peak_value: float, warmup_steps: int,
        transition_steps: int, decay_rate: float, transition_begin: int = 0,
        staircase: bool = False, end_value: Optional[float] = None
) -> Callable[[int], float]:
    return _join_schedules(
        linear_schedule(init_value, peak_value, warmup_steps),
        exponential_decay(peak_value, transition_steps, decay_rate,
                          transition_begin, staircase, end_value),
        warmup_steps)


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4
                             ) -> Callable[[int], float]:
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a "
                         "non-positive `transition_steps`")
    # optax.piecewise_interpolate_schedule("cosine", ...): cosine steps
    # between the cumulative products of the scales at the boundaries
    scales = {int(pct_start * transition_steps): div_factor,
              int(transition_steps): 1.0 / (div_factor * final_div_factor)}
    boundaries, factors = zip(*sorted(scales.items()))
    bounds = np.stack((0,) + boundaries)
    values = np.cumprod(np.stack((peak_value / div_factor,) + factors))

    def schedule(count):
        out = values[-1] if bounds[-1] <= count else 0.0
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                out += end + (start - end) / 2.0 * (np.cos(np.pi * pct) + 1)
        return float(out)

    return schedule


_SCHEDULES = {f.__name__: f for f in (
    constant_schedule, exponential_decay, cosine_decay_schedule,
    piecewise_constant_schedule, polynomial_schedule, linear_schedule,
    warmup_cosine_decay_schedule, warmup_exponential_decay_schedule,
    cosine_onecycle_schedule)}


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


def _bias_corrected(moment: torch.Tensor, decay: float, count: int):
    return moment / (1 - decay ** count)


class Adam(Optimizer):
    """optax.adam (adamw with ``weight_decay``, nadam with ``nesterov``):
    bias-corrected first and second moments, m_hat / (sqrt(v_hat +
    eps_root) + eps); with ``nesterov`` m_hat is b1 m / (1 - b1^(t+1)) +
    (1 - b1) g / (1 - b1^t)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, weight_decay=0.0, nesterov=False):
        super().__init__(learning_rate, weight_decay)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.nesterov = nesterov

    def init_state(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def first_moment(self, g, s):
        s["mu"] = (1 - self.b1) * g + self.b1 * s["mu"]
        if self.nesterov:
            return (self.b1 * _bias_corrected(s["mu"], self.b1,
                                              self.count + 1)
                    + (1 - self.b1) * _bias_corrected(g, self.b1,
                                                      self.count))
        return _bias_corrected(s["mu"], self.b1, self.count)

    def second_moment(self, g, s):
        s["nu"] = (1 - self.b2) * (g * g) + self.b2 * s["nu"]
        return _bias_corrected(s["nu"], self.b2, self.count)

    def direction(self, g, p, s):
        mu_hat = self.first_moment(g, s)
        nu_hat = self.second_moment(g, s)
        return mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)


class AmsGrad(Adam):
    """optax.amsgrad: Adam over the running maximum of nu_hat."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0):
        super().__init__(learning_rate, b1, b2, eps, eps_root)

    def init_state(self, p):
        return {**super().init_state(p), "nu_max": torch.zeros_like(p)}

    def second_moment(self, g, s):
        s["nu_max"] = torch.maximum(s["nu_max"], super().second_moment(g, s))
        return s["nu_max"]


class RAdam(Adam):
    """optax.radam: Adam's step times the variance rectification r where
    the SMA length ro reaches ``threshold``, the bias-corrected first
    moment alone before."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, threshold=5.0, nesterov=False):
        super().__init__(learning_rate, b1, b2, eps, eps_root,
                         nesterov=nesterov)
        self.threshold = threshold

    def direction(self, g, p, s):
        mu_hat = self.first_moment(g, s)
        nu_hat = self.second_moment(g, s)
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = self.b2 ** self.count
        ro = ro_inf - 2 * self.count * b2t / (1 - b2t)
        if ro < self.threshold:
            return mu_hat
        r2 = ((ro - 4.0) * (ro - 2.0) * ro_inf
              / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        r = math.sqrt(r2) if r2 >= 0 else math.nan  # as jnp.sqrt
        return r * mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)


class AdaBelief(Adam):
    """optax.adabelief: the second moment of the prediction error g - mu
    (plus eps_root), m_hat / (sqrt(s_hat) + eps)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-16,
                 eps_root=1e-16, nesterov=False):
        super().__init__(learning_rate, b1, b2, eps, eps_root,
                         nesterov=nesterov)

    def direction(self, g, p, s):
        mu_hat = self.first_moment(g, s)
        err = g - s["mu"]
        s["nu"] = (1 - self.b2) * (err * err) + self.b2 * s["nu"]
        s["nu"] = s["nu"] + self.eps_root
        nu_hat = _bias_corrected(s["nu"], self.b2, self.count)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps)


class Yogi(Adam):
    """optax.yogi: both moments start at 1e-6; nu moves by (1 - b2) g^2
    toward g^2 with the sign of (nu - g^2)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-3):
        super().__init__(learning_rate, b1, b2, eps)

    def init_state(self, p):
        return {"mu": torch.full_like(p, 1e-6), "nu": torch.full_like(p, 1e-6)}

    def second_moment(self, g, s):
        g2 = g * g
        s["nu"] = s["nu"] - (1 - self.b2) * torch.sign(s["nu"] - g2) * g2
        return _bias_corrected(s["nu"], self.b2, self.count)


class Adamax(Adam):
    """optax.adamax: the bias-corrected first moment over the decayed
    infinity norm max(|g| + eps, b2 nu)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(learning_rate, b1, b2, eps)

    def direction(self, g, p, s):
        mu_hat = self.first_moment(g, s)
        s["nu"] = torch.maximum(torch.abs(g) + self.eps, self.b2 * s["nu"])
        return mu_hat / s["nu"]


class Adagrad(Optimizer):
    """optax.adagrad: g / sqrt(sum of squares + eps), the sum starting at
    ``initial_accumulator_value`` (0 where the sum is 0)."""

    def __init__(self, learning_rate, initial_accumulator_value=0.1,
                 eps=1e-7):
        super().__init__(learning_rate)
        self.initial, self.eps = initial_accumulator_value, eps

    def init_state(self, p):
        return {"sum": torch.full_like(p, self.initial)}

    def direction(self, g, p, s):
        s["sum"] = g * g + s["sum"]
        scale = torch.where(s["sum"] > 0, torch.rsqrt(s["sum"] + self.eps),
                            torch.zeros_like(s["sum"]))
        return scale * g


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
    """optax.rmsprop: g / sqrt(nu + eps) with nu the decayed mean square
    (``centered``: nu - mu^2, mu the decayed mean; ``bias_correction``
    divides both by 1 - decay^t; ``eps_in_sqrt=False`` puts eps outside
    the root), then an optional momentum trace of the scaled step."""

    def __init__(self, learning_rate, decay=0.9, eps=1e-8,
                 initial_scale=0.0, eps_in_sqrt=True, centered=False,
                 momentum=None, nesterov=False, bias_correction=False):
        super().__init__(learning_rate)
        self.decay, self.eps, self.eps_in_sqrt = decay, eps, eps_in_sqrt
        self.initial_scale = initial_scale
        self.centered, self.bias_correction = centered, bias_correction
        self.momentum, self.nesterov = momentum, nesterov

    def init_state(self, p):
        return {"mu": torch.zeros_like(p),
                "nu": torch.full_like(p, self.initial_scale),
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
            nu = s["nu"]
            if self.centered:
                s["mu"] = (1 - self.decay) * g + self.decay * s["mu"]
                mu = s["mu"]
            if self.bias_correction:
                nu = _bias_corrected(nu, self.decay, self.count)
                if self.centered:
                    mu = _bias_corrected(mu, self.decay, self.count)
            if self.centered:
                nu = nu - mu * mu
            scaling = (torch.rsqrt(nu + self.eps) if self.eps_in_sqrt
                       else 1 / (torch.sqrt(nu) + self.eps))
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


#: optax's names; adamw is adam with optax's decoupled decay of 1e-4,
#: nadam is adam with nesterov
_OPTIMIZERS = {"adam": Adam,
               "adamw": functools.partial(Adam, weight_decay=1e-4),
               "nadam": functools.partial(Adam, nesterov=True),
               "sgd": Sgd, "rmsprop": RmsProp, "lion": Lion,
               "adagrad": Adagrad, "adamax": Adamax, "radam": RAdam,
               "amsgrad": AmsGrad, "adabelief": AdaBelief, "yogi": Yogi}


@dataclasses.dataclass
class LearningRateScheduleConfig:
    """``name``: one of optax's schedule names the port has (the module
    docstring lists them); ``kwargs`` pass through."""

    name: str
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def instance(self) -> Callable[[int], float]:
        if self.name not in _SCHEDULES:
            raise _not_ported(f"the optax schedule {self.name!r}")
        return _SCHEDULES[self.name](**self.kwargs)


@dataclasses.dataclass
class OptimizerConfig:
    """``name``: one of optax's optimizer names the port has (the module
    docstring lists them; the Keras names ``Adam``/``SGD`` map
    lowercase); ``kwargs`` pass through; a ``learning_rate_schedule``
    replaces ``learning_rate``."""

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
