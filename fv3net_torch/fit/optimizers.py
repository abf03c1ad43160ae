"""optax 0.2.6's optimizers as update rules on the trainers' flat list of
tensors, under optax's names, with its defaults and formulas: ``adam``,
``adamw``, ``nadam``, ``nadamw``, ``sgd``, ``rmsprop``, ``lion``,
``adagrad``, ``adamax``, ``adamaxw``, ``radam``, ``amsgrad``,
``adabelief``, ``yogi``, ``adadelta``, ``adafactor``, ``adan``,
``fromage``, ``lamb``, ``lars``, ``lbfgs`` (with the zoom line search of
``fit/linesearch.py``), ``noisy_sgd``, ``novograd``, ``optimistic_adam``,
``optimistic_adam_v2``, ``optimistic_gradient_descent``, ``polyak_sgd``,
``rprop``, ``sign_sgd`` and ``sm3``.

What optax computes over a pytree, a rule computes over the list: per
tensor where optax maps a leaf (the trust ratios of ``lamb``, ``lars``
and ``fromage``, ``novograd``'s layer moments, ``adafactor``'s factored
moments and block RMS), over the whole list where optax reduces the tree
(``lbfgs``'s inner products and memory, ``polyak_sgd``'s gradient norm).
A mask (``weight_decay_mask``, ``mask``, ``trust_ratio_mask``) is
``None``, ``True``, ``False`` or a callable of the list returning one
bool a tensor (the list stands where optax's mask pytree has the params'
structure).  ``mu_dtype``/``dtype_momentum`` take None, a torch dtype or
a dtype's name.  Where optax raises for a configuration, the rule raises
the same exception class at the same stage: ``optimistic_adam`` and
``sm3`` with a schedule when built, ``rprop`` with one at its first
update (optax's ``init``), ``polyak_sgd`` and ``lbfgs`` with a line
search at an update without the loss (``value``, ``grad``, ``value_fn``),
as the dense trainer's update is.

``torch.optim``'s classes of the same names differ from optax's (AdamW
decays by 1e-2 where optax's decays by 1e-4, RMSprop's smoothing is 0.99
where optax's decay is 0.9 and takes its eps outside the square root,
Adagrad's accumulator starts at 0 where optax's starts at 0.1, and torch
has no Lion or Yogi), so none is used.
"""
from __future__ import annotations

import functools
import math
import operator
from typing import List, Optional

import numpy as np
import torch

from fv3net_torch.fit import schedules
from fv3net_torch.fit.linesearch import scale_by_zoom_linesearch, vdot

__all__ = ["OPTIMIZERS", "Optimizer"]


def _mask(mask, params) -> List[bool]:
    """One bool a tensor: whether a masked transform applies to it."""
    if mask is None or mask is True:
        return [True] * len(params)
    if mask is False:
        return [False] * len(params)
    return [bool(m) for m in (mask(params) if callable(mask) else mask)]


def _dtype(dtype) -> Optional[torch.dtype]:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def _safe_norm(x: torch.Tensor, min_norm: float) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x)
    return torch.where(norm <= min_norm, torch.full_like(norm, min_norm),
                       norm)


def _trust_ratio(u, p, min_norm=0.0, coefficient=1.0, eps=0.0):
    """optax.scale_by_trust_ratio on one tensor: u times coefficient
    |p| / (|u| + eps), or times 1 where either norm is 0."""
    p_norm, u_norm = _safe_norm(p, min_norm), _safe_norm(u, min_norm)
    ratio = coefficient * p_norm / (u_norm + eps)
    return u * torch.where((p_norm == 0.0) | (u_norm == 0.0),
                           torch.ones_like(ratio), ratio)


def _optimistic(u, s, alpha, beta):
    """optax.scale_by_optimistic_gradient on one tensor: (alpha + beta) u
    - beta u_prev, with u_prev = u at the first update."""
    prev = s.get("prev", u)
    s["prev"] = u
    return (alpha + beta) * u - beta * prev


class Optimizer:
    """An optax update rule on a list of tensors: ``step(params, grads)``
    updates the tensors in place (``params += updates``) and advances the
    update count.  ``learning_rate`` is a float or a schedule of the
    count.  ``step`` takes optax's extra arguments keyword-only: ``value``
    (the loss at ``params``), ``grad`` (its gradient) and ``value_fn``
    (the loss of a list of tensors); the rules that need them say so.

    A rule gives either ``direction`` (one tensor's step before the rate,
    to which the decoupled ``weight_decay`` times the tensor is added
    where ``mask`` says, then scaled by -rate) or ``updates`` (the whole
    list's updates)."""

    def __init__(self, learning_rate, weight_decay: float = 0.0, mask=None):
        self._lr = learning_rate
        self.weight_decay = weight_decay
        self.mask = mask
        self.count = 0
        self._state: Optional[List[dict]] = None

    def direction(self, g: torch.Tensor, p: torch.Tensor,
                  s: dict) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self, p: torch.Tensor) -> dict:
        return {}

    def decayed(self, params) -> List[bool]:
        """Whether each tensor takes the weight decay."""
        if not self.weight_decay:
            return [False] * len(params)
        return _mask(self.mask, params)

    def updates(self, params, grads, lr, **loss) -> List[torch.Tensor]:
        out = []
        for p, g, s, decayed in zip(params, grads, self._state,
                                    self.decayed(params)):
            u = self.direction(g, p, s)
            if decayed:
                u = u + self.weight_decay * p
            out.append(-lr * u)
        return out

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             *, value=None, grad=None, value_fn=None) -> None:
        if self._state is None:
            self._state = [self.init_state(p) for p in params]
        lr = self._lr(self.count) if callable(self._lr) else self._lr
        self.count += 1
        for p, u in zip(params, self.updates(
                params, list(grads), lr, value=value, grad=grad,
                value_fn=value_fn)):
            p.add_(u)


def _bias_corrected(moment: torch.Tensor, decay: float, count: int):
    return moment / (1 - decay ** count)


class Adam(Optimizer):
    """optax.adam (adamw with ``weight_decay``, nadam(w) with
    ``nesterov``): bias-corrected first and second moments, m_hat /
    (sqrt(v_hat + eps_root) + eps); with ``nesterov`` m_hat is b1 m / (1 -
    b1^(t+1)) + (1 - b1) g / (1 - b1^t).  The first moment is kept in
    ``mu_dtype``."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, weight_decay=0.0, nesterov=False,
                 mu_dtype=None, mask=None):
        super().__init__(learning_rate, weight_decay, mask)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.nesterov = nesterov
        self.mu_dtype = _dtype(mu_dtype)

    def init_state(self, p):
        return {"mu": torch.zeros_like(p, dtype=self.mu_dtype),
                "nu": torch.zeros_like(p)}

    def first_moment(self, g, s):
        mu = (1 - self.b1) * g + self.b1 * s["mu"]
        s["mu"] = _cast(mu, self.mu_dtype)
        if self.nesterov:
            return (self.b1 * _bias_corrected(mu, self.b1, self.count + 1)
                    + (1 - self.b1) * _bias_corrected(g, self.b1,
                                                      self.count))
        return _bias_corrected(mu, self.b1, self.count)

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
                 eps_root=0.0, mu_dtype=None):
        super().__init__(learning_rate, b1, b2, eps, eps_root,
                         mu_dtype=mu_dtype)

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


class AdamaxW(Adamax):
    """optax.adamaxw: adamax plus decoupled weight decay (1e-4)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-4, mask=None):
        super().__init__(learning_rate, b1, b2, eps)
        self.weight_decay, self.mask = weight_decay, mask


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

    def updates(self, params, grads, lr, **loss):
        # the momentum trace follows the learning-rate scaling in optax
        out = []
        for g, s in zip(grads, self._state):
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
            out.append(u)
        return out


class Lion(Optimizer):
    """optax.lion: sign((1 - b1) g + b1 mu), mu decayed with b2, plus
    decoupled weight decay (1e-3)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.99, weight_decay=1e-3,
                 mask=None):
        super().__init__(learning_rate, weight_decay, mask)
        self.b1, self.b2 = b1, b2

    def init_state(self, p):
        return {"mu": torch.zeros_like(p)}

    def direction(self, g, p, s):
        u = torch.sign((1.0 - self.b1) * g + self.b1 * s["mu"])
        s["mu"] = (1 - self.b2) * g + self.b2 * s["mu"]
        return u


class SignSgd(Optimizer):
    """optax.sign_sgd: the gradient's sign."""

    def direction(self, g, p, s):
        return torch.sign(g)


class Adadelta(Optimizer):
    """optax.adadelta: g (plus the decayed weights) times sqrt(E[dx^2] +
    eps) / sqrt(E[g^2] + eps), both means decayed with ``rho``.  Without
    a ``learning_rate`` optax adds that step unscaled (no sign flip)."""

    def __init__(self, learning_rate=None, rho=0.9, eps=1e-6,
                 weight_decay=0.0, weight_decay_mask=None):
        super().__init__(learning_rate, weight_decay, weight_decay_mask)
        self.rho, self.eps = rho, eps

    def init_state(self, p):
        return {"e_g": torch.zeros_like(p), "e_x": torch.zeros_like(p)}

    def updates(self, params, grads, lr, **loss):
        out = []
        for p, g, s, decayed in zip(params, grads, self._state,
                                    self.decayed(params)):
            if decayed:
                g = g + self.weight_decay * p
            s["e_g"] = (1 - self.rho) * (g * g) + self.rho * s["e_g"]
            u = (torch.sqrt(s["e_x"] + self.eps)
                 / torch.sqrt(s["e_g"] + self.eps)) * g
            s["e_x"] = (1 - self.rho) * (u * u) + self.rho * s["e_x"]
            out.append(u if lr is None else -lr * u)
        return out


class Adafactor(Optimizer):
    """optax.adafactor: g over the root of a factored second moment (the
    means of g^2 + eps over the largest and the second largest axis where
    both have ``min_dim_size_to_factor`` elements or more, else the full
    one), decayed with 1 - (t - decay_offset)^-decay_rate (float32, as
    optax computes it); then clipped to block RMS ``clipping_threshold``,
    times the rate, times the tensor's RMS (at least 1e-3), an
    undebiased ``momentum`` trace kept in ``dtype_momentum``, plus
    ``weight_decay_rate`` times the tensor, negated."""

    def __init__(self, learning_rate=None, min_dim_size_to_factor=128,
                 decay_rate=0.8, decay_offset=0,
                 multiply_by_parameter_scale=True, clipping_threshold=1.0,
                 momentum=None, dtype_momentum=torch.float32,
                 weight_decay_rate=None, eps=1e-30, factored=True,
                 weight_decay_mask=None):
        super().__init__(learning_rate, mask=weight_decay_mask)
        self.min_dim_size_to_factor = min_dim_size_to_factor
        self.decay_rate, self.decay_offset = decay_rate, decay_offset
        self.multiply_by_parameter_scale = multiply_by_parameter_scale
        self.clipping_threshold = clipping_threshold
        self.momentum = momentum
        self.dtype_momentum = _dtype(dtype_momentum)
        self.weight_decay_rate = weight_decay_rate
        self.eps, self.factored = eps, factored

    def factored_dims(self, shape):
        """optax's ``_factored_dims``: (second largest, largest) axis."""
        if not self.factored or len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.min_dim_size_to_factor:
            return None
        return int(order[-2]), int(order[-1])

    def init_state(self, p):
        dims = self.factored_dims(tuple(p.shape))
        if dims is None:
            s = {"v": torch.zeros_like(p)}
        else:
            d1, d0 = dims
            s = {"v_row": torch.zeros_like(p.select(d0, 0)),
                 "v_col": torch.zeros_like(p.select(d1, 0))}
        if self.momentum is not None:
            s["ema"] = torch.zeros_like(p, dtype=self.dtype_momentum)
        return s

    def second_moment_decay(self) -> torch.Tensor:
        """The second moment's decay at this update, 1 - t^-decay_rate
        with t = count - decay_offset, in float32 as optax computes it
        (a 0-d tensor)."""
        t = torch.tensor(self.count - self.decay_offset, dtype=torch.float32)
        return 1.0 - t ** -self.decay_rate

    def updates(self, params, grads, lr, **loss):
        rate = self.second_moment_decay()
        decay, keep = float(rate), float(1.0 - rate)
        out = []
        for p, g, s, decayed in zip(params, grads, self._state,
                                    _mask(self.mask, params)):
            grad_sqr = g * g + self.eps
            dims = self.factored_dims(tuple(p.shape))
            if dims is None:
                s["v"] = decay * s["v"] + keep * grad_sqr
                u = g * s["v"] ** -0.5
            else:
                d1, d0 = dims
                s["v_row"] = decay * s["v_row"] + keep * grad_sqr.mean(d0)
                s["v_col"] = decay * s["v_col"] + keep * grad_sqr.mean(d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = s["v_row"].mean(reduced_d1, keepdim=True)
                row_factor = (s["v_row"] / row_col_mean) ** -0.5
                u = (g * row_factor.unsqueeze(d0)
                     * (s["v_col"] ** -0.5).unsqueeze(d1))
            if self.clipping_threshold is not None:
                u = u / torch.clamp(torch.sqrt(torch.mean(u * u))
                                    / self.clipping_threshold, min=1.0)
            if lr is not None:
                u = lr * u
            if self.multiply_by_parameter_scale:
                rms = torch.sqrt(torch.mean(p * p))
                u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3),
                                    rms)
            if self.momentum is not None:
                u = (1 - self.momentum) * u + self.momentum * s["ema"]
                s["ema"] = _cast(u, self.dtype_momentum)
            if self.weight_decay_rate is not None and decayed:
                u = u + self.weight_decay_rate * p
            out.append(-u)
        return out


class Adan(Optimizer):
    """optax.adan: bias-corrected moments of g, of its difference from the
    last gradient (0 at the first update) and of g + (1 - b2) diff
    squared; (m_hat + (1 - b2) v_hat) / (sqrt(n_hat + eps_root) + eps),
    plus decoupled weight decay."""

    def __init__(self, learning_rate, b1=0.98, b2=0.92, b3=0.99, eps=1e-8,
                 eps_root=1e-8, weight_decay=0.0, mask=None):
        super().__init__(learning_rate, weight_decay, mask)
        self.b1, self.b2, self.b3 = b1, b2, b3
        self.eps, self.eps_root = eps, eps_root

    def init_state(self, p):
        return {k: torch.zeros_like(p) for k in ("m", "v", "n", "g")}

    def direction(self, g, p, s):
        diff = torch.zeros_like(g) if self.count == 1 else g - s["g"]
        s["m"] = (1 - self.b1) * g + self.b1 * s["m"]
        s["v"] = (1 - self.b2) * diff + self.b2 * s["v"]
        sq = g + (1 - self.b2) * diff
        s["n"] = (1 - self.b3) * (sq * sq) + self.b3 * s["n"]
        s["g"] = g
        t = self.count
        u = (_bias_corrected(s["m"], self.b1, t)
             + (1 - self.b2) * _bias_corrected(s["v"], self.b2, t))
        return u / (torch.sqrt(_bias_corrected(s["n"], self.b3, t)
                               + self.eps_root) + self.eps)


class Lamb(Adam):
    """optax.lamb: Adam's step plus decoupled weight decay, times the
    tensor's trust ratio |p| / |u|."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-6,
                 eps_root=0.0, weight_decay=0.0, mask=None):
        super().__init__(learning_rate, b1, b2, eps, eps_root,
                         weight_decay=weight_decay, mask=mask)

    def updates(self, params, grads, lr, **loss):
        out = []
        for p, g, s, decayed in zip(params, grads, self._state,
                                    self.decayed(params)):
            u = self.direction(g, p, s)
            if decayed:
                u = u + self.weight_decay * p
            out.append(-lr * _trust_ratio(u, p))
        return out


class Lars(Optimizer):
    """optax.lars: g plus weight decay, times the trust ratio
    trust_coefficient |p| / (|u| + eps) where ``trust_ratio_mask`` says,
    times -rate, then a momentum trace (Nesterov's with ``nesterov``)."""

    def __init__(self, learning_rate, weight_decay=0.0,
                 weight_decay_mask=True, trust_coefficient=0.001, eps=0.0,
                 trust_ratio_mask=True, momentum=0.9, nesterov=False):
        super().__init__(learning_rate, weight_decay, weight_decay_mask)
        self.trust_coefficient, self.eps = trust_coefficient, eps
        self.trust_ratio_mask = trust_ratio_mask
        self.momentum, self.nesterov = momentum, nesterov

    def init_state(self, p):
        return {"trace": torch.zeros_like(p)}

    def updates(self, params, grads, lr, **loss):
        out = []
        for p, g, s, decayed, trusted in zip(
                params, grads, self._state, self.decayed(params),
                _mask(self.trust_ratio_mask, params)):
            u = g + self.weight_decay * p if decayed else g
            if trusted:
                u = _trust_ratio(u, p, 0.0, self.trust_coefficient, self.eps)
            u = -lr * u
            s["trace"] = u + self.momentum * s["trace"]
            out.append(u + self.momentum * s["trace"] if self.nesterov
                       else s["trace"])
        return out


class Fromage(Optimizer):
    """optax.fromage: -rate m trust_ratio(g) + (m - 1) p with m = 1 /
    sqrt(1 + rate^2).  Under a schedule optax's decay schedule reads the
    count 0 at every update (its state's count never advances), and both
    factors are computed in the schedule's type."""

    def __init__(self, learning_rate, min_norm=1e-6):
        super().__init__(learning_rate)
        self.min_norm = min_norm

    def updates(self, params, grads, lr, **loss):
        t = (np.float32 if schedules.dtype_of(self._lr) == np.float32
             else np.float64)

        def mult(rate):
            return t(1) / np.sqrt(t(1) + t(rate) * t(rate))

        step = float(mult(lr) * t(lr))
        decay = float(mult(self._lr(0) if callable(self._lr) else lr) - t(1))
        return [-step * _trust_ratio(g, p, self.min_norm) + decay * p
                for p, g in zip(params, grads)]


class NoisySgd(Optimizer):
    """optax.noisy_sgd: g plus N(0, eta / t^gamma) noise, times -rate.
    The noise comes from a ``torch.Generator`` on the tensors' device,
    seeded with ``key`` (an int) or ``seed``; ``noise`` draws it."""

    def __init__(self, learning_rate, eta=0.01, gamma=0.55, key=None, *,
                 seed=None):
        super().__init__(learning_rate)
        if seed is not None and key is not None:
            raise ValueError("Only one of seed or key can be specified.")
        seed = key if seed is None else seed
        self.seed = operator.index(0 if seed is None else seed)
        self.eta, self.gamma = eta, gamma
        self._generator = None

    def noise(self, p: torch.Tensor) -> torch.Tensor:
        if self._generator is None:
            self._generator = torch.Generator(
                device=p.device).manual_seed(self.seed)
        return torch.randn(p.shape, generator=self._generator,
                           dtype=p.dtype, device=p.device)

    def updates(self, params, grads, lr, **loss):
        std = math.sqrt(self.eta / self.count ** self.gamma)
        return [-lr * (g + std * self.noise(p))
                for p, g in zip(params, grads)]


class NovoGrad(Optimizer):
    """optax.novograd: a tensor's second moment is its squared norm,
    decayed with b2 (the first norm as it is); its first moment
    accumulates g / (sqrt(nu + eps_root) + eps) + weight_decay p with
    b1 (the first one as it is)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.25, eps=1e-6,
                 eps_root=0.0, weight_decay=0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.novograd_decay = weight_decay

    def direction(self, g, p, s):
        norm2 = torch.linalg.vector_norm(g) ** 2
        first = self.count == 1
        s["nu"] = norm2 if first else (1 - self.b2) * norm2 + self.b2 * s["nu"]
        m = (g / (torch.sqrt(s["nu"] + self.eps_root) + self.eps)
             + self.novograd_decay * p)
        s["mu"] = m if first else self.b1 * s["mu"] + m
        return s["mu"]


class OptimisticGradientDescent(Optimizer):
    """optax.optimistic_gradient_descent: (alpha + beta) g - beta g_prev,
    times -rate."""

    def __init__(self, learning_rate, alpha=1.0, beta=1.0):
        super().__init__(learning_rate)
        self.alpha, self.beta = alpha, beta

    def direction(self, g, p, s):
        return _optimistic(g, s, self.alpha, self.beta)


class OptimisticAdamV2(Adam):
    """optax.optimistic_adam_v2: the optimistic step over Nesterov Adam's
    step, times -rate."""

    def __init__(self, learning_rate, *, alpha=1.0, beta=1.0, b1=0.9,
                 b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
                 nesterov=True):
        super().__init__(learning_rate, b1, b2, eps, eps_root,
                         nesterov=nesterov, mu_dtype=mu_dtype)
        self.alpha, self.beta = alpha, beta

    def direction(self, g, p, s):
        return _optimistic(super().direction(g, p, s), s, self.alpha,
                           self.beta)


class OptimisticAdam(OptimisticAdamV2):
    """optax.optimistic_adam (deprecated in optax): the optimistic step
    with alpha = learning_rate and beta = ``optimism`` (default the
    rate) over Nesterov Adam's step, negated.  A float rate only."""

    def __init__(self, learning_rate, optimism=None, b1=0.9, b2=0.999,
                 eps=1e-8, eps_root=0.0, mu_dtype=None, *, nesterov=True):
        if callable(learning_rate):
            raise ValueError(
                "This version of `optimistic_adam` does not support learning "
                "rate schedules but `optimistic_adam_v2` does.")
        super().__init__(
            1.0, alpha=learning_rate,
            beta=learning_rate if optimism is None else optimism, b1=b1,
            b2=b2, eps=eps, eps_root=eps_root, mu_dtype=mu_dtype,
            nesterov=nesterov)


class PolyakSgd(Optimizer):
    """optax.polyak_sgd: u = -scaling g, times min((value - f_min) / (|u|^2
    + eps), max_learning_rate) with |u| over the whole list (0 where |u|^2
    + eps is at most float64's eps; ``variant="sps+"`` takes the gap at
    least 0).  Needs the loss: ``step(..., value=loss)``."""

    def __init__(self, max_learning_rate=1.0, scaling=1.0, f_min=0.0,
                 eps=0.0, variant="sps"):
        super().__init__(scaling)
        self.max_learning_rate, self.f_min = max_learning_rate, f_min
        self.eps, self.variant = eps, variant

    def updates(self, params, grads, lr, value=None, **loss):
        if value is None:
            raise TypeError("polyak_sgd's update needs the loss at params "
                            "(step(params, grads, value=...)), as optax's "
                            "scale_by_polyak needs its keyword 'value'")
        u = [-lr * g for g in grads]
        sq_norm = sum(torch.sum(x * x) for x in u)
        gap = torch.as_tensor(value - self.f_min, dtype=sq_norm.dtype,
                              device=sq_norm.device)
        if self.variant == "sps+":
            gap = torch.relu(gap)
        elif self.variant != "sps":
            raise ValueError("Invalid argument value for Polyak SGD: "
                             f"variant={self.variant!r}")
        step = torch.where(
            sq_norm + self.eps <= np.finfo(float).eps,
            torch.zeros_like(sq_norm),
            torch.clamp(gap / (sq_norm + self.eps),
                        max=self.max_learning_rate))
        return [step * x for x in u]


class Rprop(Optimizer):
    """optax.rprop: per-element step sizes (starting at the float
    ``learning_rate``) grown by eta_plus where g keeps its sign, shrunk
    by eta_minus where it flips, within [min_step_size, max_step_size];
    the update is the last update's step times sign, 0 where g flipped
    (optax's formula), negated."""

    def __init__(self, learning_rate, eta_minus=0.5, eta_plus=1.2,
                 min_step_size=1e-6, max_step_size=50.0):
        super().__init__(learning_rate)
        self.eta_minus, self.eta_plus = eta_minus, eta_plus
        self.min_step_size, self.max_step_size = min_step_size, max_step_size

    def init_state(self, p):
        if callable(self._lr):
            raise TypeError("rprop's learning_rate is its initial step "
                            "size and must be a float (optax fills its "
                            "step sizes with it: jnp.full_like)")
        return {"step": torch.full_like(p, self._lr),
                "prev": torch.zeros_like(p)}

    def updates(self, params, grads, lr, **loss):
        out = []
        for g, s in zip(grads, self._state):
            sign = g * s["prev"]
            grown = s["step"] * torch.where(
                sign > 0, torch.full_like(g, self.eta_plus),
                torch.full_like(g, self.eta_minus))
            step = torch.where(sign == 0, s["step"], torch.clamp(
                grown, min=self.min_step_size, max=self.max_step_size))
            zero = torch.zeros_like(g)
            u = torch.where(sign < 0, zero, s["prev"])
            s["step"] = step
            s["prev"] = torch.where(sign < 0, zero, step * torch.sign(g))
            out.append(-1.0 * u)
        return out


class SM3(Optimizer):
    """optax.sm3: per-axis accumulators (a vector for each axis of a
    tensor: the maxima over the other axes of the accumulated g^2 + the
    least of the accumulators at that element), g / sqrt(accumulated +
    1e-8) with a ``momentum`` trace, times -learning_rate (a float)."""

    def __init__(self, learning_rate, momentum=0.9):
        if callable(learning_rate):
            raise TypeError("sm3's learning_rate must be a float (optax "
                            "negates it: bad operand type for unary -)")
        super().__init__(learning_rate)
        self.momentum, self.eps = momentum, 1e-8

    def init_state(self, p):
        return {"mu": [torch.zeros(n, dtype=p.dtype, device=p.device)
                       for n in p.shape],
                "nu": torch.zeros_like(p)}

    def direction(self, g, p, s):
        if g.ndim < 2:
            accum = g * g + s["mu"][0]
        else:
            accum = g * g + functools.reduce(torch.minimum, [
                v.reshape([1] * i + [-1] + [1] * (g.ndim - i - 1))
                for i, v in enumerate(s["mu"])])
        inv_sqrt = torch.where(accum > 0, torch.rsqrt(accum + self.eps),
                               torch.zeros_like(accum))
        s["nu"] = ((1 - self.momentum) * (g * inv_sqrt)
                   + self.momentum * s["nu"])
        s["mu"] = ([accum] if g.ndim < 2 else [
            accum.amax(dim=[j for j in range(g.ndim) if j != i])
            for i in range(g.ndim)])
        return s["nu"]


class LBFGS(Optimizer):
    """optax.lbfgs: the gradient times L-BFGS's inverse-Hessian estimate
    from the last ``memory_size`` differences of the parameters and the
    gradients (inner products over the whole list; the first update
    scaled by min(1, 1 / |g|), later ones by dw.du / |du|^2 with
    ``scale_init_precond``), times -rate (-1 without one), then scaled by
    the step size the ``linesearch`` finds (the zoom line search by
    default; None takes the step as it is).  A line search needs
    ``step(..., value=, grad=, value_fn=)``: the loss and its gradient at
    params and the loss of a list of tensors."""

    def __init__(self, learning_rate=None, memory_size=10,
                 scale_init_precond=True,
                 linesearch=scale_by_zoom_linesearch(
                     max_linesearch_steps=20, initial_guess_strategy="one")):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        super().__init__(learning_rate)
        self.memory_size = memory_size
        self.scale_init_precond = scale_init_precond
        self.linesearch = linesearch
        self.linesearch_rate = 1.0  # the last step size of the search

    def init_state(self, p):
        m = self.memory_size
        return {"params": torch.zeros_like(p), "grad": torch.zeros_like(p),
                "dw": torch.zeros((m, *p.shape), dtype=p.dtype,
                                  device=p.device),
                "du": torch.zeros((m, *p.shape), dtype=p.dtype,
                                  device=p.device)}

    def updates(self, params, grads, lr, value=None, grad=None,
                value_fn=None):
        if self.linesearch is not None and (
                value is None or grad is None or value_fn is None):
            raise TypeError("lbfgs's line search needs step(params, grads, "
                            "value=, grad=, value_fn=), as optax's "
                            "scale_by_zoom_linesearch needs its keywords "
                            "'value', 'grad' and 'value_fn'")
        state, m = self._state, self.memory_size
        k = self.count - 1
        if k == 0:
            self._rho = torch.zeros(m, dtype=params[0].dtype,
                                    device=params[0].device)
        new, prev = k % m, (k - 1) % m
        if k > 0:
            dw = [p - s["params"] for p, s in zip(params, state)]
            du = [g - s["grad"] for g, s in zip(grads, state)]
            dot = vdot(du, dw)
            self._rho[prev] = torch.where(dot == 0.0, torch.zeros_like(dot),
                                          1.0 / dot)
            for s, a, b in zip(state, dw, du):
                s["dw"][prev], s["du"][prev] = a, b
        if not self.scale_init_precond:
            scale = 1.0
        elif k > 0:
            den = vdot(du, du)
            scale = torch.where(den > 0.0, vdot(du, dw) / den,
                                torch.ones_like(den))
        else:
            norm = torch.sqrt(vdot(grads, grads))
            scale = torch.clamp(1.0 / norm, max=1.0)
        order = [(new + j) % m for j in range(m)]
        vec, alphas = list(grads), {}
        for i in reversed(order):
            alphas[i] = self._rho[i] * vdot([s["dw"][i] for s in state], vec)
            vec = [v - alphas[i] * s["du"][i] for v, s in zip(vec, state)]
        vec = [scale * v for v in vec]
        for i in order:
            beta = self._rho[i] * vdot([s["du"][i] for s in state], vec)
            vec = [v + (alphas[i] - beta) * s["dw"][i]
                   for v, s in zip(vec, state)]
        for p, g, s in zip(params, grads, state):
            s["params"], s["grad"] = p.clone(), g.clone()
        vec = [(-1.0 if lr is None else -lr) * v for v in vec]
        if self.linesearch is not None:
            stepsize, _, _, _ = self.linesearch.scale(
                params, vec, value=value, grad=grad, value_fn=value_fn,
                prev_stepsize=self.linesearch_rate)
            self.linesearch_rate = float(stepsize)
            vec = [float(stepsize) * v for v in vec]
        return vec


#: optax's names: adamw is adam with optax's decoupled decay of 1e-4,
#: nadam adam with nesterov, nadamw both
OPTIMIZERS = {
    "adam": Adam,
    "adamw": functools.partial(Adam, weight_decay=1e-4),
    "nadam": functools.partial(Adam, nesterov=True),
    "nadamw": functools.partial(Adam, weight_decay=1e-4, nesterov=True),
    "sgd": Sgd, "rmsprop": RmsProp, "lion": Lion, "adagrad": Adagrad,
    "adamax": Adamax, "adamaxw": AdamaxW, "radam": RAdam,
    "amsgrad": AmsGrad, "adabelief": AdaBelief, "yogi": Yogi,
    "adadelta": Adadelta, "adafactor": Adafactor, "adan": Adan,
    "fromage": Fromage, "lamb": Lamb, "lars": Lars, "lbfgs": LBFGS,
    "noisy_sgd": NoisySgd, "novograd": NovoGrad,
    "optimistic_adam": OptimisticAdam,
    "optimistic_adam_v2": OptimisticAdamV2,
    "optimistic_gradient_descent": OptimisticGradientDescent,
    "polyak_sgd": PolyakSgd, "rprop": Rprop, "sign_sgd": SignSgd,
    "sm3": SM3,
}
