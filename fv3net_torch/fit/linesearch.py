"""optax 0.2.6's zoom line search (``optax/_src/linesearch.py``:
``zoom_linesearch`` and ``scale_by_zoom_linesearch``), the default line
search of ``lbfgs``: a step size that satisfies the strong Wolfe
conditions (sufficient decrease, or Hager and Zhang's approximate
decrease near a minimum, and small curvature), found by growing a trial
step until it brackets one (Nocedal and Wright's Algorithm 3.5) and then
zooming into the bracket by cubic or quadratic interpolation or
bisection (Algorithm 3.6), with optax's safeguards: a step that only
decreases enough is kept in case the curvature condition fails, and the
search ends after ``max_linesearch_steps`` evaluations.

The search is a host loop over Python scalars where optax runs a
``jax.lax.while_loop``: each trial evaluates the loss and its gradient
on the leaves ``params + stepsize * updates`` (one host read of the
value and the slope a trial).  The scalars are numpy float64 under
``np.errstate(all="ignore")``, so a division by zero or the root of a
negative number gives inf or NaN as in JAX, and NaN compares false.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

__all__ = ["ZoomLinesearch", "scale_by_zoom_linesearch"]


def vdot(xs: List[torch.Tensor], ys: List[torch.Tensor]) -> torch.Tensor:
    """optax.tree.vdot of two lists of real tensors (a 0-d tensor)."""
    return sum(torch.dot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(xs, ys))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN where there is none)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    rb, rc = fb - fa - C * db, fc - fa - C * dc
    A = (dc * dc * rb + -(db * db) * rc) / denom
    B = (-(dc * (dc * dc)) * rb + db * (db * db) * rc) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


@dataclasses.dataclass
class _Point:
    stepsize: np.float64
    value: np.float64
    grad: List[torch.Tensor]
    slope: np.float64


@dataclasses.dataclass
class ZoomLinesearch:
    """optax.scale_by_zoom_linesearch's settings (its names and
    defaults; ``stepsize_precision`` is the zoom's interval threshold).
    ``scale(...)`` returns the step size it finds for ``updates``."""

    max_linesearch_steps: int
    max_learning_rate: Optional[float] = None
    tol: float = 0.0
    increase_factor: float = 2.0
    slope_rtol: float = 1e-4
    curv_rtol: float = 0.9
    approx_dec_rtol: Optional[float] = 1e-6
    stepsize_precision: float = 1e-5
    initial_guess_strategy: str = "keep"

    def _decrease_error(self, new: _Point, init: _Point):
        error = (new.value - init.value
                 - self.slope_rtol * new.stepsize * init.slope)
        if self.approx_dec_rtol is not None:
            approx = new.slope - (2 * self.slope_rtol - 1.0) * init.slope
            delta = (new.value - init.value
                     - self.approx_dec_rtol * np.abs(init.value))
            error = np.minimum(np.maximum(approx, delta), error)
        error = np.maximum(error, 0.0)
        return np.inf if np.isnan(error) else error

    def _curvature_error(self, new: _Point, init: _Point):
        error = np.maximum(
            np.abs(new.slope) - self.curv_rtol * np.abs(init.slope), 0.0)
        return np.inf if np.isnan(error) else error

    def scale(self, params: List[torch.Tensor], updates: List[torch.Tensor],
              *, value, grad: List[torch.Tensor], value_fn: Callable,
              prev_stepsize: float = 1.0):
        """(step size, its value, its gradient, evaluations) along
        ``updates`` from ``params``, where ``value`` and ``grad`` are the
        loss and its gradient at ``params`` and ``value_fn(leaves)`` the
        loss of a list of tensors."""
        if self.initial_guess_strategy == "one":
            guess = np.float64(1.0)
        elif self.initial_guess_strategy == "keep":
            guess = np.float64(prev_stepsize)
        else:
            raise ValueError("Unknown initial guess strategy: "
                             f"{self.initial_guess_strategy}")

        def on_line(stepsize) -> _Point:
            leaves = [(p + float(stepsize) * u).detach().requires_grad_(True)
                      for p, u in zip(params, updates)]
            with torch.enable_grad():
                v = value_fn(leaves)
                g = list(torch.autograd.grad(v, leaves))
            v = float(v.detach())
            return _Point(np.float64(stepsize), np.float64(v), g,
                          np.float64(float(vdot(g, updates))))

        with np.errstate(all="ignore"):
            return self._search(
                on_line, _Point(np.float64(0.0), np.float64(float(value)),
                                list(grad),
                                np.float64(float(vdot(updates, grad)))),
                guess)

    def _search(self, on_line, init: _Point, guess):
        tol = self.tol
        current = init
        low = high = cubic = safe = init
        interval_found = done = failed = False
        count = 0
        decrease_error = curvature_error = np.inf
        while not (done or failed):
            if not interval_found:
                # Algorithm 3.5: grow the trial step until it brackets
                stepsize = (guess if count == 0
                            else self.increase_factor * current.stepsize)
                reached = False
                if self.max_learning_rate is not None:
                    reached = stepsize >= self.max_learning_rate
                    stepsize = np.minimum(stepsize, self.max_learning_rate)
                new = on_line(stepsize)
                decrease_error = self._decrease_error(new, init)
                curvature_error = self._curvature_error(new, init)
                error = np.maximum(decrease_error, curvature_error)
                if decrease_error <= tol:
                    safe = new
                high_to_new = (decrease_error > 0.0) or (
                    new.value >= current.value and count > 0)
                low_to_new = new.slope >= 0.0 and not high_to_new
                low, high = (new, current) if low_to_new else (current, new)
                interval_found = high_to_new or low_to_new or error <= tol
                done = error <= tol or (reached and not interval_found)
                failed = count + 1 >= self.max_linesearch_steps and not done
                cubic = low
            else:
                # Algorithm 3.6: zoom into the bracket [low, high]
                delta = np.abs(high.stepsize - low.stepsize)
                left = np.minimum(high.stepsize, low.stepsize)
                right = np.maximum(high.stepsize, low.stepsize)
                too_small = delta <= self.stepsize_precision
                middle_cubic = _cubicmin(
                    low.stepsize, low.value, low.slope, high.stepsize,
                    high.value, cubic.stepsize, cubic.value)
                middle_quad = _quadmin(low.stepsize, low.value, low.slope,
                                       high.stepsize, high.value)
                if (left + 0.2 * delta < middle_cubic
                        < right - 0.2 * delta):
                    middle = middle_cubic
                elif left + 0.1 * delta < middle_quad < right - 0.1 * delta:
                    middle = middle_quad
                else:
                    middle = (low.stepsize + high.stepsize) / 2.0
                new = on_line(middle)
                decrease_error = self._decrease_error(new, init)
                curvature_error = self._curvature_error(new, init)
                error = np.maximum(decrease_error, curvature_error)
                if decrease_error <= tol and new.value < safe.value:
                    safe = new
                done = error <= tol
                high_to_middle = (decrease_error > 0.0
                                  or new.value >= low.value)
                high_to_low = (new.slope * (high.stepsize - low.stepsize)
                               >= 0.0 and not high_to_middle)
                cubic = high if high_to_middle or high_to_low else low
                if high_to_middle:
                    high = new
                elif high_to_low:
                    high = low
                if not high_to_middle:
                    low = new
                failed = (count + 1 >= self.max_linesearch_steps or (
                    too_small and safe.stepsize > 0.0)) and not done
            current = new
            count += 1
            if failed and (safe.stepsize > 0.0 or np.isinf(decrease_error)):
                current = safe
        return current.stepsize, current.value, current.grad, count


def scale_by_zoom_linesearch(max_linesearch_steps: int,
                             **kwargs) -> ZoomLinesearch:
    """optax.scale_by_zoom_linesearch's settings (the port's
    ``lbfgs(linesearch=...)`` takes them)."""
    return ZoomLinesearch(max_linesearch_steps, **kwargs)
