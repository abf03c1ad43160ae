"""The one-class SVM's fit and decision function, on tensors (the solver
of ``sklearn.svm.OneClassSVM``, libsvm as scikit-learn 1.9 ships it:
``svm/src/libsvm/svm.cpp``).

:func:`fit` solves libsvm's one-class dual, min 1/2 a'Qa over 0 <= a_i
<= 1 with sum(a) = nu * l, Q the RBF kernel matrix, as libsvm's
``solve_one_class`` and ``Solver::Solve`` do:

- the initial alpha: the first floor(nu * l) alphas at 1, the next one
  the remainder of nu * l (accumulated as libsvm accumulates it), the
  rest 0;
- each iteration takes libsvm's second-order working set
  (``select_working_set``: i the last index maximizing -G over the
  alphas below 1; j the last index minimizing -(G_max + G_j)^2 /
  (Q_ii + Q_jj - 2 Q_ij) over the alphas above 0 with G_max + G_j > 0),
  stops once G_max + max(G over alphas above 0) < tol, and updates the
  pair and the gradient as ``Solve`` does;
- rho is ``calculate_rho``: the mean gradient over free alphas, or the
  midpoint of the bounds when none is free.

As in libsvm, the kernel matrix is computed in float64 and held in
float32 (libsvm's ``Qfloat``), its diagonal 1; the gradient, the alphas
and rho are float64.  The matrix is built once (13,824 C48 columns take
0.76 GB), and an iteration is a few vector operations on it.  libsvm's
shrinking is not reproduced: it only changes the order in which pairs
are taken, so a fit here and scikit-learn's agree to the stopping gap
``tol``.  The pair's update runs on the host in float64 with libsvm's
expressions; one device-to-host copy an iteration brings its inputs.

The decision function is K(x, SV) @ dual_coef - rho in float64.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

TAU = 1e-12  # libsvm's floor of a pair's curvature
ROW_BLOCK = 2048  # rows of the kernel matrix computed at a time


@dataclasses.dataclass
class OneClassSVMFit:
    """A fitted one-class SVM: the support rows of the training data
    (``support``, ascending), their dual coefficients, rho, gamma and
    the solver's iterations."""

    support: torch.Tensor
    support_vectors: torch.Tensor
    dual_coef: torch.Tensor
    rho: float
    gamma: float
    n_iter: int


def gamma_scale(X: np.ndarray) -> float:
    """scikit-learn's ``gamma="scale"``: 1 / (n_features * X.var())."""
    X = np.asarray(X, np.float64)
    var = X.var()
    return 1.0 / (X.shape[1] * var) if var != 0 else 1.0


def rbf_kernel(A: torch.Tensor, B: torch.Tensor, gamma: float
               ) -> torch.Tensor:
    """exp(-gamma (|a|^2 + |b|^2 - 2 a.b)), libsvm's ``kernel_rbf``."""
    a2 = (A * A).sum(dim=1)
    b2 = (B * B).sum(dim=1)
    return torch.exp(-gamma * (a2[:, None] + b2[None, :] - 2.0 * (A @ B.T)))


def _kernel_matrix(X: torch.Tensor, gamma: float) -> torch.Tensor:
    l = X.shape[0]
    Q = torch.empty((l, l), dtype=torch.float32, device=X.device)
    for r0 in range(0, l, ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, l)
        Q[r0:r1] = rbf_kernel(X[r0:r1], X, gamma).to(torch.float32)
    Q.diagonal().fill_(1.0)  # libsvm's K(x, x) is exp(0)
    return Q


def initial_alpha(l: int, nu: float) -> np.ndarray:
    """libsvm's ``solve_one_class`` start: nu * l spread over the first
    alphas, at most 1 each."""
    nu_l = 0.0
    for _ in range(l):
        nu_l += 1.0 * nu
    alpha = np.zeros(l)
    i = 0
    while nu_l > 0:
        alpha[i] = min(1.0, nu_l)
        nu_l -= alpha[i]
        i += 1
    return alpha


def _update_pair(a_i, a_j, G_i, G_j, Q_ij):
    """libsvm's update of a pair with y_i == y_j, C = 1 (``Solve``)."""
    quad_coef = 1.0 + 1.0 - 2.0 * Q_ij
    if quad_coef <= 0:
        quad_coef = TAU
    delta = (G_i - G_j) / quad_coef
    total = a_i + a_j
    a_i -= delta
    a_j += delta
    if total > 1.0:
        if a_i > 1.0:
            a_i = 1.0
            a_j = total - 1.0
    else:
        if a_j < 0:
            a_j = 0.0
            a_i = total
    if total > 1.0:
        if a_j > 1.0:
            a_j = 1.0
            a_i = total - 1.0
    else:
        if a_i < 0:
            a_i = 0.0
            a_j = total
    return a_i, a_j


def fit(X: torch.Tensor, nu: float = 0.1, gamma: float = None,
        tol: float = 1e-3, max_iter: int = -1) -> OneClassSVMFit:
    """Fit the one-class SVM with the RBF kernel on the rows of ``X``
    (cast to float64), on ``X``'s device."""
    X = X.to(torch.float64)
    l = X.shape[0]
    if gamma is None:
        gamma = gamma_scale(X.cpu().numpy())
    # the solver runs on the rows in reverse order, so that torch's
    # argmax/argmin (the first extreme) pick libsvm's (the last)
    Q = _kernel_matrix(X.flip(0), gamma)
    alpha0 = initial_alpha(l, nu)[::-1].copy()
    alpha = torch.tensor(alpha0, dtype=torch.float64, device=X.device)
    start = np.flatnonzero(alpha0 > 0)
    G = alpha[start] @ Q[start].to(torch.float64)
    not_upper = alpha < 1.0
    not_lower = alpha > 0.0
    inf = torch.tensor(math.inf, dtype=torch.float64, device=X.device)
    n_iter = 0
    while max_iter == -1 or n_iter < max_iter:
        i = torch.argmax(torch.where(not_upper, -G, -inf))
        g_max = -G[i]
        g_max2 = torch.where(not_lower, G, -inf).max()
        Q_i = Q[i].to(torch.float64)
        grad_diff = g_max + G
        quad = 2.0 - 2.0 * Q_i
        quad = torch.where(quad > 0, quad, torch.full_like(quad, TAU))
        obj = torch.where(not_lower & (grad_diff > 0),
                          -(grad_diff * grad_diff) / quad, inf)
        j = torch.argmin(obj)
        (g_max, g_max2, obj_j, i, j, G_i, G_j, Q_ij, a_i, a_j) = torch.stack([
            g_max, g_max2, obj[j], i.to(torch.float64), j.to(torch.float64),
            G[i], G[j], Q_i[j], alpha[i], alpha[j]]).tolist()
        if g_max + g_max2 < tol or obj_j == math.inf:
            break
        n_iter += 1
        i, j = int(i), int(j)
        new_i, new_j = _update_pair(a_i, a_j, G_i, G_j, Q_ij)
        G += Q_i * (new_i - a_i) + Q[j].to(torch.float64) * (new_j - a_j)
        alpha[i], alpha[j] = new_i, new_j
        for k, a in ((i, new_i), (j, new_j)):
            not_upper[k] = a < 1.0
            not_lower[k] = a > 0.0
    rho = _rho(alpha, G)
    alpha = alpha.flip(0)
    support = torch.nonzero(alpha > 0).flatten()
    return OneClassSVMFit(support, X[support], alpha[support], rho, gamma,
                          n_iter)


def _rho(alpha: torch.Tensor, G: torch.Tensor) -> float:
    """libsvm's ``calculate_rho`` with every y = +1."""
    upper = alpha >= 1.0
    lower = alpha <= 0.0
    free = ~(upper | lower)
    n_free = int(free.sum())
    if n_free > 0:
        return float(G[free].sum()) / n_free
    ub = float(G[lower].min()) if bool(lower.any()) else math.inf
    lb = float(G[upper].max()) if bool(upper.any()) else -math.inf
    return (ub + lb) / 2


def decision_function(X: torch.Tensor, support_vectors: torch.Tensor,
                      dual_coef: torch.Tensor, rho: float, gamma: float
                      ) -> torch.Tensor:
    """K(X, SV) @ dual_coef - rho, float64, on ``support_vectors``'
    device: positive in-sample."""
    sv = support_vectors.to(torch.float64)
    X = X.to(device=sv.device, dtype=torch.float64)
    out = torch.empty(X.shape[0], dtype=torch.float64, device=sv.device)
    coef = dual_coef.to(device=sv.device, dtype=torch.float64)
    for r0 in range(0, X.shape[0], ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, X.shape[0])
        out[r0:r1] = rbf_kernel(X[r0:r1], sv, gamma) @ coef - rho
    return out
