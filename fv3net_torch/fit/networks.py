"""Network builders and the generic training loop (port of
``fv3net_tpu/fit/networks.py``; reference:
external/fv3fit/fv3fit/keras/_models/shared/{dense_network.py:21-80,
convolutional_network.py:20-136, loss.py:54-95,
training_loop.py:19-140}).

A dense network is a list of {"w": [n_in, n_out], "b": [n_out]} layers
applied by a ReLU MLP; a convolutional one a list of {"w": [k, k, c_in,
c_out], "b": [c_out]} layers (the reference's HWIO layout) applied to
[batch, y, x, channels] tensors by ``F.conv2d``.  ``TrainingLoopConfig``
trains with the reference's minibatch indices (one
``np.random.RandomState(shuffle_seed)`` permutation per epoch) in a
Python loop with autograd, where the reference scans.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fv3net_torch.fit.config import OptimizerConfig, RegularizerConfig

__all__ = [
    "DenseNetworkConfig",
    "DenseNetwork",
    "ConvolutionalNetworkConfig",
    "ConvolutionalNetwork",
    "LossConfig",
    "TrainingLoopConfig",
    "EpochResult",
]


@dataclasses.dataclass
class DenseNetwork:
    """A built dense network: its layers and the config that applies
    them."""

    params: List[Mapping[str, torch.Tensor]]
    config: "DenseNetworkConfig"

    def __call__(self, x, generator: Optional[torch.Generator] = None):
        return self.config.apply(self.params, x, generator=generator)


@dataclasses.dataclass
class DenseNetworkConfig:
    """MLP builder: ``depth`` counts the hidden layers and the output
    layer; ``gaussian_noise`` is added to the hidden activations when a
    ``torch.Generator`` is passed (training mode)."""

    width: int = 8
    depth: int = 3
    kernel_regularizer: RegularizerConfig = dataclasses.field(
        default_factory=lambda: RegularizerConfig("none")
    )
    gaussian_noise: float = 0.0

    def build(self, generator: torch.Generator, n_features_in: int,
              n_features_out: int, dtype=torch.float32,
              device=None) -> DenseNetwork:
        """He-normal weights from ``generator`` (drawn in float64 on the
        CPU, cast last) and zero biases: the reference's distribution,
        not its numbers."""
        from fv3net_torch.fit.dense import init_mlp_params

        sizes = ([n_features_in] + [self.width] * (self.depth - 1)
                 + [n_features_out])
        params = init_mlp_params(generator, sizes, dtype=dtype,
                                 device=device)
        return DenseNetwork(params=params, config=self)

    def apply(self, params, x, generator: Optional[torch.Generator] = None):
        for layer in params[:-1]:
            x = torch.relu(x @ layer["w"] + layer["b"])
            if self.gaussian_noise > 0.0 and generator is not None:
                x = x + self.gaussian_noise * torch.randn(
                    x.shape, generator=generator, dtype=x.dtype,
                    device=x.device)
        last = params[-1]
        return x @ last["w"] + last["b"]

    def penalty(self, params) -> torch.Tensor:
        return self.kernel_regularizer.penalty(params)


@dataclasses.dataclass
class ConvolutionalNetwork:
    params: List[Mapping[str, torch.Tensor]]
    config: "ConvolutionalNetworkConfig"

    def __call__(self, x):
        return self.config.apply(self.params, x)


@dataclasses.dataclass
class ConvolutionalNetworkConfig:
    """2-D convolution stack: ``depth - 1`` hidden layers of ``filters``
    channels and a 1x1 output projection; ``halos_required`` is the halo
    width the VALID convolutions consume."""

    filters: int = 32
    depth: int = 3
    kernel_size: int = 3
    kernel_regularizer: RegularizerConfig = dataclasses.field(
        default_factory=lambda: RegularizerConfig("none")
    )

    @property
    def halos_required(self) -> int:
        return (self.kernel_size - 1) // 2 * (self.depth - 1)

    def build(self, generator: torch.Generator, n_channels_in: int,
              n_channels_out: int, dtype=torch.float32,
              device=None) -> ConvolutionalNetwork:
        """He-normal kernels from ``generator`` (drawn in float64 on the
        CPU, cast last) and zero biases: the reference's distribution,
        not its numbers."""
        chans = ([n_channels_in] + [self.filters] * (self.depth - 1)
                 + [n_channels_out])
        params = []
        for i, (c_in, c_out) in enumerate(zip(chans[:-1], chans[1:])):
            k = self.kernel_size if i < len(chans) - 2 else 1
            w = torch.randn((k, k, c_in, c_out), generator=generator,
                            dtype=torch.float64) * math.sqrt(
                                2.0 / (k * k * c_in))
            params.append({"w": w.to(dtype=dtype, device=device),
                           "b": torch.zeros(c_out, dtype=dtype,
                                            device=device)})
        return ConvolutionalNetwork(params=params, config=self)

    def apply(self, params, x):
        """x: [batch, y, x, channels]; the VALID convolutions (each a
        cross-correlation, as ``lax.conv_general_dilated``) shrink y and x
        by 2 * halos_required in all."""
        x = x.permute(0, 3, 1, 2)
        for i, layer in enumerate(params):
            x = F.conv2d(x, layer["w"].permute(3, 2, 0, 1), layer["b"])
            if i < len(params) - 1:
                x = torch.relu(x)
        return x.permute(0, 2, 3, 1)

    def penalty(self, params) -> torch.Tensor:
        return self.kernel_regularizer.penalty(params)


@dataclasses.dataclass
class LossConfig:
    """Scaled loss (reference loss.py:54-95): "mse" or "mae", scaled by
    "standard" (each feature's std) or "standard_uniform" (their mean),
    times ``weight``."""

    loss_type: str = "mse"
    scaling: str = "standard_uniform"
    weight: float = 1.0

    def loss(self, std: torch.Tensor) -> Callable[[torch.Tensor,
                                                   torch.Tensor],
                                                  torch.Tensor]:
        std = torch.as_tensor(std)
        if self.scaling == "standard_uniform":
            scale = torch.mean(std)
        elif self.scaling == "standard":
            scale = std
        else:
            raise ValueError(f"unknown scaling {self.scaling!r}")

        if self.loss_type == "mse":
            def fn(pred, target):
                return self.weight * torch.mean(((pred - target) / scale) ** 2)
        elif self.loss_type == "mae":
            def fn(pred, target):
                return self.weight * torch.mean(
                    torch.abs((pred - target) / scale))
        else:
            raise ValueError(f"unknown loss_type {self.loss_type!r}")
        return fn


@dataclasses.dataclass
class EpochResult:
    """Per-epoch metrics (reference training_loop.py:19-29)."""

    epoch: int
    batch_logs: Sequence[Mapping[str, float]]
    epoch_logs: Mapping[str, float]


def _with_leaves(tree, leaves: list):
    """A copy of a nested dict/list/tuple of tensors whose tensors are
    fresh leaves that require grad (appended to ``leaves``)."""
    if torch.is_tensor(tree):
        leaf = tree.detach().clone().requires_grad_(True)
        leaves.append(leaf)
        return leaf
    if isinstance(tree, Mapping):
        return {k: _with_leaves(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_leaves(v, leaves) for v in tree)
    return tree


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list/tuple in JAX's pytree flatten
    order (dict keys sorted, sequences in order): the order in which the
    reference's artifacts number a network's leaves."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(skeleton, leaves):
    """``skeleton``'s structure with its tensors replaced, in
    :func:`tree_leaves`' order, by ``leaves``."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, Mapping):
            filled = {k: fill(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v) for v in node)
        return next(it)

    return fill(skeleton)


def tree_map(fn, tree):
    """``fn`` on each tensor of a nested dict/list/tuple."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _detached(tree):
    if torch.is_tensor(tree):
        return tree.detach()
    if isinstance(tree, Mapping):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree


@dataclasses.dataclass
class TrainingLoopConfig:
    """Generic minibatch training loop (reference
    training_loop.py:61-140): ``epochs`` passes over whole batches of
    ``batch_size`` in the order of one permutation per epoch; after each
    epoch the ``callbacks`` get its EpochResult."""

    epochs: int = 3
    batch_size: int = 16
    shuffle_seed: int = 0

    def fit_loop(
        self,
        loss_fn: Callable,
        params,
        X: torch.Tensor,
        y: torch.Tensor,
        optimizer=None,
        validation_data=None,
        callbacks: Sequence[Callable[[EpochResult], None]] = (),
    ):
        """Args:
            loss_fn: ``loss_fn(params, X_batch, y_batch) -> scalar``.
            params: initial parameters, a nested dict/list of tensors.
            X, y: [sample, ...] tensors.
            optimizer: an optimizer of ``fit/config.py`` (default:
                ``OptimizerConfig().instance``).
        Returns:
            (trained params, [EpochResult]): ``epoch_logs`` hold the mean
            training loss and, with ``validation_data``, ``val_loss``.
        """
        optimizer = optimizer or OptimizerConfig().instance
        n = X.shape[0]
        n_batches = max(n // self.batch_size, 1)
        used = n_batches * self.batch_size
        rng = np.random.RandomState(self.shuffle_seed)
        perms = torch.as_tensor(np.stack(
            [rng.permutation(n)[:used] for _ in range(self.epochs)]
        ).reshape(self.epochs, n_batches, self.batch_size), device=X.device)
        leaves: list = []
        params = _with_leaves(params, leaves)
        results = []
        for e in range(self.epochs):
            losses = []
            with torch.enable_grad():
                for idx in perms[e]:
                    loss = loss_fn(params, X[idx], y[idx])
                    grads = torch.autograd.grad(loss, leaves)
                    optimizer.step(leaves, grads)
                    losses.append(float(loss.detach()))
            logs = {"loss": float(np.mean(losses))}
            if validation_data is not None:
                xv, yv = validation_data
                with torch.no_grad():
                    logs["val_loss"] = float(loss_fn(
                        params, torch.as_tensor(xv, device=X.device),
                        torch.as_tensor(yv, device=X.device)))
            result = EpochResult(
                epoch=e,
                batch_logs=[{"loss": v} for v in losses],
                epoch_logs=logs,
            )
            for cb in callbacks:
                cb(result)
            results.append(result)
        return _detached(params), results
