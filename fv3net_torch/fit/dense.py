"""The dense (MLP) model and its trainer (port of
``fv3net_tpu/fit/dense.py``; reference: external/fv3fit/fv3fit/keras/
_models/dense.py:90 ``train_dense_model``): normalize, a ReLU MLP,
denormalize, clamp to the output limits.

:func:`train_dense_model` trains as the reference does: the same
minibatch indices (``np.random.RandomState(seed)``, one permutation per
epoch), the loss (mse or mae with its weight, plus the l2 or regularizer
penalty) and the optax update rules of ``fit/config.py``.  The
reference runs its steps as one ``lax.scan``; here they are a Python
loop with autograd.  The initial weights are the port's own He-normal
draws from a ``torch.Generator`` seeded with ``seed``: the reference's
distribution, not its numbers.  :meth:`DenseModel.dump` and
:meth:`DenseModel.load` use the reference's artifact format (a ``name``
file, ``weights.npz`` and ``metadata.json``), and :func:`params_from_jax`
carries a reference model over in memory.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.fit import io, packer
from fv3net_torch.fit.config import OutputLimitConfig
from fv3net_torch.fit.normalize import StandardScaler
from fv3net_torch.fit.train import register_training_function


@dataclasses.dataclass
class DenseHyperparameters:
    """The reference's dense hyperparameters (keras/_models/dense.py:36).
    The nested ``dense_network`` ({width, depth, kernel_regularizer:
    {name, kwargs}}), ``optimizer_config`` ({name, kwargs,
    learning_rate_schedule}) and ``loss`` ({loss_type: mse|mae, weight})
    override the flat knobs; ``output_limit_config`` ({name: {min, max}})
    clamps the predictions."""

    input_variables: List[str] = dataclasses.field(default_factory=list)
    output_variables: List[str] = dataclasses.field(default_factory=list)
    hidden_layers: int = 3
    width: int = 419
    learning_rate: float = 1e-3
    epochs: int = 10
    batch_size: int = 512
    l2_regularization: float = 0.0
    seed: int = 0
    dense_network: Optional[dict] = None
    optimizer_config: Optional[dict] = None
    loss: Optional[dict] = None
    output_limit_config: Optional[dict] = None


def init_mlp_params(generator: torch.Generator, sizes: Sequence[int],
                    dtype=torch.float32, device=None) -> List[dict]:
    """He-normal weights ``w`` [n_in, n_out] and zero biases, drawn in
    float64 on the CPU from ``generator`` and cast last (the same
    distribution as the reference's ``init_mlp_params``; not the same
    numbers)."""
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((n_in, n_out), generator=generator,
                        dtype=torch.float64) * math.sqrt(2.0 / n_in)
        params.append({
            "w": w.to(dtype=dtype, device=device),
            "b": torch.zeros(n_out, dtype=dtype, device=device),
        })
    return params


def mlp_apply(params, x):
    """The ReLU MLP on a list of {"w", "b"} layers."""
    for layer in params[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    last = params[-1]
    return x @ last["w"] + last["b"]


@io.register("dense")
class DenseModel(nn.Module):
    """MLP on packed [sample, feature] tensors with standard normalization
    fused into the forward pass."""

    def __init__(
        self,
        input_variables: Sequence[str],
        output_variables: Sequence[str],
        params: Sequence[dict],
        input_info: packer.PackingInfo,
        output_info: packer.PackingInfo,
        x_scaler: StandardScaler,
        y_scaler: StandardScaler,
        output_limits: Optional[OutputLimitConfig] = None,
    ):
        super().__init__()
        self.input_variables = list(input_variables)
        self.output_variables = list(output_variables)
        self.input_info = input_info
        self.output_info = output_info
        self.layers = nn.ModuleList()
        for p in params:
            w = p["w"]
            n_in, n_out = w.shape
            layer = nn.Linear(n_in, n_out, dtype=w.dtype, device=w.device)
            with torch.no_grad():
                layer.weight.copy_(w.T)
                layer.bias.copy_(p["b"])
            self.layers.append(layer)
        self.register_buffer("x_mean", x_scaler.mean)
        self.register_buffer("x_std", x_scaler.std)
        self.register_buffer("y_mean", y_scaler.mean)
        self.register_buffer("y_std", y_scaler.std)
        self.output_limits = output_limits or None
        if self.output_limits:
            lo, hi = self.output_limits.packed_bounds(output_info.names,
                                                      output_info.features)
            self.register_buffer("y_min", torch.as_tensor(
                lo, dtype=y_scaler.mean.dtype, device=y_scaler.mean.device))
            self.register_buffer("y_max", torch.as_tensor(
                hi, dtype=y_scaler.mean.dtype, device=y_scaler.mean.device))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        """Packed [sample, feature] inputs -> packed outputs."""
        x = (X - self.x_mean) / self.x_std
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        y = self.layers[-1](x)
        Y = y * self.y_std + self.y_mean
        if self.output_limits:
            Y = torch.clamp(Y, self.y_min, self.y_max)
        return Y

    apply_packed = forward  # the reference's name

    def apply_params(self, params: Dict[str, torch.Tensor],
                     X: torch.Tensor) -> torch.Tensor:
        """The forward pass with ``params`` (name -> tensor, the names of
        ``named_parameters``) in place of the module's own: the pure
        apply (the reference's ``apply_packed(params, X)``) that
        ``torch.func`` differentiates."""
        return torch.func.functional_call(self, params, (X,))

    @torch.no_grad()
    def predict_arrays(
        self, data: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """Named [sample(, z)] inputs -> named outputs (inference: no
        autograd graph)."""
        X, _ = packer.pack(data, self.input_variables)
        return packer.unpack(self.apply_packed(X), self.output_info)

    def predict(self, X: Dataset) -> Dataset:
        """A Dataset of [sample(, z)] inputs -> one of the outputs."""
        data = packer.dataset_to_samples(X, self.input_variables)
        return packer.samples_to_dataset(self.predict_arrays(data))

    # -- serialization: the reference's artifact format ------------------
    def dump(self, path: str) -> None:
        """``weights.npz`` (``w{i}`` [n_in, n_out], ``b{i}``, the scalers)
        and ``metadata.json``; :func:`fv3net_torch.fit.io.dump` adds the
        ``name`` file."""
        os.makedirs(path, exist_ok=True)

        def n(x):
            return x.detach().cpu().numpy()

        flat = {}
        for i, layer in enumerate(self.layers):
            flat[f"w{i}"] = n(layer.weight).T
            flat[f"b{i}"] = n(layer.bias)
        for key in ("x_mean", "x_std", "y_mean", "y_std"):
            flat[key] = n(getattr(self, key))
        np.savez(os.path.join(path, "weights.npz"), **flat)

        def info(i):
            return {"names": list(i.names), "features": list(i.features)}

        meta = {
            "input_variables": self.input_variables,
            "output_variables": self.output_variables,
            "input_info": info(self.input_info),
            "output_info": info(self.output_info),
            "n_layers": len(self.layers),
        }
        if self.output_limits:
            meta["output_limits"] = self.output_limits.to_dict()
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "DenseModel":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "weights.npz"))

        def t(key):
            return torch.tensor(z[key])

        def info(d):
            return packer.PackingInfo(list(d["names"]),
                                      [int(f) for f in d["features"]])

        return cls(
            input_variables=meta["input_variables"],
            output_variables=meta["output_variables"],
            params=[{"w": t(f"w{i}"), "b": t(f"b{i}")}
                    for i in range(meta["n_layers"])],
            input_info=info(meta["input_info"]),
            output_info=info(meta["output_info"]),
            x_scaler=StandardScaler(t("x_mean"), t("x_std")),
            y_scaler=StandardScaler(t("y_mean"), t("y_std")),
            output_limits=_load_output_limits(meta),
        )


def _load_output_limits(meta: dict) -> Optional[OutputLimitConfig]:
    if meta.get("output_limits"):
        return OutputLimitConfig.from_dict(meta["output_limits"])
    return None


def params_from_jax(model, dtype=torch.float64, device=None) -> DenseModel:
    """The port's :class:`DenseModel` computing what a reference-package
    ``DenseModel`` computes: its params, scalers and packing layouts are
    read with ``np.asarray`` (no jax import needed here)."""
    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    def info(i):
        return packer.PackingInfo(list(i.names), [int(f) for f in i.features])

    return DenseModel(
        input_variables=model.input_variables,
        output_variables=model.output_variables,
        params=[{"w": t(p["w"]), "b": t(p["b"])} for p in model.params],
        input_info=info(model.input_info),
        output_info=info(model.output_info),
        x_scaler=StandardScaler(t(model.x_scaler.mean), t(model.x_scaler.std)),
        y_scaler=StandardScaler(t(model.y_scaler.mean), t(model.y_scaler.std)),
        output_limits=(
            OutputLimitConfig.from_dict(model.output_limits.to_dict())
            if getattr(model, "output_limits", None) else None),
    )


def _collect(batches, input_variables, output_variables):
    """Batches (Datasets of [sample(, z)] Quantities) -> the packed
    [sample, feature] tensors X and Y, concatenated, with their
    layouts."""
    xs, ys = [], []
    x_info = y_info = None
    for ds in batches:
        data = packer.dataset_to_samples(
            ds, list(input_variables) + list(output_variables))
        X, x_info = packer.pack(data, input_variables)
        Y, y_info = packer.pack(data, output_variables)
        xs.append(X)
        ys.append(Y)
    return torch.cat(xs), torch.cat(ys), x_info, y_info


def minibatch_indices(n: int, batch_size: int, epochs: int,
                      seed: int) -> np.ndarray:
    """[epochs * steps_per_epoch, bs] sample indices, the reference's:
    one ``np.random.RandomState(seed)`` permutation per epoch, cut into
    ``max((n - bs) // bs + 1, 1)`` whole batches of ``bs = min(batch_size,
    n)``."""
    rng = np.random.RandomState(seed)
    bs = min(batch_size, n)
    steps = max((n - bs) // bs + 1, 1)
    return np.stack([
        rng.permutation(n)[: steps * bs].reshape(steps, bs)
        for _ in range(epochs)
    ]).reshape(epochs * steps, bs)


@register_training_function("dense", DenseHyperparameters)
def train_dense_model(hyperparameters: DenseHyperparameters,
                      train_batches, validation_batches=None) -> DenseModel:
    """Fit a :class:`DenseModel` to ``train_batches`` on the batches'
    device, in their dtype (``validation_batches`` is unused, as in the
    reference)."""
    from fv3net_torch.fit.config import (
        LearningRateScheduleConfig,
        OptimizerConfig,
        RegularizerConfig,
    )
    from fv3net_torch.fit.networks import DenseNetworkConfig

    hp = hyperparameters
    X, Y, x_info, y_info = _collect(train_batches, hp.input_variables,
                                    hp.output_variables)
    x_scaler = StandardScaler.fit(X)
    y_scaler = StandardScaler.fit(Y)

    width, n_hidden = hp.width, hp.hidden_layers
    penalty = None
    if hp.dense_network is not None:
        nd = dict(hp.dense_network)
        reg = nd.pop("kernel_regularizer", None)
        netcfg = DenseNetworkConfig(
            **nd, kernel_regularizer=(RegularizerConfig(**reg) if reg
                                      else RegularizerConfig("none")))
        width, n_hidden = netcfg.width, netcfg.depth - 1
        penalty = netcfg.penalty
    sizes = ([x_info.total_features] + [width] * n_hidden
             + [y_info.total_features])
    params = init_mlp_params(torch.Generator().manual_seed(hp.seed), sizes,
                             dtype=X.dtype, device=X.device)
    leaves = [p[k].detach().clone().requires_grad_(True)
              for p in params for k in ("w", "b")]
    params = [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
              for i in range(len(sizes) - 1)]

    if hp.optimizer_config is not None:
        oc = dict(hp.optimizer_config)
        sched = oc.pop("learning_rate_schedule", None)
        tx = OptimizerConfig(
            **oc, learning_rate_schedule=(
                LearningRateScheduleConfig(**sched) if sched else None),
        ).instance
    else:
        tx = OptimizerConfig("adam", {"learning_rate": hp.learning_rate}
                             ).instance

    xn = x_scaler.normalize(X)
    yn = y_scaler.normalize(Y)
    loss_type = (hp.loss or {}).get("loss_type", "mse")
    loss_weight = float((hp.loss or {}).get("weight", 1.0))

    def loss_fn(xb, yb):
        err = mlp_apply(params, xb) - yb
        if loss_type == "mae":
            loss = loss_weight * torch.mean(torch.abs(err))
        else:
            loss = loss_weight * torch.mean(err ** 2)
        if penalty is not None:
            loss = loss + penalty([{"w": p["w"]} for p in params])
        elif hp.l2_regularization > 0:
            loss = loss + hp.l2_regularization * sum(
                torch.sum(p["w"] ** 2) for p in params)
        return loss

    idx_all = torch.as_tensor(
        minibatch_indices(X.shape[0], hp.batch_size, hp.epochs, hp.seed),
        device=X.device)
    with torch.enable_grad():
        for idx in idx_all:
            grads = torch.autograd.grad(loss_fn(xn[idx], yn[idx]), leaves)
            tx.step(leaves, grads)

    output_limits = (OutputLimitConfig.from_dict(hp.output_limit_config)
                     if hp.output_limit_config else None)
    return DenseModel(
        input_variables=list(hp.input_variables),
        output_variables=list(hp.output_variables),
        params=[{k: v.detach() for k, v in p.items()} for p in params],
        input_info=x_info,
        output_info=y_info,
        x_scaler=x_scaler,
        y_scaler=y_scaler,
        output_limits=output_limits,
    )
