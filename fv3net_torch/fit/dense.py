"""Apply side of the dense (MLP) model (port of
``fv3net_tpu/fit/dense.py``): normalize, a ReLU MLP, denormalize.

Training is not ported yet; :func:`params_from_jax` carries a model
trained by the reference package into this one.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.fit import packer
from fv3net_torch.fit.normalize import StandardScaler


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

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        """Packed [sample, feature] inputs -> packed outputs."""
        x = (X - self.x_mean) / self.x_std
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        y = self.layers[-1](x)
        return y * self.y_std + self.y_mean

    apply_packed = forward  # the reference's name

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


def params_from_jax(model, dtype=torch.float64, device=None) -> DenseModel:
    """The port's :class:`DenseModel` computing what a reference-package
    ``DenseModel`` computes: its params, scalers and packing layouts are
    read with ``np.asarray`` (no jax import needed here)."""
    if getattr(model, "output_limits", None):
        raise NotImplementedError(
            "output limits of the dense model are not ported to "
            "fv3net_torch yet"
        )

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
    )
