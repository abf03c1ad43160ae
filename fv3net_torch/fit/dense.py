"""Apply side of the dense (MLP) model (port of
``fv3net_tpu/fit/dense.py``): normalize, a ReLU MLP, denormalize.

Training is not ported yet: :meth:`DenseModel.load` reads a model that
the reference package trained and dumped (its artifact format: a
``name`` file, ``weights.npz`` and ``metadata.json``), and
:func:`params_from_jax` carries one over in memory.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.fit import io, packer
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


def _output_limits_not_ported():
    return NotImplementedError(
        "output limits of the dense model are not ported to fv3net_torch "
        "yet (ROADMAP.md Queue 1 item 9)"
    )


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
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "DenseModel":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        if meta.get("output_limits"):
            raise _output_limits_not_ported()
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
        )


def params_from_jax(model, dtype=torch.float64, device=None) -> DenseModel:
    """The port's :class:`DenseModel` computing what a reference-package
    ``DenseModel`` computes: its params, scalers and packing layouts are
    read with ``np.asarray`` (no jax import needed here)."""
    if getattr(model, "output_limits", None):
        raise _output_limits_not_ported()

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
