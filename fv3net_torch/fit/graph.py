"""A graph neural network on the cubed sphere (port of
``fv3net_tpu/fit/graph.py``; reference:
external/fv3fit/fv3fit/pytorch/graph/train.py:65, the ``graph`` trainer).

On the cubed sphere the 4-neighbour graph is structured, so a message
pass is a mean of shifted slices of the halo-extended field (one halo
append of width 1, ``parallel/halo.py::halo_append``), the node state
and that mean concatenated and through a shared ReLU layer.  Fields are
[..., tile, y, x, channels]; ``predict`` runs every sample in one
batched call.  The trainer takes one Adam step a time sample, in order,
``epochs`` times, as the reference's scan does; the initial weights are
the port's draws from a ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.fit import io
from fv3net_torch.fit.config import OptimizerConfig
from fv3net_torch.fit.convolutional import (
    _channels_to_fields,
    _fields_to_channels,
    _info,
    _info_dict,
    _z_variable_names,
)
from fv3net_torch.fit.networks import _detached, _with_leaves, tree_map
from fv3net_torch.fit.normalize import StandardScaler
from fv3net_torch.fit.packer import PackingInfo
from fv3net_torch.fit.predictor import Predictor
from fv3net_torch.fit.train import register_training_function
from fv3net_torch.parallel.halo import halo_append


@dataclasses.dataclass
class GraphHyperparameters:
    input_variables: List[str] = dataclasses.field(default_factory=list)
    output_variables: List[str] = dataclasses.field(default_factory=list)
    hidden_width: int = 64
    n_message_passing: int = 3
    learning_rate: float = 1e-3
    epochs: int = 10
    seed: int = 0


def _neighbor_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the 4 cube neighbours of [..., 6, ny, nx, C] through one
    halo append."""
    lead = x.ndim - 4
    # [6, ..., C, ny, nx] for the halo append, then back
    xt = torch.movedim(torch.movedim(x, lead, 0), -1, -3)
    ext = torch.movedim(torch.movedim(halo_append(xt, 1), -3, -1), 0, lead)
    return 0.25 * (
        ext[..., :-2, 1:-1, :]
        + ext[..., 2:, 1:-1, :]
        + ext[..., 1:-1, :-2, :]
        + ext[..., 1:-1, 2:, :]
    )


def _init_gnn(generator: torch.Generator, cin: int, width: int, depth: int,
              cout: int, dtype=torch.float32, device=None):
    """The reference's scales, the port's normal draws (in float64 from
    ``generator``, cast last) and zero biases."""
    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, dtype=torch.float64)
                * math.sqrt(1.0 / fan_in)).to(dtype=dtype, device=device)

    params = {"layers": []}
    dims_in = cin
    for _ in range(depth):
        params["layers"].append({
            "w": normal((2 * dims_in, width), dims_in),
            "b": torch.zeros(width, dtype=dtype, device=device)})
        dims_in = width
    params["out"] = {"w": normal((dims_in, cout), dims_in),
                     "b": torch.zeros(cout, dtype=dtype, device=device)}
    return params


def gnn_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: [..., 6, ny, nx, Cin] -> [..., 6, ny, nx, Cout]; each layer
    concatenates node state with its neighbour mean and applies a shared
    layer."""
    h = x
    for layer in params["layers"]:
        agg = _neighbor_mean(h)
        h = torch.relu(torch.cat([h, agg], dim=-1) @ layer["w"]
                       + layer["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


@io.register("graph")
class GraphModel(Predictor):
    def __init__(self, input_variables, output_variables, params,
                 input_info, output_info, x_scaler, y_scaler,
                 output_z_names=None):
        super().__init__(list(input_variables), list(output_variables))
        self.params = params
        self.input_info = input_info
        self.output_info = output_info
        self.x_scaler = x_scaler
        self.y_scaler = y_scaler
        self.output_z_names = (
            tuple(output_z_names) if output_z_names is not None else None
        )

    def to(self, device=None, dtype=None):
        """Move the weights and scalers (in place); returns the model."""
        def mv(x):
            return x.to(device=device, dtype=dtype)

        self.params = tree_map(mv, self.params)
        self.x_scaler = StandardScaler(mv(self.x_scaler.mean),
                                       mv(self.x_scaler.std))
        self.y_scaler = StandardScaler(mv(self.y_scaler.mean),
                                       mv(self.y_scaler.std))
        return self

    def apply_channels(self, params, x):
        return self.y_scaler.denormalize(
            gnn_apply(params, self.x_scaler.normalize(x)))

    @torch.no_grad()
    def predict(self, X: Dataset) -> Dataset:
        arr, _ = _fields_to_channels(X, self.input_variables)
        out = self.apply_channels(self.params, arr.to(
            device=self.x_scaler.mean.device))
        q0 = X[self.input_variables[0]]
        prefix = tuple(d for d in q0.dims if d not in ("tile", "z", "y", "x"))
        return Dataset(
            _channels_to_fields(
                out, self.output_info,
                prefix + ("tile", "z", "y", "x"),
                prefix + ("tile", "y", "x"),
                z_names=self.output_z_names,
            )
        )

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

        def n(x):
            return x.detach().cpu().numpy()

        flat = {}
        for i, layer in enumerate(self.params["layers"]):
            flat[f"w{i}"] = n(layer["w"])
            flat[f"b{i}"] = n(layer["b"])
        flat["w_out"] = n(self.params["out"]["w"])
        flat["b_out"] = n(self.params["out"]["b"])
        flat.update(
            x_mean=n(self.x_scaler.mean),
            x_std=n(self.x_scaler.std),
            y_mean=n(self.y_scaler.mean),
            y_std=n(self.y_scaler.std),
        )
        np.savez(os.path.join(path, "weights.npz"), **flat)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {
                    "input_variables": self.input_variables,
                    "output_variables": self.output_variables,
                    "input_info": _info_dict(self.input_info),
                    "output_info": _info_dict(self.output_info),
                    "n_layers": len(self.params["layers"]),
                    "output_z_names": (
                        list(self.output_z_names)
                        if self.output_z_names is not None else None
                    ),
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "GraphModel":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "weights.npz"))

        def t(key):
            return torch.tensor(z[key])

        params = {
            "layers": [{"w": t(f"w{i}"), "b": t(f"b{i}")}
                       for i in range(meta["n_layers"])],
            "out": {"w": t("w_out"), "b": t("b_out")},
        }
        return cls(
            meta["input_variables"],
            meta["output_variables"],
            params,
            _info(meta["input_info"]),
            _info(meta["output_info"]),
            StandardScaler(t("x_mean"), t("x_std")),
            StandardScaler(t("y_mean"), t("y_std")),
            output_z_names=meta.get("output_z_names"),
        )


def graph_from_jax(model, dtype=None) -> GraphModel:
    """The port's :class:`GraphModel` of a reference-package one, its
    arrays read with ``np.asarray`` (in ``dtype`` if given)."""
    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype)

    def info(i):
        return PackingInfo(list(i.names), [int(f) for f in i.features])

    params = {"layers": [{"w": t(p["w"]), "b": t(p["b"])}
                         for p in model.params["layers"]],
              "out": {"w": t(model.params["out"]["w"]),
                      "b": t(model.params["out"]["b"])}}
    return GraphModel(
        model.input_variables, model.output_variables, params,
        info(model.input_info), info(model.output_info),
        StandardScaler(t(model.x_scaler.mean), t(model.x_scaler.std)),
        StandardScaler(t(model.y_scaler.mean), t(model.y_scaler.std)),
        output_z_names=model.output_z_names)


@register_training_function("graph", GraphHyperparameters)
def train_graph_network(hp: GraphHyperparameters, train_batches, val=None):
    """Train on batches of cube-shaped Datasets ([..., tile, z, y, x]) on
    the batches' device, in their dtype; leading dimensions before the
    tile are the samples."""
    xs, ys = [], []
    x_info = y_info = None
    out_z_names = None
    for ds in train_batches:
        X, x_info = _fields_to_channels(ds, hp.input_variables)
        Y, y_info = _fields_to_channels(ds, hp.output_variables)
        if out_z_names is None:
            out_z_names = _z_variable_names(ds, hp.output_variables)
        xs.append(X.reshape((-1,) + tuple(X.shape[-4:])))
        ys.append(Y.reshape((-1,) + tuple(Y.shape[-4:])))
    X = torch.cat(xs)
    Y = torch.cat(ys)
    x_scaler = StandardScaler.fit(X.reshape(-1, X.shape[-1]))
    y_scaler = StandardScaler.fit(Y.reshape(-1, Y.shape[-1]))

    leaves: list = []
    params = _with_leaves(_init_gnn(
        torch.Generator().manual_seed(hp.seed), X.shape[-1], hp.hidden_width,
        hp.n_message_passing, Y.shape[-1], dtype=X.dtype, device=X.device),
        leaves)
    tx = OptimizerConfig("adam", {"learning_rate": hp.learning_rate}
                         ).instance
    xn = x_scaler.normalize(X)
    yn = y_scaler.normalize(Y)
    with torch.enable_grad():
        for _ in range(hp.epochs):
            for i in range(xn.shape[0]):
                loss = torch.mean((gnn_apply(params, xn[i]) - yn[i]) ** 2)
                tx.step(leaves, torch.autograd.grad(loss, leaves))
    return GraphModel(
        hp.input_variables, hp.output_variables,
        _detached(params), x_info, y_info,
        x_scaler, y_scaler, output_z_names=out_z_names,
    )
