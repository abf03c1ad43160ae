"""The transformed microphysics-emulator trainer (port of
``fv3net_tpu/fit/transformed.py``; reference:
external/fv3fit/fv3fit/train_microphysics.py:451
``@register_training_function("transformed", TransformedParameters)``).

A network trained in a *transformed* space built from the tensor
transforms of ``emulation/transforms.py`` (log humidity, differences,
output limits), with a ``dense``, ``linear`` or ``rnn`` architecture.
The predictor applies the forward transforms, the network and the
inverse transforms, and has ``predict_arrays``, so it drops into
``emulation.MicrophysicsEmulator``.

The ``rnn`` is the reference's GRU cell with no hidden bias
(``n = tanh(gx_n + r * (h @ wh_n))``), run down the column one level at
a time; ``torch.nn.GRU`` has a trainable hidden bias the reference
lacks.  The artifact numbers the parameters in JAX's pytree flatten
order (dict keys sorted, lists in order), so each package loads the
other's.  The trainer draws the reference's minibatch indices and steps
with optax's adam; the initial weights are the port's draws from a
``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.emulation.transforms import (
    ComposedTransform,
    Difference,
    LimitValueTransform,
    LogTransform,
)
from fv3net_torch.fit import io, packer
from fv3net_torch.fit.config import OptimizerConfig
from fv3net_torch.fit.convolutional import _info, _info_dict
from fv3net_torch.fit.dense import (
    init_mlp_params,
    minibatch_indices,
    mlp_apply,
)
from fv3net_torch.fit.networks import (
    _detached,
    _with_leaves,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from fv3net_torch.fit.normalize import StandardScaler
from fv3net_torch.fit.predictor import Predictor
from fv3net_torch.fit.train import register_training_function

_TRANSFORM_KINDS = {
    "log": LogTransform,
    "limit": LimitValueTransform,
    "difference": Difference,
}


def build_transform(specs: Sequence[Dict]) -> ComposedTransform:
    """[{kind: log|limit|difference, ...kwargs}] -> ComposedTransform."""
    ts = []
    for spec in specs:
        kw = {k: v for k, v in spec.items() if k != "kind"}
        ts.append(_TRANSFORM_KINDS[spec["kind"]](**kw))
    return ComposedTransform(ts)


def _source_fields(specs: Sequence[Dict], names: Sequence[str]) -> set:
    """The raw fields that produce the transformed tensor ``names``
    (names no transform produces are themselves)."""
    produced: Dict[str, set] = {}
    for spec in specs:
        if spec["kind"] == "log":
            to = spec.get("to") or f"log_{spec['field']}"
            produced[to] = {spec["field"]}
        elif spec["kind"] == "difference":
            produced[spec["to"]] = {spec["before"], spec["after"]}
    needed: set = set()
    for name in names:
        needed |= produced.get(name, {name})
    return needed


def _predict_time_inputs(hp: "TransformedParameters") -> List[str]:
    """The physical fields the network's inputs are made of (the state
    the predictor reads)."""
    return sorted(_source_fields(hp.tensor_transforms, hp.input_variables))


@dataclasses.dataclass
class TransformedParameters:
    """(reference: TransformedParameters at train_microphysics.py:284-451;
    the variables are the names after the forward transforms)"""

    input_variables: List[str] = dataclasses.field(default_factory=list)
    output_variables: List[str] = dataclasses.field(default_factory=list)
    # raw fields read from each batch before the forward transform
    # (default: the sources of the input and output variables)
    data_variables: Optional[List[str]] = None
    # physical outputs after the backward transform (default:
    # output_variables)
    predicted_variables: Optional[List[str]] = None
    tensor_transforms: List[Dict] = dataclasses.field(default_factory=list)
    architecture: str = "dense"  # dense | linear | rnn
    hidden_layers: int = 2
    width: int = 256
    learning_rate: float = 1e-3
    epochs: int = 10
    batch_size: int = 512
    seed: int = 0


# ---------------------------------------------------------------------------
# architectures
# ---------------------------------------------------------------------------
def _init_rnn_params(generator: torch.Generator, nvar_in: int, width: int,
                     nvar_out: int, dtype=torch.float32, device=None):
    """The GRU cell's weights (the reference's scales, the port's normal
    draws in float64 from ``generator``, cast last) and zero biases."""
    scale_x = math.sqrt(1.0 / max(nvar_in, 1))
    scale_h = math.sqrt(1.0 / width)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float64)
                * scale).to(dtype=dtype, device=device)

    return {
        "wx": normal((nvar_in, 3 * width), scale_x),
        "wh": normal((width, 3 * width), scale_h),
        "b": torch.zeros(3 * width, dtype=dtype, device=device),
        "wo": normal((width, nvar_out), scale_h),
        "bo": torch.zeros(nvar_out, dtype=dtype, device=device),
    }


def _rnn_apply(p, x_lev: torch.Tensor) -> torch.Tensor:
    """x_lev [sample, nz, nvar_in] -> [sample, nz, nvar_out]: the GRU down
    the column (level 0 = top), its input products for every level in one
    product."""
    width = p["wh"].shape[0]
    gates_all = x_lev @ p["wx"] + p["b"]  # [sample, nz, 3 width]
    h = torch.zeros(x_lev.shape[:1] + (width,), dtype=gates_all.dtype,
                    device=x_lev.device)
    hs = []
    for k in range(x_lev.shape[1]):
        gates = gates_all[:, k]
        gh = h @ p["wh"]
        r = torch.sigmoid(gates[..., :width] + gh[..., :width])
        z = torch.sigmoid(gates[..., width: 2 * width]
                          + gh[..., width: 2 * width])
        n = torch.tanh(gates[..., 2 * width:] + r * gh[..., 2 * width:])
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1) @ p["wo"] + p["bo"]


def _init_params(hp: TransformedParameters, generator, in_info, out_info,
                 dtype=torch.float32, device=None):
    if hp.architecture == "rnn":
        return _init_rnn_params(generator, len(in_info.names), hp.width,
                                len(out_info.names), dtype, device)
    if hp.architecture == "linear":
        sizes = [in_info.total_features, out_info.total_features]
    elif hp.architecture == "dense":
        sizes = ([in_info.total_features] + [hp.width] * hp.hidden_layers
                 + [out_info.total_features])
    else:
        raise ValueError(f"unknown architecture {hp.architecture!r}")
    return init_mlp_params(generator, sizes, dtype=dtype, device=device)


def _net_apply(arch: str, params, X, in_info, out_info):
    """Packed [sample, nf_in] -> [sample, nf_out] for any architecture."""
    if arch != "rnn":
        return mlp_apply(params, X)
    sl = in_info.slices()
    nz = max(in_info.features)
    cols = []
    for name, nf in zip(in_info.names, in_info.features):
        arr = X[..., sl[name]]
        if nf == 1:  # broadcast scalars down the column
            arr = arr.expand(arr.shape[:-1] + (nz,))
        cols.append(arr)
    y_lev = _rnn_apply(params, torch.stack(cols, dim=-1))
    for nf in out_info.features:
        if nf != nz:
            raise ValueError("rnn architecture requires nz-sized outputs")
    return torch.cat([y_lev[..., i] for i in range(len(out_info.features))],
                     dim=-1)


def _skeleton(hp: TransformedParameters, in_info, out_info):
    """The parameter structure of ``hp``'s network (no draws kept)."""
    return _init_params(hp, torch.Generator().manual_seed(0), in_info,
                        out_info)


@io.register("transformed")
class TransformedPredictor(Predictor):
    """Forward transforms -> network -> inverse transforms."""

    def __init__(
        self,
        data_variables: Sequence[str],
        predicted_variables: Sequence[str],
        hp: TransformedParameters,
        params,
        in_info: packer.PackingInfo,
        out_info: packer.PackingInfo,
        x_scaler: StandardScaler,
        y_scaler: StandardScaler,
    ):
        super().__init__(list(data_variables), list(predicted_variables))
        self.hp = hp
        self.params = params
        self.in_info = in_info
        self.out_info = out_info
        self.x_scaler = x_scaler
        self.y_scaler = y_scaler
        self.transform = build_transform(hp.tensor_transforms)

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

    def apply_packed(self, params, X: torch.Tensor) -> torch.Tensor:
        xn = self.x_scaler.normalize(X)
        yn = _net_apply(self.hp.architecture, params, xn, self.in_info,
                        self.out_info)
        return self.y_scaler.denormalize(yn)

    @torch.no_grad()
    def predict_arrays(
        self, data: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        t = self.transform.forward(dict(data))
        X, _ = packer.pack(t, self.hp.input_variables)
        Y = self.apply_packed(self.params, X)
        t.update(packer.unpack(Y, self.out_info, squeeze_scalar=False))
        phys = self.transform.backward(t)
        return {k: phys[k] for k in self.output_variables}

    def predict(self, X: Dataset) -> Dataset:
        data = packer.dataset_to_samples(X, self.input_variables)
        return packer.samples_to_dataset(self.predict_arrays(data))

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

        def n(x):
            return x.detach().cpu().numpy()

        flat = {f"p{i}": n(leaf)
                for i, leaf in enumerate(tree_leaves(self.params))}
        flat["x_mean"] = n(self.x_scaler.mean)
        flat["x_std"] = n(self.x_scaler.std)
        flat["y_mean"] = n(self.y_scaler.mean)
        flat["y_std"] = n(self.y_scaler.std)
        np.savez(os.path.join(path, "weights.npz"), **flat)
        meta = {
            "data_variables": self.input_variables,
            "predicted_variables": self.output_variables,
            "hp": dataclasses.asdict(self.hp),
            "in_info": _info_dict(self.in_info),
            "out_info": _info_dict(self.out_info),
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "TransformedPredictor":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        hp = TransformedParameters(**meta["hp"])
        in_info = _info(meta["in_info"])
        out_info = _info(meta["out_info"])
        skeleton = _skeleton(hp, in_info, out_info)
        z = np.load(os.path.join(path, "weights.npz"))
        n_leaves = len(tree_leaves(skeleton))
        params = tree_unflatten(
            skeleton, [torch.tensor(z[f"p{i}"]) for i in range(n_leaves)])

        def t(key):
            return torch.tensor(z[key])

        return cls(
            data_variables=meta["data_variables"],
            predicted_variables=meta["predicted_variables"],
            hp=hp,
            params=params,
            in_info=in_info,
            out_info=out_info,
            x_scaler=StandardScaler(t("x_mean"), t("x_std")),
            y_scaler=StandardScaler(t("y_mean"), t("y_std")),
        )


def transformed_from_jax(model, dtype=None) -> TransformedPredictor:
    """The port's :class:`TransformedPredictor` of a reference-package
    one, its arrays read with ``np.asarray`` (in ``dtype`` if given)."""
    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype)

    def info(i):
        return packer.PackingInfo(list(i.names), [int(f) for f in i.features])

    hp = TransformedParameters(**dataclasses.asdict(model.hp))
    in_info, out_info = info(model.in_info), info(model.out_info)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        return t(node)

    return TransformedPredictor(
        model.input_variables, model.output_variables, hp,
        convert(model.params), in_info, out_info,
        StandardScaler(t(model.x_scaler.mean), t(model.x_scaler.std)),
        StandardScaler(t(model.y_scaler.mean), t(model.y_scaler.std)))


@register_training_function("transformed", TransformedParameters)
def train_transformed_model(
    hyperparameters: TransformedParameters,
    train_batches,
    validation_batches=None,
) -> TransformedPredictor:
    """Fit a :class:`TransformedPredictor` on the batches' device, in
    their dtype."""
    hp = hyperparameters
    transform = build_transform(hp.tensor_transforms)
    data_vars = hp.data_variables or sorted(_source_fields(
        hp.tensor_transforms,
        list(hp.input_variables) + list(hp.output_variables)))
    predicted = hp.predicted_variables or list(hp.output_variables)

    xs, ys = [], []
    in_info = out_info = None
    for ds in train_batches:
        t = transform.forward(packer.dataset_to_samples(ds, data_vars))
        X, in_info = packer.pack(t, hp.input_variables)
        Y, out_info = packer.pack(t, hp.output_variables)
        xs.append(X)
        ys.append(Y)
    X = torch.cat(xs)
    Y = torch.cat(ys)
    x_scaler = StandardScaler.fit(X)
    y_scaler = StandardScaler.fit(Y)

    leaves: list = []
    params = _with_leaves(_init_params(
        hp, torch.Generator().manual_seed(hp.seed), in_info, out_info,
        dtype=X.dtype, device=X.device), leaves)
    tx = OptimizerConfig("adam", {"learning_rate": hp.learning_rate}
                         ).instance
    xn = x_scaler.normalize(X)
    yn = y_scaler.normalize(Y)
    idx_all = torch.as_tensor(
        minibatch_indices(X.shape[0], hp.batch_size, hp.epochs, hp.seed),
        device=X.device)
    with torch.enable_grad():
        for idx in idx_all:
            pred = _net_apply(hp.architecture, params, xn[idx], in_info,
                              out_info)
            loss = torch.mean((pred - yn[idx]) ** 2)
            tx.step(leaves, torch.autograd.grad(loss, leaves))

    return TransformedPredictor(
        data_variables=_predict_time_inputs(hp),
        predicted_variables=predicted,
        hp=hp,
        params=_detached(params),
        in_info=in_info,
        out_info=out_info,
        x_scaler=x_scaler,
        y_scaler=y_scaler,
    )
