"""The convolutional model and its trainer on the whole cube (port of
``fv3net_tpu/fit/convolutional.py``; reference:
external/fv3fit/fv3fit/keras/_models/convolutional.py:101 and
keras/_models/shared/convolutional_network.py:20-136).

Fields are [..., tile, y, x, channels] with each variable's z-levels
packed into channels, as in the reference.  One halo append
(``parallel/halo.py::halo_append``, corners included) widens each tile
by the halo the network consumes, then ``depth`` VALID convolutions
(``F.conv2d`` on the kernels' HWIO layout) shrink it back.  The trainer
takes one time sample a step over the samples in order, ``epochs``
times, with adam, in a Python loop with autograd where the reference
loops in one jitted ``fori_loop``; the initial kernels are the port's
own draws (:func:`init_conv_params`).  Leading dimensions before the
tile (time, or a windowed loader's sample and window) are flattened
into the samples.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import io
from fv3net_torch.fit.config import OptimizerConfig, OutputLimitConfig
from fv3net_torch.fit.normalize import StandardScaler
from fv3net_torch.fit.packer import PackingInfo
from fv3net_torch.fit.predictor import Predictor
from fv3net_torch.fit.train import register_training_function
from fv3net_torch.parallel.halo import halo_append


@dataclasses.dataclass
class ConvolutionalHyperparameters:
    input_variables: List[str] = dataclasses.field(default_factory=list)
    output_variables: List[str] = dataclasses.field(default_factory=list)
    filters: int = 32
    depth: int = 3  # convolution layers
    kernel_size: int = 3
    learning_rate: float = 1e-3
    epochs: int = 10
    seed: int = 0
    # {name: {min, max}} clamp of the predictions
    output_limit_config: Optional[dict] = None


def halos_required(depth: int, kernel_size: int) -> int:
    """(reference convolutional_network.py halos_required)"""
    return depth * ((kernel_size - 1) // 2)


def init_conv_params(generator: torch.Generator, channels: Sequence[int],
                     kernel_size: int, dtype=torch.float32, device=None):
    """He-normal HWIO kernels [k, k, c_in, c_out] and zero biases, drawn
    in float64 on the CPU from ``generator`` and cast last: the
    reference's distribution, not its numbers."""
    params = []
    for cin, cout in zip(channels[:-1], channels[1:]):
        fan_in = kernel_size * kernel_size * cin
        w = torch.randn((kernel_size, kernel_size, cin, cout),
                        generator=generator, dtype=torch.float64) * \
            math.sqrt(2.0 / fan_in)
        params.append({"w": w.to(dtype=dtype, device=device),
                       "b": torch.zeros(cout, dtype=dtype, device=device)})
    return params


def conv_apply(params, x: torch.Tensor, halo: int) -> torch.Tensor:
    """x: [..., tile, ny, nx, cin] -> [..., tile, ny, nx, cout]: one halo
    append, then the VALID convolutions (ReLU between them)."""
    lead = x.shape[:-4]
    b = int(np.prod(lead)) if lead else 1
    t, ny, nx, c = x.shape[-4:]
    # [6, b, c, ny, nx] for the halo append, then [6 * b, c, y, x]
    h = x.reshape(b, t, ny, nx, c).permute(1, 0, 4, 2, 3)
    h = halo_append(h, halo)
    h = h.reshape(t * b, c, ny + 2 * halo, nx + 2 * halo)
    for i, layer in enumerate(params):
        h = F.conv2d(h, layer["w"].permute(3, 2, 0, 1), layer["b"])
        if i < len(params) - 1:
            h = torch.relu(h)
    cout = h.shape[1]
    h = h.reshape(t, b, cout, ny, nx).permute(1, 0, 3, 4, 2)
    return h.reshape(tuple(lead) + (t, ny, nx, cout))


def _fields_to_channels(ds: Dataset, names: Sequence[str], device=None):
    """[.., tile, z, y, x] or [.., tile, y, x] variables ->
    [.., tile, y, x, C] and the PackingInfo of their channel counts."""
    arrays = []
    features = []
    for name in names:
        q = ds[name]
        arr = torch.as_tensor(q.data, device=device)
        if "z" in q.dims:
            arr = torch.movedim(arr, q.dims.index("z"), -1)
            features.append(arr.shape[-1])
        else:
            arr = arr[..., None]
            features.append(1)
        arrays.append(arr)
    return torch.cat(arrays, dim=-1), PackingInfo(list(names), features)


def _z_variable_names(ds: Dataset, names: Sequence[str]):
    """Which of ``names`` carry a z dimension (a one-level 3-D field has
    as many channels as a 2-D one)."""
    return tuple(n for n in names if "z" in ds[n].dims)


def _channels_to_fields(arr, info: PackingInfo, dims_3d, dims_2d,
                        z_names=None):
    out = {}
    start = 0
    for name, nf in zip(info.names, info.features):
        chunk = arr[..., start: start + nf]
        start += nf
        is_3d = (name in z_names) if z_names is not None else nf > 1
        if is_3d:
            out[name] = Quantity(torch.movedim(chunk, -1, -3), dims_3d)
        else:
            out[name] = Quantity(chunk[..., 0], dims_2d)
    return out


def _info_dict(info: PackingInfo) -> dict:
    return {"names": list(info.names), "features": list(info.features)}


def _info(d: dict) -> PackingInfo:
    return PackingInfo(list(d["names"]), [int(f) for f in d["features"]])


def _limits(d: Optional[dict]) -> Optional[OutputLimitConfig]:
    return OutputLimitConfig.from_dict(d) if d else None


@io.register("convolutional")
class ConvolutionalModel(Predictor):
    def __init__(
        self,
        input_variables,
        output_variables,
        params,
        input_info: PackingInfo,
        output_info: PackingInfo,
        x_scaler: StandardScaler,
        y_scaler: StandardScaler,
        kernel_size: int,
        output_z_names=None,
        output_limits: Optional[OutputLimitConfig] = None,
    ):
        super().__init__(list(input_variables), list(output_variables))
        self.params = params
        self.input_info = input_info
        self.output_info = output_info
        self.x_scaler = x_scaler
        self.y_scaler = y_scaler
        self.kernel_size = kernel_size
        self.output_z_names = (
            tuple(output_z_names) if output_z_names is not None else None
        )
        self.output_limits = output_limits

    @property
    def halo(self) -> int:
        return halos_required(len(self.params), self.kernel_size)

    def to(self, device=None, dtype=None):
        """Move the kernels and scalers (in place); returns the model."""
        def mv(x):
            return x.to(device=device, dtype=dtype)

        self.params = [{k: mv(v) for k, v in layer.items()}
                       for layer in self.params]
        self.x_scaler = StandardScaler(mv(self.x_scaler.mean),
                                       mv(self.x_scaler.std))
        self.y_scaler = StandardScaler(mv(self.y_scaler.mean),
                                       mv(self.y_scaler.std))
        return self

    def apply_channels(self, params, x):
        yn = conv_apply(params, self.x_scaler.normalize(x), self.halo)
        Y = self.y_scaler.denormalize(yn)
        if self.output_limits:
            Y = self.output_limits.limit_packed(Y, self.output_info)
        return Y

    @torch.no_grad()
    def predict(self, X: Dataset) -> Dataset:
        arr, _ = _fields_to_channels(X, self.input_variables)
        out = self.apply_channels(self.params, arr.to(
            device=self.x_scaler.mean.device))
        q0 = X[self.input_variables[0]]
        prefix = tuple(d for d in q0.dims if d not in ("tile", "z", "y", "x"))
        dims_3d = prefix + ("tile", "z", "y", "x")
        dims_2d = prefix + ("tile", "y", "x")
        return Dataset(
            _channels_to_fields(out, self.output_info, dims_3d, dims_2d,
                                z_names=self.output_z_names)
        )

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

        def n(x):
            return x.detach().cpu().numpy()

        flat = {}
        for i, layer in enumerate(self.params):
            flat[f"w{i}"] = n(layer["w"])
            flat[f"b{i}"] = n(layer["b"])
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
                    "n_layers": len(self.params),
                    "kernel_size": self.kernel_size,
                    "output_z_names": (
                        list(self.output_z_names)
                        if self.output_z_names is not None else None
                    ),
                    "output_limits": (
                        self.output_limits.to_dict()
                        if self.output_limits else None
                    ),
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "ConvolutionalModel":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "weights.npz"))

        def t(key):
            return torch.tensor(z[key])

        params = [{"w": t(f"w{i}"), "b": t(f"b{i}")}
                  for i in range(meta["n_layers"])]
        return cls(
            meta["input_variables"],
            meta["output_variables"],
            params,
            _info(meta["input_info"]),
            _info(meta["output_info"]),
            StandardScaler(t("x_mean"), t("x_std")),
            StandardScaler(t("y_mean"), t("y_std")),
            meta["kernel_size"],
            output_z_names=meta.get("output_z_names"),
            output_limits=_limits(meta.get("output_limits")),
        )


@register_training_function("convolutional", ConvolutionalHyperparameters)
def train_convolutional_model(
    hyperparameters: ConvolutionalHyperparameters, train_batches, val=None
) -> ConvolutionalModel:
    """Train on batches of cube-shaped Datasets ([..., tile, z, y, x]) on
    the batches' device, in their dtype."""
    hp = hyperparameters
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
    X = torch.cat(xs)  # [sample, 6, ny, nx, Cin]
    Y = torch.cat(ys)

    x_scaler = StandardScaler.fit(X.reshape(-1, X.shape[-1]))
    y_scaler = StandardScaler.fit(Y.reshape(-1, Y.shape[-1]))

    channels = [X.shape[-1]] + [hp.filters] * (hp.depth - 1) + [Y.shape[-1]]
    params = init_conv_params(torch.Generator().manual_seed(hp.seed),
                              channels, hp.kernel_size, dtype=X.dtype,
                              device=X.device)
    halo = halos_required(hp.depth, hp.kernel_size)
    leaves = []
    for layer in params:
        for k in ("w", "b"):
            layer[k] = layer[k].detach().clone().requires_grad_(True)
            leaves.append(layer[k])

    xn = x_scaler.normalize(X)
    yn = y_scaler.normalize(Y)
    tx = OptimizerConfig("adam", {"learning_rate": hp.learning_rate}).instance
    with torch.enable_grad():
        for _ in range(hp.epochs):
            for i in range(xn.shape[0]):
                loss = torch.mean((conv_apply(params, xn[i], halo) - yn[i])
                                  ** 2)
                tx.step(leaves, torch.autograd.grad(loss, leaves))

    return ConvolutionalModel(
        hp.input_variables,
        hp.output_variables,
        [{k: v.detach() for k, v in layer.items()} for layer in params],
        x_info,
        y_info,
        x_scaler,
        y_scaler,
        hp.kernel_size,
        output_z_names=out_z_names,
        output_limits=_limits(hp.output_limit_config),
    )
