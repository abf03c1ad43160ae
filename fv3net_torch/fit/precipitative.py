"""The precipitative model and its trainer (port of
``fv3net_tpu/fit/precipitative.py``; reference:
external/fv3fit/fv3fit/keras/_models/precipitative.py:162
``train_precipitative_model``): a dense ReLU trunk over the normalized
inputs (air_temperature, specific_humidity, the pressure thickness,
physics_precip and any extras) with three linear heads, a residual
heating profile, a residual moistening profile and a column
precipitation profile, coupled as the reference couples them:

- dQ2 = residual_moistening + column_precip
- dQ1 = residual_heating - (Lv/cp) * column_precip
- total_precipitation_rate = physics_precip
  - sum_z(column_precip * delp) / g

``couple_precip_to_dQ1_dQ2=False`` leaves the heads independent.  The
loss is each output's standard-scaled MSE, summed.  The trainer takes
the reference's minibatch indices and its adam rule, in a Python loop
with autograd where the reference scans; the initial weights are the
port's own draws from a ``torch.Generator`` (:func:`init_params`).  The
artifact (``weights.npz`` and ``metadata.json``) is the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core.constants import GRAVITY
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.fit import io, packer
from fv3net_torch.fit.config import OptimizerConfig, OutputLimitConfig
from fv3net_torch.fit.dense import init_mlp_params, minibatch_indices
from fv3net_torch.fit.normalize import StandardScaler
from fv3net_torch.fit.predictor import Predictor
from fv3net_torch.fit.train import register_training_function

LV = 2.5e6  # latent heat of vaporization, J/kg (precipitative.py:21)
CPD = 1004.6  # J/kg/K (precipitative.py:23)

DELP_NAME = "pressure_thickness_of_atmospheric_layer"
T_NAME = "air_temperature"
Q_NAME = "specific_humidity"
PRECIP_NAME = "total_precipitation_rate"
PHYS_PRECIP_NAME = "physics_precip"
T_TENDENCY_NAME = "dQ1"
Q_TENDENCY_NAME = "dQ2"
HEADS = ("head_T", "head_q", "head_precip")


@dataclasses.dataclass
class PrecipitativeHyperparameters:
    """The reference's hyperparameters (precipitative.py:69);
    ``output_limit_config`` ({name: {min, max}}) clamps the
    predictions."""

    additional_input_variables: List[str] = dataclasses.field(
        default_factory=list
    )
    hidden_layers: int = 3
    width: int = 16
    learning_rate: float = 1e-3
    epochs: int = 10
    batch_size: int = 512
    couple_precip_to_dQ1_dQ2: bool = True
    seed: int = 0
    output_limit_config: Optional[dict] = None

    @property
    def input_variables(self) -> Sequence[str]:
        return tuple(
            [T_NAME, Q_NAME, DELP_NAME, PHYS_PRECIP_NAME]
            + list(self.additional_input_variables)
        )

    @property
    def output_variables(self) -> Sequence[str]:
        return (T_TENDENCY_NAME, Q_TENDENCY_NAME, PRECIP_NAME)


def _trunk_apply(layers, x):
    for layer in layers:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x


def _head_apply(head, h):
    return h @ head["w"] + head["b"]


def _info_dict(info: packer.PackingInfo) -> dict:
    return {"names": list(info.names), "features": list(info.features)}


def _info(d: dict) -> packer.PackingInfo:
    return packer.PackingInfo(list(d["names"]),
                              [int(f) for f in d["features"]])


def _limits(d: Optional[dict]) -> Optional[OutputLimitConfig]:
    return OutputLimitConfig.from_dict(d) if d else None


@io.register("precipitative")
class PrecipitativeModel(Predictor):
    """The shared trunk and three heads, with the precipitation budget
    closed in the forward function."""

    def __init__(
        self,
        input_variables: Sequence[str],
        params,
        input_info: packer.PackingInfo,
        x_scaler: StandardScaler,
        scalers: Dict[str, StandardScaler],
        couple: bool,
        output_limits: Optional[OutputLimitConfig] = None,
    ):
        super().__init__(
            list(input_variables),
            [T_TENDENCY_NAME, Q_TENDENCY_NAME, PRECIP_NAME],
        )
        self.params = params
        self.input_info = input_info
        self.x_scaler = x_scaler
        self.scalers = scalers  # per-output denormalization
        self.couple = couple
        self.output_limits = output_limits

    def to(self, device=None, dtype=None):
        """Move the weights and scalers (in place); returns the model."""
        def mv(x):
            return x.to(device=device, dtype=dtype)

        self.params = {
            "trunk": [{k: mv(v) for k, v in layer.items()}
                      for layer in self.params["trunk"]],
            **{h: {k: mv(v) for k, v in self.params[h].items()}
               for h in HEADS},
        }
        self.x_scaler = StandardScaler(mv(self.x_scaler.mean),
                                       mv(self.x_scaler.std))
        self.scalers = {k: StandardScaler(mv(s.mean), mv(s.std))
                        for k, s in self.scalers.items()}
        return self

    def apply_packed(self, params, X: torch.Tensor) -> Dict[str,
                                                           torch.Tensor]:
        sl = self.input_info.slices()
        delp = X[..., sl[DELP_NAME]]
        phys_precip = X[..., sl[PHYS_PRECIP_NAME]][..., 0]
        h = _trunk_apply(params["trunk"], self.x_scaler.normalize(X))
        s_T = self.scalers[T_TENDENCY_NAME]
        s_q = self.scalers[Q_TENDENCY_NAME]
        resid_T = s_T.denormalize(_head_apply(params["head_T"], h))
        resid_q = s_q.denormalize(_head_apply(params["head_q"], h))
        # the column-precipitation head denormalizes with dQ2's
        # statistics, as in the reference (precipitative.py:232-239)
        col_precip = s_q.denormalize(_head_apply(params["head_precip"], h))
        if self.couple:
            dQ1 = resid_T - (LV / CPD) * col_precip
            dQ2 = resid_q + col_precip
        else:
            dQ1, dQ2 = resid_T, resid_q
        surface_precip = phys_precip - (
            (col_precip * delp).sum(dim=-1) / GRAVITY
        )
        out = {
            T_TENDENCY_NAME: dQ1,
            Q_TENDENCY_NAME: dQ2,
            PRECIP_NAME: surface_precip[..., None],
        }
        if self.output_limits:
            out = self.output_limits.apply_limits(out)
        return out

    @torch.no_grad()
    def predict_arrays(
        self, data: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        X, _ = packer.pack(data, self.input_variables)
        out = self.apply_packed(self.params, X)
        out[PRECIP_NAME] = out[PRECIP_NAME][..., 0]
        return out

    def predict(self, X: Dataset) -> Dataset:
        data = packer.dataset_to_samples(X, self.input_variables)
        return packer.samples_to_dataset(self.predict_arrays(data))

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

        def n(x):
            return x.detach().cpu().numpy()

        flat = {}
        for i, layer in enumerate(self.params["trunk"]):
            flat[f"trunk_w{i}"] = n(layer["w"])
            flat[f"trunk_b{i}"] = n(layer["b"])
        for head in HEADS:
            flat[f"{head}_w"] = n(self.params[head]["w"])
            flat[f"{head}_b"] = n(self.params[head]["b"])
        flat["x_mean"] = n(self.x_scaler.mean)
        flat["x_std"] = n(self.x_scaler.std)
        for name, s in self.scalers.items():
            flat[f"scaler_{name}_mean"] = n(s.mean)
            flat[f"scaler_{name}_std"] = n(s.std)
        np.savez(os.path.join(path, "weights.npz"), **flat)
        meta = {
            "input_variables": self.input_variables,
            "input_info": _info_dict(self.input_info),
            "n_trunk": len(self.params["trunk"]),
            "scaler_names": list(self.scalers),
            "couple": self.couple,
            "output_limits": (
                self.output_limits.to_dict() if self.output_limits else None
            ),
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "PrecipitativeModel":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "weights.npz"))

        def t(key):
            return torch.tensor(z[key])

        params = {"trunk": [{"w": t(f"trunk_w{i}"), "b": t(f"trunk_b{i}")}
                            for i in range(meta["n_trunk"])]}
        for head in HEADS:
            params[head] = {"w": t(f"{head}_w"), "b": t(f"{head}_b")}
        scalers = {
            name: StandardScaler(t(f"scaler_{name}_mean"),
                                 t(f"scaler_{name}_std"))
            for name in meta["scaler_names"]
        }
        return cls(
            input_variables=meta["input_variables"],
            params=params,
            input_info=_info(meta["input_info"]),
            x_scaler=StandardScaler(t("x_mean"), t("x_std")),
            scalers=scalers,
            couple=meta["couple"],
            output_limits=_limits(meta.get("output_limits")),
        )


def init_params(generator: torch.Generator, trunk_sizes: Sequence[int],
                n_T: int, n_q: int, dtype=torch.float32, device=None):
    """The trunk's He-normal layers and the three heads' weights
    N(0, 1/width) with zero biases, drawn in float64 on the CPU from
    ``generator`` and cast last: the reference's distributions, not its
    numbers."""
    width = trunk_sizes[-1]

    def head(n_out):
        w = torch.randn((width, n_out), generator=generator,
                        dtype=torch.float64) * math.sqrt(1.0 / width)
        return {"w": w.to(dtype=dtype, device=device),
                "b": torch.zeros(n_out, dtype=dtype, device=device)}

    return {
        "trunk": init_mlp_params(generator, trunk_sizes, dtype=dtype,
                                 device=device),
        "head_T": head(n_T),
        "head_q": head(n_q),
        "head_precip": head(n_q),
    }


@register_training_function("precipitative", PrecipitativeHyperparameters)
def train_precipitative_model(
    hyperparameters: PrecipitativeHyperparameters,
    train_batches,
    validation_batches=None,
) -> PrecipitativeModel:
    """Fit a :class:`PrecipitativeModel` to ``train_batches`` on the
    batches' device, in their dtype."""
    hp = hyperparameters
    inputs = list(hp.input_variables)
    outputs = list(hp.output_variables)
    xs, ys = [], []
    x_info = None
    for ds in train_batches:
        data = packer.dataset_to_samples(ds, inputs + outputs)
        X, x_info = packer.pack(data, inputs)
        xs.append(X)
        ys.append({k: data[k] for k in outputs})
    X = torch.cat(xs)
    Y = {k: torch.cat([b[k] for b in ys]).reshape(X.shape[0], -1)
         for k in outputs}
    x_scaler = StandardScaler.fit(X)
    scalers = {k: StandardScaler.fit(v) for k, v in Y.items()}

    trunk_sizes = [x_info.total_features] + [hp.width] * hp.hidden_layers
    params = init_params(torch.Generator().manual_seed(hp.seed),
                         trunk_sizes, Y[T_TENDENCY_NAME].shape[-1],
                         Y[Q_TENDENCY_NAME].shape[-1], dtype=X.dtype,
                         device=X.device)
    leaves = []
    for layer in params["trunk"] + [params[h] for h in HEADS]:
        for k in ("w", "b"):
            layer[k] = layer[k].detach().clone().requires_grad_(True)
            leaves.append(layer[k])

    model = PrecipitativeModel(
        input_variables=inputs,
        params=params,
        input_info=x_info,
        x_scaler=x_scaler,
        scalers=scalers,
        couple=hp.couple_precip_to_dQ1_dQ2,
        output_limits=_limits(hp.output_limit_config),
    )

    def loss_fn(xb, yb):
        out = model.apply_packed(params, xb)
        total = 0.0
        for k in outputs:
            pred = out[k].reshape(yb[k].shape)
            # each output's standard-scaled MSE (LossConfig scaling)
            total = total + torch.mean(((pred - yb[k]) / scalers[k].std) ** 2)
        return total

    tx = OptimizerConfig("adam", {"learning_rate": hp.learning_rate}).instance
    idx_all = torch.as_tensor(
        minibatch_indices(X.shape[0], hp.batch_size, hp.epochs, hp.seed),
        device=X.device)
    with torch.enable_grad():
        for idx in idx_all:
            loss = loss_fn(X[idx], {k: v[idx] for k, v in Y.items()})
            tx.step(leaves, torch.autograd.grad(loss, leaves))

    model.params = {
        "trunk": [{k: v.detach() for k, v in layer.items()}
                  for layer in params["trunk"]],
        **{h: {k: v.detach() for k, v in params[h].items()} for h in HEADS},
    }
    return model
