"""The autoregressive recurrent emulator, the FMR family (port of
``fv3net_tpu/fit/recurrent.py``; reference:
external/fv3fit/fv3fit/pytorch/recurrent/train_fmr.py:446, the ``fmr``
trainer, and pytorch/predict.py:136).

The step is a residual MLP on normalized packed state features,
``s_{t+1} = s_t + f(s_t)``.  The trainer takes one Adam step a window of
``train_window + 1`` times, the windows in order of their start,
``epochs`` times; each window's loss is the mean over its steps of the
rollout's squared error, back-propagated through the whole rollout.  The
initial weights are the port's draws from a ``torch.Generator`` seeded
with ``seed``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.fit import io, packer
from fv3net_torch.fit.config import OptimizerConfig
from fv3net_torch.fit.convolutional import _info, _info_dict
from fv3net_torch.fit.dense import init_mlp_params, mlp_apply
from fv3net_torch.fit.networks import _with_leaves
from fv3net_torch.fit.normalize import StandardScaler
from fv3net_torch.fit.predictor import Predictor
from fv3net_torch.fit.train import register_training_function


@dataclasses.dataclass
class RecurrentHyperparameters:
    state_variables: List[str] = dataclasses.field(default_factory=list)
    hidden_layers: int = 2
    width: int = 128
    train_window: int = 4  # rollout length for BPTT
    learning_rate: float = 1e-3
    epochs: int = 10
    seed: int = 0


@io.register("fmr")
class AutoregressiveModel(Predictor):
    """s_{t+1} = s_t + f(s_t) on normalized packed state features."""

    def __init__(self, state_variables, params, info, scaler):
        super().__init__(list(state_variables), list(state_variables))
        self.state_variables = list(state_variables)
        self.params = params
        self.info = info
        self.scaler = scaler

    def to(self, device=None, dtype=None):
        """Move the weights and the scaler (in place); returns the
        model."""
        def mv(x):
            return x.to(device=device, dtype=dtype)

        self.params = [{k: mv(v) for k, v in p.items()} for p in self.params]
        self.scaler = StandardScaler(mv(self.scaler.mean),
                                     mv(self.scaler.std))
        return self

    def step(self, params, s_norm):
        return s_norm + mlp_apply(params, s_norm)

    @torch.no_grad()
    def rollout(self, s0: torch.Tensor, n_steps: int) -> torch.Tensor:
        """[sample, features] initial state -> [n_steps, sample,
        features]."""
        s = self.scaler.normalize(s0)
        traj = []
        for _ in range(n_steps):
            s = self.step(self.params, s)
            traj.append(self.scaler.denormalize(s))
        return torch.stack(traj)

    @torch.no_grad()
    def predict(self, X: Dataset) -> Dataset:
        """One-step prediction of all state variables."""
        data = packer.dataset_to_samples(X, self.state_variables)
        S, _ = packer.pack(data, self.state_variables)
        out = self.scaler.denormalize(
            self.step(self.params, self.scaler.normalize(S)))
        return packer.samples_to_dataset(packer.unpack(out, self.info))

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

        def n(x):
            return x.detach().cpu().numpy()

        flat = {}
        for i, layer in enumerate(self.params):
            flat[f"w{i}"] = n(layer["w"])
            flat[f"b{i}"] = n(layer["b"])
        flat["mean"] = n(self.scaler.mean)
        flat["std"] = n(self.scaler.std)
        np.savez(os.path.join(path, "weights.npz"), **flat)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {
                    "state_variables": self.state_variables,
                    "info": _info_dict(self.info),
                    "n_layers": len(self.params),
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "AutoregressiveModel":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "weights.npz"))
        params = [{"w": torch.tensor(z[f"w{i}"]),
                   "b": torch.tensor(z[f"b{i}"])}
                  for i in range(meta["n_layers"])]
        return cls(
            meta["state_variables"],
            params,
            _info(meta["info"]),
            StandardScaler(torch.tensor(z["mean"]), torch.tensor(z["std"])),
        )


def autoregressive_from_jax(model, dtype=None) -> AutoregressiveModel:
    """The port's :class:`AutoregressiveModel` of a reference-package one,
    its arrays read with ``np.asarray`` (in ``dtype`` if given)."""
    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype)

    return AutoregressiveModel(
        model.state_variables,
        [{"w": t(p["w"]), "b": t(p["b"])} for p in model.params],
        packer.PackingInfo(list(model.info.names),
                           [int(f) for f in model.info.features]),
        StandardScaler(t(model.scaler.mean), t(model.scaler.std)))


@register_training_function("fmr", RecurrentHyperparameters)
def train_autoregressive_model(
    hp: RecurrentHyperparameters, train_batches, val=None
) -> AutoregressiveModel:
    """Train on batches of Datasets with [time, sample(, z)] variables,
    on their device, in their dtype; the batches' samples are joined.  A
    windowed loader's records (dims ("sample", "window", ...)) are read
    with the window as the time (the reference reads their sample axis
    as the time: ROADMAP.md Queue 3)."""
    series = []
    info = None
    for ds in train_batches:
        data = {}
        for v in hp.state_variables:
            arr = torch.as_tensor(ds[v].data)  # [time, sample(, z)]
            if tuple(ds[v].dims[:2]) == ("sample", "window"):
                arr = arr.transpose(0, 1)
            data[v] = (arr.reshape(arr.shape[0] * arr.shape[1], -1)
                       if arr.ndim == 3 else arr.reshape(-1))
        nt = arr.shape[0]
        packed, info = packer.pack(data, hp.state_variables)
        series.append(packed.reshape(nt, -1, info.total_features))
    S = torch.cat(series, dim=1)  # [time, sample, features]
    scaler = StandardScaler.fit(S.reshape(-1, S.shape[-1]))
    Sn = scaler.normalize(S)

    sizes = ([info.total_features] + [hp.width] * hp.hidden_layers
             + [info.total_features])
    leaves: list = []
    params = _with_leaves(init_mlp_params(
        torch.Generator().manual_seed(hp.seed), sizes, dtype=S.dtype,
        device=S.device), leaves)
    tx = OptimizerConfig("adam", {"learning_rate": hp.learning_rate}
                         ).instance
    W = min(hp.train_window, S.shape[0] - 1)
    with torch.enable_grad():
        for _ in range(hp.epochs):
            for start in range(Sn.shape[0] - W):
                window = Sn[start: start + W + 1]
                s = window[0]
                losses = []
                for target in window[1:]:
                    s = s + mlp_apply(params, s)
                    losses.append(torch.mean((s - target) ** 2))
                loss = torch.stack(losses).mean()
                tx.step(leaves, torch.autograd.grad(loss, leaves))
    return AutoregressiveModel(
        hp.state_variables,
        [{k: v.detach() for k, v in p.items()} for p in params],
        info, scaler)
