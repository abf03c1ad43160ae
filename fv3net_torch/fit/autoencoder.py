"""The dense autoencoder and its trainer (port of
``fv3net_tpu/fit/autoencoder.py``; reference:
external/fv3fit/fv3fit/reservoir/transformers/autoencoder.py:48
Autoencoder "dense-autoencoder" and :250 train_dense_autoencoder).

The model compresses packed normalized state profiles to a latent vector
and reconstructs them.  The trainer draws the reference's minibatch
indices (``np.random.RandomState(seed)``, one permutation per epoch) and
steps with optax's adam; the initial weights are the port's He-normal
draws from a ``torch.Generator`` seeded with ``seed`` (the reference's
distribution, not its numbers).

``encode`` takes the reference's dict of [sample, feature] arrays, or a
sequence of [..., feature] arrays (upstream fv3fit's transformer
interface, which the subdomain reservoir calls with its cube fields: the
arrays are concatenated on their last axis).  ``decode`` returns the
variables as a dict, sliced on the last axis, any leading dimensions
kept.  The reference's ``encode`` takes the dict only, so its subdomain
reservoir cannot use this model as its latent space (ROADMAP.md Queue
3).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.fit import io, packer
from fv3net_torch.fit.config import OptimizerConfig
from fv3net_torch.fit.convolutional import _info, _info_dict
from fv3net_torch.fit.dense import (
    init_mlp_params,
    minibatch_indices,
    mlp_apply,
)
from fv3net_torch.fit.networks import _with_leaves
from fv3net_torch.fit.normalize import StandardScaler
from fv3net_torch.fit.predictor import Predictor
from fv3net_torch.fit.train import register_training_function
from fv3net_torch.fit.transformers import promoted


@dataclasses.dataclass
class DenseAutoencoderHyperparameters:
    """(reference: DenseAutoencoderHyperparameters at
    reservoir/transformers/autoencoder.py:95)"""

    state_variables: List[str] = dataclasses.field(default_factory=list)
    latent_dim_size: int = 10
    units: int = 64
    n_dense_layers: int = 2
    learning_rate: float = 1e-3
    epochs: int = 10
    batch_size: int = 512
    seed: int = 0


def _mlp(params, x):
    """The MLP in the wider of the input's and the weights' dtypes."""
    dt = torch.promote_types(x.dtype, params[0]["w"].dtype)
    if params[0]["w"].dtype != dt:
        params = [{k: v.to(dt) for k, v in p.items()} for p in params]
    return mlp_apply(params, x.to(dt))


@io.register("dense-autoencoder")
class Autoencoder(Predictor):
    """Encoder/decoder MLP pair over packed normalized state profiles."""

    def __init__(
        self,
        state_variables: Sequence[str],
        enc_params,
        dec_params,
        info: packer.PackingInfo,
        scaler: StandardScaler,
    ):
        super().__init__(list(state_variables), list(state_variables))
        self.enc_params = enc_params
        self.dec_params = dec_params
        self.info = info
        self.scaler = scaler

    @property
    def n_latent_dims(self) -> int:
        return int(self.enc_params[-1]["b"].shape[0])

    def to(self, device=None, dtype=None):
        """Move the weights and the scaler (in place); returns the
        model."""
        def mv(x):
            return x.to(device=device, dtype=dtype)

        self.enc_params = [{k: mv(v) for k, v in p.items()}
                           for p in self.enc_params]
        self.dec_params = [{k: mv(v) for k, v in p.items()}
                           for p in self.dec_params]
        self.scaler = StandardScaler(mv(self.scaler.mean),
                                     mv(self.scaler.std))
        return self

    # -- apply paths -----------------------------------------------------
    def encode_packed(self, X: torch.Tensor) -> torch.Tensor:
        return _mlp(self.enc_params, self.scaler.normalize(X))

    def decode_packed(self, latent: torch.Tensor) -> torch.Tensor:
        return self.scaler.denormalize(_mlp(self.dec_params, latent))

    def encode(self, data) -> torch.Tensor:
        """A dict of [sample(, feature)] arrays, packed by the state
        variables, or a sequence of [..., feature] arrays, concatenated,
        -> the latent [..., n_latent]."""
        if isinstance(data, Mapping):
            X, _ = packer.pack(data, self.input_variables)
        else:
            X = torch.cat(promoted(*data), dim=-1)
        return self.encode_packed(X)

    def decode(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        Y = self.decode_packed(latent)
        out = {}
        for name, sl in self.info.slices().items():
            arr = Y[..., sl]
            out[name] = arr[..., 0] if arr.shape[-1] == 1 else arr
        return out

    @torch.no_grad()
    def predict(self, X: Dataset) -> Dataset:
        """Roundtrip reconstruction (the Predictor surface)."""
        data = packer.dataset_to_samples(X, self.input_variables)
        return packer.samples_to_dataset(self.decode(self.encode(data)))

    # -- serialization: the reference's format ---------------------------
    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

        def n(x):
            return x.detach().cpu().numpy()

        flat = {}
        for tag, params in (("enc", self.enc_params),
                            ("dec", self.dec_params)):
            for i, layer in enumerate(params):
                flat[f"{tag}_w{i}"] = n(layer["w"])
                flat[f"{tag}_b{i}"] = n(layer["b"])
        flat["x_mean"] = n(self.scaler.mean)
        flat["x_std"] = n(self.scaler.std)
        np.savez(os.path.join(path, "weights.npz"), **flat)
        meta = {
            "state_variables": self.input_variables,
            "info": _info_dict(self.info),
            "n_enc": len(self.enc_params),
            "n_dec": len(self.dec_params),
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "Autoencoder":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "weights.npz"))

        def layers(tag, n):
            return [{"w": torch.tensor(z[f"{tag}_w{i}"]),
                     "b": torch.tensor(z[f"{tag}_b{i}"])}
                    for i in range(n)]

        return cls(
            state_variables=meta["state_variables"],
            enc_params=layers("enc", meta["n_enc"]),
            dec_params=layers("dec", meta["n_dec"]),
            info=_info(meta["info"]),
            scaler=StandardScaler(torch.tensor(z["x_mean"]),
                                  torch.tensor(z["x_std"])),
        )


def autoencoder_from_jax(model, dtype=None) -> Autoencoder:
    """The port's :class:`Autoencoder` of a reference-package one, its
    arrays read with ``np.asarray`` (in ``dtype`` if given)."""
    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype)

    def layers(params):
        return [{"w": t(p["w"]), "b": t(p["b"])} for p in params]

    return Autoencoder(
        model.input_variables, layers(model.enc_params),
        layers(model.dec_params),
        packer.PackingInfo(list(model.info.names),
                           [int(f) for f in model.info.features]),
        StandardScaler(t(model.scaler.mean), t(model.scaler.std)))


@register_training_function(
    "dense_autoencoder", DenseAutoencoderHyperparameters
)
def train_dense_autoencoder(
    hyperparameters: DenseAutoencoderHyperparameters,
    train_batches,
    validation_batches=None,
) -> Autoencoder:
    """Fit an :class:`Autoencoder` to the batches' state variables on the
    batches' device, in their dtype."""
    hp = hyperparameters
    xs = []
    info = None
    for ds in train_batches:
        data = packer.dataset_to_samples(ds, hp.state_variables)
        X, info = packer.pack(data, hp.state_variables)
        xs.append(X)
    X = torch.cat(xs)
    scaler = StandardScaler.fit(X)

    nf = info.total_features
    gen = torch.Generator().manual_seed(hp.seed)
    enc_sizes = [nf] + [hp.units] * hp.n_dense_layers + [hp.latent_dim_size]
    dec_sizes = [hp.latent_dim_size] + [hp.units] * hp.n_dense_layers + [nf]
    leaves: list = []
    params = _with_leaves({
        "enc": init_mlp_params(gen, enc_sizes, dtype=X.dtype,
                               device=X.device),
        "dec": init_mlp_params(gen, dec_sizes, dtype=X.dtype,
                               device=X.device),
    }, leaves)
    tx = OptimizerConfig("adam", {"learning_rate": hp.learning_rate}
                         ).instance
    xn = scaler.normalize(X)
    idx_all = torch.as_tensor(
        minibatch_indices(X.shape[0], hp.batch_size, hp.epochs, hp.seed),
        device=X.device)
    with torch.enable_grad():
        for idx in idx_all:
            xb = xn[idx]
            recon = mlp_apply(params["dec"], mlp_apply(params["enc"], xb))
            loss = torch.mean((recon - xb) ** 2)
            tx.step(leaves, torch.autograd.grad(loss, leaves))

    return Autoencoder(
        state_variables=list(hp.state_variables),
        enc_params=[{k: v.detach() for k, v in p.items()}
                    for p in params["enc"]],
        dec_params=[{k: v.detach() for k, v in p.items()}
                    for p in params["dec"]],
        info=info,
        scaler=scaler,
    )
