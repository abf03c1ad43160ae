"""Latent-space transformers and the generic dataset predictor (port of
``fv3net_tpu/fit/transformers.py``; reference:
external/fv3fit/fv3fit/reservoir/transformers/{transformer.py:291-330
DoNothingAutoencoder, sk_transformer.py:18-120 SkTransformer} and
_shared/xr_prediction.py:139-210 DatasetPredictor).

:meth:`PCATransformer.fit` runs on the host in numpy, as the
reference's does (``np.linalg.svd`` of the standardized data), so that
the components and their signs are the reference's whatever the device;
its arrays keep numpy's dtype (float32 data gives float32 components).
``encode`` and ``decode`` are products on the device of the tensors,
promoted as the reference promotes them: a float32 field encoded with
float64 components gives a float64 latent.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import io, packer
from fv3net_torch.fit.predictor import Predictor

__all__ = ["DoNothingAutoencoder", "PCATransformer", "DatasetPredictor"]


def promoted(*xs: torch.Tensor) -> List[torch.Tensor]:
    """``xs`` in the widest of their dtypes (numpy's promotion, which the
    reference's products follow and ``torch.matmul`` does not)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _split(X: torch.Tensor, sizes: Sequence[int]) -> List[torch.Tensor]:
    return list(torch.split(X, list(sizes), dim=-1))


@io.register("do-nothing-transformer")
class DoNothingAutoencoder:
    """Identity transformer: encode concatenates per-variable feature
    arrays, decode splits them back (reference transformer.py:291-330)."""

    def __init__(self, original_feature_sizes: Sequence[int]):
        self.original_feature_sizes = list(original_feature_sizes)

    @property
    def n_latent_dims(self) -> int:
        return int(sum(self.original_feature_sizes))

    def to(self, device=None, dtype=None):
        return self

    def encode(self, x: Sequence[torch.Tensor]) -> torch.Tensor:
        self.original_feature_sizes = [arr.shape[-1] for arr in x]
        return torch.cat(promoted(*x), dim=-1)

    def decode(self, latent: torch.Tensor) -> List[torch.Tensor]:
        if not self.original_feature_sizes:
            raise ValueError("Must encode data before decoding.")
        return _split(latent, self.original_feature_sizes)

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {"original_feature_sizes": self.original_feature_sizes}, f
            )

    @classmethod
    def load(cls, path: str) -> "DoNothingAutoencoder":
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        return cls(meta["original_feature_sizes"])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@io.register("sk-transformer")
class PCATransformer:
    """Standard-scaled PCA encoder/decoder (the reference SkTransformer's
    PCA+StandardScaler stack, sk_transformer.py:18-120); ``predict``
    returns the encode/decode roundtrip."""

    def __init__(
        self,
        mean: torch.Tensor,
        std: torch.Tensor,
        components: torch.Tensor,  # [n_latent, n_features]
        enforce_positive_outputs: bool = False,
        original_feature_sizes: Optional[Sequence[int]] = None,
    ):
        self.mean = torch.as_tensor(mean)
        self.std = torch.as_tensor(std)
        self.components = torch.as_tensor(components)
        self.enforce_positive_outputs = enforce_positive_outputs
        self.original_feature_sizes = (
            list(original_feature_sizes) if original_feature_sizes else None
        )

    @classmethod
    def fit(
        cls,
        x: Sequence,
        n_components: int,
        enforce_positive_outputs: bool = False,
    ) -> "PCATransformer":
        """The transformer of the arrays ``x`` (tensors or numpy), fit on
        the host; its tensors land on the first array's device."""
        device = x[0].device if torch.is_tensor(x[0]) else None
        sizes = [arr.shape[-1] for arr in x]
        X = np.concatenate([_host(a) for a in x], axis=-1)
        X = X.reshape(-1, X.shape[-1])
        mean = X.mean(axis=0)
        std = np.maximum(X.std(axis=0), 1e-7)
        Xn = (X - mean) / std
        # principal axes from the thin SVD of the normalized data
        _, _, vt = np.linalg.svd(Xn, full_matrices=False)
        if n_components > vt.shape[0]:
            raise ValueError(
                f"n_components={n_components} exceeds the "
                f"{vt.shape[0]} components available from data of shape "
                f"{X.shape} (min(n_samples, n_features))"
            )

        def t(a):
            return torch.tensor(np.ascontiguousarray(a), device=device)

        return cls(
            t(mean), t(std), t(vt[:n_components]),
            enforce_positive_outputs=enforce_positive_outputs,
            original_feature_sizes=sizes,
        )

    @property
    def n_latent_dims(self) -> int:
        return int(self.components.shape[0])

    def to(self, device=None, dtype=None):
        for name in ("mean", "std", "components"):
            setattr(self, name, getattr(self, name).to(device=device,
                                                       dtype=dtype))
        return self

    def encode(self, x: Sequence[torch.Tensor]) -> torch.Tensor:
        arrs = list(x)
        # the reference's quirk: encoding resets the split sizes
        self.original_feature_sizes = [a.shape[-1] for a in arrs]
        X, mean, std, comp = promoted(torch.cat(promoted(*arrs), dim=-1),
                                      self.mean, self.std, self.components)
        return ((X - mean) / std) @ comp.T

    def decode(self, latent: torch.Tensor) -> List[torch.Tensor]:
        latent, mean, std, comp = promoted(latent, self.mean, self.std,
                                           self.components)
        X = (latent @ comp) * std + mean
        if self.enforce_positive_outputs:
            X = torch.clamp(X, min=0.0)
        if not self.original_feature_sizes:
            raise ValueError("Must encode data before decoding.")
        return _split(X, self.original_feature_sizes)

    def predict(self, x: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self.decode(self.encode(x))

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(
            os.path.join(path, "weights.npz"),
            mean=_host(self.mean),
            std=_host(self.std),
            components=_host(self.components),
        )
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {
                    "enforce_positive_outputs": self.enforce_positive_outputs,
                    "original_feature_sizes": self.original_feature_sizes,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "PCATransformer":
        """The transformer in ``path``, on the CPU in the saved dtype."""
        z = np.load(os.path.join(path, "weights.npz"))
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        return cls(
            torch.tensor(z["mean"]),
            torch.tensor(z["std"]),
            torch.tensor(z["components"]),
            enforce_positive_outputs=meta["enforce_positive_outputs"],
            original_feature_sizes=meta["original_feature_sizes"],
        )


def pca_from_jax(transformer) -> PCATransformer:
    """The port's :class:`PCATransformer` of a reference-package one, its
    arrays read with ``np.asarray`` in their dtypes."""
    def t(a):
        return torch.tensor(np.asarray(a))

    return PCATransformer(
        t(transformer.mean), t(transformer.std), t(transformer.components),
        enforce_positive_outputs=transformer.enforce_positive_outputs,
        original_feature_sizes=transformer.original_feature_sizes)


@io.register("dataset-predictor")
class DatasetPredictor(Predictor):
    """Dataset-in/Dataset-out wrapper over any io-registered model with
    ``predict_arrays`` on packed [sample, feature] tensors (reference
    xr_prediction.py:139-210): stacking, an optional halo append for
    convolution-style models (``parallel/halo.py::halo_append``), nested
    dump/load through the io registry."""

    def __init__(
        self,
        input_variables: Sequence[str],
        output_variables: Sequence[str],
        model,
        n_halo: int = 0,
    ):
        super().__init__(list(input_variables), list(output_variables))
        self.model = model
        self.n_halo = n_halo

    def to(self, device=None, dtype=None):
        self.model = self.model.to(device=device, dtype=dtype)
        return self

    def predict(self, X: Dataset) -> Dataset:
        if self.n_halo > 0:
            from fv3net_torch.parallel.halo import halo_append

            X = Dataset(
                {
                    name: Quantity(
                        halo_append(torch.as_tensor(X[name].data),
                                    self.n_halo),
                        X[name].dims,
                        X[name].units,
                    )
                    for name in X
                },
                coords=dict(X.coords),
            )
        data = packer.dataset_to_samples(X, self.input_variables)
        out = self.model.predict_arrays(data)
        return packer.samples_to_dataset(out)

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        io.dump(self.model, os.path.join(path, "base_model"))
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {
                    "input_variables": self.input_variables,
                    "output_variables": self.output_variables,
                    "n_halo": self.n_halo,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "DatasetPredictor":
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        model = io.load(os.path.join(path, "base_model"))
        return cls(
            meta["input_variables"],
            meta["output_variables"],
            model,
            n_halo=meta["n_halo"],
        )
