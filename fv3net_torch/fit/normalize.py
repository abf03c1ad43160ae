"""Per-feature standard normalization (port of
``fv3net_tpu/fit/normalize.py``)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class StandardScaler:
    mean: torch.Tensor  # [features]
    std: torch.Tensor  # [features]

    @classmethod
    def fit(cls, X: torch.Tensor, epsilon: float = 1e-7) -> "StandardScaler":
        mean = X.mean(dim=0)
        std = X.std(dim=0, unbiased=False)
        return cls(mean=mean, std=torch.clamp(std, min=epsilon))

    def normalize(self, X: torch.Tensor) -> torch.Tensor:
        return (X - self.mean) / self.std

    def denormalize(self, X: torch.Tensor) -> torch.Tensor:
        return X * self.std + self.mean
