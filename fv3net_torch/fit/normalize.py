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
        """Each feature's mean and population std (floored at
        ``epsilon``), as the reference's ``jnp.std``: the root mean square
        of ``X - mean``.  The mean is refined by the mean of ``X - mean``,
        so that it is the correctly rounded mean on any device: a feature
        that barely varies (the top layers' pressure thickness, 389 Pa
        +- 1.2e-4 at C48) turns a last-bit difference of its mean into a
        5e-10 difference of its normalized values, and a float64 epoch on
        the card then parted from the CPU's by 2e-10."""
        mean = X.mean(dim=0)
        mean = mean + (X - mean).mean(dim=0)
        std = torch.sqrt(((X - mean) ** 2).mean(dim=0))
        return cls(mean=mean, std=torch.clamp(std, min=epsilon))

    def normalize(self, X: torch.Tensor) -> torch.Tensor:
        return (X - self.mean) / self.std

    def denormalize(self, X: torch.Tensor) -> torch.Tensor:
        return X * self.std + self.mean
