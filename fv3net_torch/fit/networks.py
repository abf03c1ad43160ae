"""The dense network builder (port of ``fv3net_tpu/fit/networks.py``'s
``DenseNetworkConfig`` and ``DenseNetwork``; reference:
external/fv3fit/fv3fit/keras/_models/shared/dense_network.py:21-80): a
list of {"w": [n_in, n_out], "b": [n_out]} layers applied by a ReLU
MLP.  The convolutional network, ``LossConfig`` and
``TrainingLoopConfig`` are not ported yet (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import torch

from fv3net_torch.fit.config import RegularizerConfig

__all__ = ["DenseNetworkConfig", "DenseNetwork"]


@dataclasses.dataclass
class DenseNetwork:
    """A built dense network: its layers and the config that applies
    them."""

    params: List[Mapping[str, torch.Tensor]]
    config: "DenseNetworkConfig"

    def __call__(self, x, generator: Optional[torch.Generator] = None):
        return self.config.apply(self.params, x, generator=generator)


@dataclasses.dataclass
class DenseNetworkConfig:
    """MLP builder: ``depth`` counts the hidden layers and the output
    layer; ``gaussian_noise`` is added to the hidden activations when a
    ``torch.Generator`` is passed (training mode)."""

    width: int = 8
    depth: int = 3
    kernel_regularizer: RegularizerConfig = dataclasses.field(
        default_factory=lambda: RegularizerConfig("none")
    )
    gaussian_noise: float = 0.0

    def build(self, generator: torch.Generator, n_features_in: int,
              n_features_out: int, dtype=torch.float32,
              device=None) -> DenseNetwork:
        """He-normal weights from ``generator`` (drawn in float64 on the
        CPU, cast last) and zero biases: the reference's distribution,
        not its numbers."""
        from fv3net_torch.fit.dense import init_mlp_params

        sizes = ([n_features_in] + [self.width] * (self.depth - 1)
                 + [n_features_out])
        params = init_mlp_params(generator, sizes, dtype=dtype,
                                 device=device)
        return DenseNetwork(params=params, config=self)

    def apply(self, params, x, generator: Optional[torch.Generator] = None):
        for layer in params[:-1]:
            x = torch.relu(x @ layer["w"] + layer["b"])
            if self.gaussian_noise > 0.0 and generator is not None:
                x = x + self.gaussian_noise * torch.randn(
                    x.shape, generator=generator, dtype=x.dtype,
                    device=x.device)
        last = params[-1]
        return x @ last["w"] + last["b"]

    def penalty(self, params) -> torch.Tensor:
        return self.kernel_regularizer.penalty(params)
