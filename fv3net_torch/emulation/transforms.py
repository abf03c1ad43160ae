"""Tensor transforms for emulator training (port of
``fv3net_tpu/emulation/transforms.py``; reference:
external/fv3fit/fv3fit/emulation/transforms/transforms.py): the
TensorTransform protocol (forward/backward over dict states),
LogTransform, LimitValueTransform, Difference and their composition, on
torch tensors."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

State = Dict[str, torch.Tensor]


class TensorTransform:
    """forward: physical -> training space; backward: inverse."""

    def forward(self, x: State) -> State:
        raise NotImplementedError

    def backward(self, y: State) -> State:
        raise NotImplementedError


@dataclasses.dataclass
class LogTransform(TensorTransform):
    """y = log(max(x, epsilon)) per field; an absent field passes (the
    targets at prediction time)."""

    field: str
    to: str = ""
    epsilon: float = 1e-30

    def __post_init__(self):
        self.to = self.to or f"log_{self.field}"

    def forward(self, x: State) -> State:
        out = dict(x)
        if self.field in x:
            out[self.to] = torch.log(torch.clamp(x[self.field],
                                                 min=self.epsilon))
        return out

    def backward(self, y: State) -> State:
        out = dict(y)
        if self.to in y:
            out[self.field] = torch.exp(y[self.to])
        return out


@dataclasses.dataclass
class LimitValueTransform(TensorTransform):
    """Clip a field on backward (zero-floor emulator outputs)."""

    field: str
    lower: float = 0.0
    upper: Optional[float] = None

    def forward(self, x: State) -> State:
        return dict(x)

    def backward(self, y: State) -> State:
        out = dict(y)
        if self.field in y:
            out[self.field] = torch.clamp(y[self.field], self.lower,
                                          self.upper)
        return out


@dataclasses.dataclass
class Difference(TensorTransform):
    """to = after - before; backward reconstructs after."""

    to: str
    before: str
    after: str

    def forward(self, x: State) -> State:
        out = dict(x)
        if self.before in x and self.after in x:
            out[self.to] = x[self.after] - x[self.before]
        return out

    def backward(self, y: State) -> State:
        out = dict(y)
        if self.to in y and self.before in y:
            out[self.after] = y[self.before] + y[self.to]
        return out


@dataclasses.dataclass
class ComposedTransform(TensorTransform):
    """Forward in order, backward in reverse."""

    transforms: List[TensorTransform]

    def forward(self, x: State) -> State:
        for t in self.transforms:
            x = t.forward(x)
        return x

    def backward(self, y: State) -> State:
        for t in reversed(self.transforms):
            y = t.backward(y)
        return y
