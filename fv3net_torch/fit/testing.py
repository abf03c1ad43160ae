"""Test predictors (port of ``fv3net_tpu/fit/testing.py``; reference:
external/fv3fit/fv3fit/testing.py:36,135): ``constant-output``."""
from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import io
from fv3net_torch.fit.predictor import Predictor


@io.register("constant-output")
class ConstantOutputPredictor(Predictor):
    """Returns configured constant values, broadcast to the sample count
    on the inputs' device (in ``dtype`` once ``to`` set one), to drive
    the online ML path without a trained model."""

    def __init__(
        self,
        input_variables: Sequence[str],
        output_variables: Sequence[str],
        outputs: Dict[str, np.ndarray] = None,
    ):
        super().__init__(input_variables, output_variables)
        self.outputs = {
            k: np.asarray(v) for k, v in (outputs or {}).items()
        }
        self.dtype = None

    def set_outputs(self, **outputs):
        self.outputs.update({k: np.asarray(v) for k, v in outputs.items()})

    def to(self, device=None, dtype=None):
        if dtype is not None:
            self.dtype = dtype
        return self

    def predict(self, X: Dataset) -> Dataset:
        first = torch.as_tensor(next(iter(X.values())).data)
        n_samples = first.shape[0]
        out = {}
        for name in self.output_variables:
            value = torch.as_tensor(self.outputs.get(name, np.zeros(1)),
                                    dtype=self.dtype, device=first.device)
            arr = torch.broadcast_to(value, (n_samples,) + tuple(value.shape))
            dims = ("sample",) + tuple(
                "z" if i == 0 else f"dim_{i}" for i in range(value.ndim)
            )
            out[name] = Quantity(arr, dims[: arr.ndim])
        return Dataset(out)

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "outputs.npz"), **self.outputs)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {
                    "input_variables": list(self.input_variables),
                    "output_variables": list(self.output_variables),
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "ConstantOutputPredictor":
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        outputs = {}
        npz_path = os.path.join(path, "outputs.npz")
        if os.path.exists(npz_path):
            z = np.load(npz_path)
            outputs = {k: z[k] for k in z.files}
        return cls(meta["input_variables"], meta["output_variables"], outputs)
