"""Composable predictor wrappers (port of ``fv3net_tpu/fit/models.py``;
reference: external/fv3fit/fv3fit/_shared/models.py:19-485): the
registered ``combined_output_model``, ``ensemble``, ``tapered_model``,
``derived_model``, ``output_transformed_model`` and
``squashed_output_model``.  Nested models are dumped into subdirectories
of the artifact in the reference's layout, so either package loads what
the other dumped; ``.to(device, dtype)`` moves the wrapped models.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Sequence

import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import io
from fv3net_torch.fit.predictor import Predictor


def _dump_models(models, path):
    names = []
    for i, model in enumerate(models):
        io.dump(model, os.path.join(path, f"model_{i}"))
        names.append(f"model_{i}")
    return names


def _load_models(path, names):
    return [io.load(os.path.join(path, n)) for n in names]


def _metadata(path) -> dict:
    with open(os.path.join(path, "metadata.json")) as f:
        return json.load(f)


def _write_metadata(path, meta: dict) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f)


class _Wrapper(Predictor):
    """A predictor over others: ``to`` moves each of them."""

    def _children(self) -> List:
        return [self.model]

    def to(self, device=None, dtype=None):
        for m in self._children():
            m.to(device=device, dtype=dtype)
        return self


@io.register("combined_output_model")
class CombinedOutputModel(_Wrapper):
    """The outputs of models with disjoint output sets, together
    (reference models.py:19-62)."""

    def __init__(self, models: Sequence[Predictor]):
        inputs: List[str] = []
        outputs: List[str] = []
        for m in models:
            for v in m.input_variables:
                if v not in inputs:
                    inputs.append(v)
            for v in m.output_variables:
                if v in outputs:
                    raise ValueError(f"duplicate output variable {v}")
                outputs.append(v)
        super().__init__(inputs, outputs)
        self.models = list(models)

    def _children(self):
        return self.models

    def predict(self, X: Dataset) -> Dataset:
        out: Dict[str, Quantity] = {}
        for m in self.models:
            pred = m.predict(X)
            out.update({k: pred[k] for k in pred})
        return Dataset(out)

    def dump(self, path):
        os.makedirs(path, exist_ok=True)
        _write_metadata(path, {"models": _dump_models(self.models, path)})

    @classmethod
    def load(cls, path):
        return cls(_load_models(path, _metadata(path)["models"]))


def median(stack: torch.Tensor) -> torch.Tensor:
    """The median over the leading axis as ``jnp.median`` takes it: the
    two middle values' midpoint for an even count (``torch.median``
    returns the lower one)."""
    s = torch.sort(stack, dim=0).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


@io.register("ensemble")
class EnsembleModel(_Wrapper):
    """Mean or median of the members' predictions (reference
    models.py:223-276)."""

    def __init__(self, models: Sequence[Predictor], reduction: str = "mean"):
        if reduction not in ("mean", "median"):
            raise ValueError(f"reduction must be mean|median, got {reduction}")
        first = models[0]
        super().__init__(
            list(first.input_variables), list(first.output_variables)
        )
        self.models = list(models)
        self.reduction = reduction

    def _children(self):
        return self.models

    def predict(self, X: Dataset) -> Dataset:
        preds = [m.predict(X) for m in self.models]
        out = {}
        for var in self.output_variables:
            stack = torch.stack([torch.as_tensor(p[var].data) for p in preds])
            red = (torch.mean(stack, 0) if self.reduction == "mean"
                   else median(stack))
            out[var] = Quantity(red, preds[0][var].dims, preds[0][var].units)
        return Dataset(out)

    def dump(self, path):
        os.makedirs(path, exist_ok=True)
        _write_metadata(path, {"models": _dump_models(self.models, path),
                               "reduction": self.reduction})

    @classmethod
    def load(cls, path):
        meta = _metadata(path)
        return cls(_load_models(path, meta["models"]), meta["reduction"])


@io.register("tapered_model")
class TaperedModel(_Wrapper):
    """The listed outputs tapered exponentially in the upper levels
    (reference models.py:65-107 and its TaperConfig)."""

    def __init__(self, model: Predictor, tapering: Mapping[str, dict]):
        super().__init__(
            list(model.input_variables), list(model.output_variables)
        )
        self.model = model
        self.tapering = {k: dict(v) for k, v in tapering.items()}

    def predict(self, X: Dataset) -> Dataset:
        from fv3net_torch.data_transform import (
            vertical_tapering_scale_factors,
        )

        pred = self.model.predict(X)
        out = {k: pred[k] for k in pred}
        for var, cfg in self.tapering.items():
            q = out[var]
            data = torch.as_tensor(q.data)
            scale = vertical_tapering_scale_factors(
                q.shape[-1], cutoff=cfg["cutoff"], rate=cfg["rate"]
            )
            out[var] = Quantity(
                data * torch.as_tensor(scale, dtype=data.dtype,
                                       device=data.device),
                q.dims, q.units)
        return Dataset(out)

    def dump(self, path):
        os.makedirs(path, exist_ok=True)
        io.dump(self.model, os.path.join(path, "base_model"))
        _write_metadata(path, {"tapering": self.tapering})

    @classmethod
    def load(cls, path):
        return cls(io.load(os.path.join(path, "base_model")),
                   _metadata(path)["tapering"])


@io.register("derived_model")
class DerivedModel(_Wrapper):
    """A base model's predictions plus outputs the DerivedMapping computes
    from them and the inputs (reference models.py:110-220)."""

    def __init__(self, model: Predictor,
                 derived_output_variables: Sequence[str]):
        from fv3net_torch.derived import DerivedMapping

        unknown = [v for v in derived_output_variables
                   if v not in DerivedMapping.VARIABLES]
        if unknown:
            raise ValueError(f"unknown derived variables: {unknown}")
        extra_inputs = DerivedMapping.find_all_required_inputs(
            derived_output_variables
        )
        inputs = list(model.input_variables) + [
            v for v in extra_inputs if v not in model.input_variables
        ]
        outputs = list(model.output_variables) + list(derived_output_variables)
        super().__init__(inputs, outputs)
        self.base_model = model
        self.derived_output_variables = list(derived_output_variables)

    def _children(self):
        return [self.base_model]

    def predict(self, X: Dataset) -> Dataset:
        from fv3net_torch.derived import DerivedMapping

        pred = self.base_model.predict(X)
        combined = {k: X[k] for k in X}
        combined.update({k: pred[k] for k in pred})
        mapping = DerivedMapping(combined)
        out = {k: pred[k] for k in pred}
        for var in self.derived_output_variables:
            out[var] = mapping[var]
        return Dataset(out)

    def dump(self, path):
        os.makedirs(path, exist_ok=True)
        io.dump(self.base_model, os.path.join(path, "base_model"))
        _write_metadata(path, {
            "derived_output_variables": self.derived_output_variables})

    @classmethod
    def load(cls, path):
        return cls(io.load(os.path.join(path, "base_model")),
                   _metadata(path)["derived_output_variables"])


@io.register("output_transformed_model")
class TransformedPredictor(_Wrapper):
    """A base model's predictions through registered data transforms
    (reference models.py:279-337)."""

    def __init__(self, model: Predictor, transforms: Sequence[dict]):
        from fv3net_torch.data_transform import (
            ChainedDataTransform,
            DataTransform,
        )

        self._transform = ChainedDataTransform(
            [DataTransform(**t) for t in transforms]
        )
        self._transforms_config = [dict(t) for t in transforms]
        inputs = list(model.input_variables)
        for v in self._transform.input_variables:
            if v not in inputs and v not in model.output_variables:
                inputs.append(v)
        outputs = list(model.output_variables) + list(
            self._transform.output_variables
        )
        super().__init__(inputs, outputs)
        self.base_model = model

    def _children(self):
        return [self.base_model]

    def predict(self, X: Dataset) -> Dataset:
        pred = self.base_model.predict(X)
        merged = Dataset({k: X[k] for k in X})
        for k in pred:
            merged[k] = pred[k]
        transformed = self._transform.apply(merged)
        return Dataset({v: transformed[v] for v in self.output_variables})

    def dump(self, path):
        os.makedirs(path, exist_ok=True)
        io.dump(self.base_model, os.path.join(path, "base_model"))
        _write_metadata(path, {"transforms": self._transforms_config})

    @classmethod
    def load(cls, path):
        return cls(io.load(os.path.join(path, "base_model")),
                   _metadata(path)["transforms"])


@io.register("squashed_output_model")
class SquashedOutputModel(_Wrapper):
    """Outputs set to zero where ``squash_by`` falls below
    ``squash_threshold`` (reference models.py:442-485)."""

    def __init__(
        self,
        model: Predictor,
        squash_by: str,
        squash_threshold: float,
        additional_squash_target_variables: Sequence[str] = (),
    ):
        super().__init__(
            list(model.input_variables), list(model.output_variables)
        )
        if squash_by not in model.output_variables:
            raise ValueError(
                f"squash_by variable {squash_by!r} not in model outputs"
            )
        self.model = model
        self.squash_by = squash_by
        self.squash_threshold = squash_threshold
        self.additional = list(additional_squash_target_variables)

    def predict(self, X: Dataset) -> Dataset:
        pred = self.model.predict(X)
        mask = torch.as_tensor(pred[self.squash_by].data) >= \
            self.squash_threshold
        out = {}
        targets = {self.squash_by, *self.additional}
        for var in pred:
            q = pred[var]
            if var in targets:
                data = torch.as_tensor(q.data)
                out[var] = Quantity(
                    torch.where(mask, data, torch.zeros_like(data)),
                    q.dims, q.units)
            else:
                out[var] = q
        return Dataset(out)

    def dump(self, path):
        os.makedirs(path, exist_ok=True)
        io.dump(self.model, os.path.join(path, "base_model"))
        _write_metadata(path, {
            "squash_by": self.squash_by,
            "squash_threshold": self.squash_threshold,
            "additional_squash_target_variables": self.additional,
        })

    @classmethod
    def load(cls, path):
        meta = _metadata(path)
        return cls(
            io.load(os.path.join(path, "base_model")),
            meta["squash_by"],
            meta["squash_threshold"],
            meta["additional_squash_target_variables"],
        )
