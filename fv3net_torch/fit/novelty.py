"""Novelty detection and out-of-sample tapering (port of
``fv3net_tpu/fit/novelty.py``; reference:
external/fv3fit/fv3fit/_shared/novelty_detector.py:21-60,
sklearn/_min_max_novelty_detector.py:35-160, _shared/taper_function.py
and _shared/models.py:340-440 OutOfSampleModel).

The min-max detector, the constant-score stub, the taper functions and
``OutOfSampleModel`` are ported.  The one-class SVM detector trains with
scikit-learn and saves its pickle; the port has no scikit-learn on the
card, so ``ocsvm`` and ``ocsvm_novelty_detector`` raise the port's
not-ported error (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import io, packer
from fv3net_torch.fit.convolutional import _info, _info_dict
from fv3net_torch.fit.predictor import Predictor
from fv3net_torch.fit.train import register_training_function

NOVELTY_OUTPUT_VAR = "is_novelty"
SCORE_OUTPUT_VAR = "novelty_score"
CENTERED_SCORE_OUTPUT_VAR = "centered_score"
TAPER_VALUES_OUTPUT_VAR = "taper_values"


# ---------------------------------------------------------------------------
# taper functions (reference _shared/taper_function.py)
# ---------------------------------------------------------------------------
def taper_mask(score, cutoff: float = 0.0, **_):
    """0 where score > cutoff, else 1."""
    return torch.where(score > cutoff, 0.0, 1.0).to(score.dtype)


def taper_ramp(score, ramp_min: float = 0.0, ramp_max: float = 1.0, **_):
    """Linear 1 -> 0 ramp between ramp_min and ramp_max."""
    return torch.clamp((ramp_max - score) / (ramp_max - ramp_min), 0.0, 1.0)


def taper_decay(score, threshold: float = 0.0, rate: float = 1.0, **_):
    """Exponential suppression beyond the threshold."""
    return torch.where(score > threshold,
                       torch.exp(-(score - threshold) / rate),
                       torch.ones_like(score))


_TAPERS = {"taper_mask": taper_mask, "taper_ramp": taper_ramp,
           "taper_decay": taper_decay}


def get_taper_function(name: str, config: Dict) -> Callable:
    fn = _TAPERS[name]
    return lambda score: fn(score, **config)


# ---------------------------------------------------------------------------
# detectors
# ---------------------------------------------------------------------------
class NoveltyDetector(Predictor):
    """Scores samples by distance from the training distribution; outputs
    is_novelty / novelty_score / centered_score (reference
    novelty_detector.py:21-60)."""

    def __init__(self, input_variables: Sequence[str]):
        super().__init__(
            list(input_variables),
            [NOVELTY_OUTPUT_VAR, SCORE_OUTPUT_VAR, CENTERED_SCORE_OUTPUT_VAR],
        )

    def to(self, device=None, dtype=None):
        return self

    def _score(self, X: Dataset) -> torch.Tensor:
        raise NotImplementedError

    def predict_novelties(self, X: Dataset, cutoff: float = 0.0):
        centered = self._score(X)
        diags = Dataset(
            {
                SCORE_OUTPUT_VAR: Quantity(centered, ("sample",)),
                CENTERED_SCORE_OUTPUT_VAR: Quantity(centered, ("sample",)),
                NOVELTY_OUTPUT_VAR: Quantity(
                    (centered > cutoff).to(torch.float32), ("sample",)
                ),
            }
        )
        return centered, diags

    def predict(self, X: Dataset) -> Dataset:
        _, diags = self.predict_novelties(X)
        return diags


@io.register("minmax")
class MinMaxNoveltyDetector(NoveltyDetector):
    """Per-feature min/max bounds: centered score = largest normalized
    bound violation over features; <= 0 in-sample
    (reference _min_max_novelty_detector.py:48-160)."""

    def __init__(self, input_variables, minima=None, maxima=None, info=None):
        super().__init__(input_variables)
        self.minima = minima
        self.maxima = maxima
        self.info = info

    def to(self, device=None, dtype=None):
        self.minima = self.minima.to(device=device, dtype=dtype)
        self.maxima = self.maxima.to(device=device, dtype=dtype)
        return self

    def _packed(self, X: Dataset) -> torch.Tensor:
        data = packer.dataset_to_samples(X, self.input_variables)
        return packer.pack(data, self.input_variables)[0]

    def fit(self, batch: Dataset) -> "MinMaxNoveltyDetector":
        data = packer.dataset_to_samples(batch, self.input_variables)
        X, self.info = packer.pack(data, self.input_variables)
        self.minima = X.min(dim=0).values
        self.maxima = X.max(dim=0).values
        return self

    def _score(self, Xd: Dataset) -> torch.Tensor:
        X = self._packed(Xd).to(self.minima.device)
        scale = torch.clamp(self.maxima - self.minima, min=1e-12)
        above = (X - self.maxima) / scale
        below = (self.minima - X) / scale
        return torch.maximum(above, below).max(dim=1).values

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(
            os.path.join(path, "bounds.npz"),
            minima=self.minima.detach().cpu().numpy(),
            maxima=self.maxima.detach().cpu().numpy(),
        )
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump({"input_variables": self.input_variables,
                       "info": _info_dict(self.info)}, f)

    @classmethod
    def load(cls, path: str) -> "MinMaxNoveltyDetector":
        """The detector in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "bounds.npz"))
        return cls(
            meta["input_variables"],
            minima=torch.tensor(z["minima"]),
            maxima=torch.tensor(z["maxima"]),
            info=_info(meta["info"]),
        )


def minmax_from_jax(detector, dtype=None) -> MinMaxNoveltyDetector:
    """The port's :class:`MinMaxNoveltyDetector` of a reference-package
    one, its bounds read with ``np.asarray`` (in ``dtype`` if given)."""
    return MinMaxNoveltyDetector(
        detector.input_variables,
        minima=torch.tensor(np.asarray(detector.minima), dtype=dtype),
        maxima=torch.tensor(np.asarray(detector.maxima), dtype=dtype),
        info=packer.PackingInfo(list(detector.info.names),
                                [int(f) for f in detector.info.features]))


def _ocsvm_not_ported():
    from fv3net_torch.runtime.factories import not_ported

    return not_ported("the one-class SVM novelty detector (ocsvm, "
                      "sklearn.svm.OneClassSVM)", 9)


class OCSVMNoveltyDetector:
    """The one-class SVM detector (reference _ocsvm_novelty_detector.py:46):
    not ported, it raises."""

    def __init__(self, *args, **kwargs):
        raise _ocsvm_not_ported()

    @classmethod
    def load(cls, path: str):
        raise _ocsvm_not_ported()


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MinMaxNoveltyDetectorHyperparameters:
    input_variables: List[str] = dataclasses.field(default_factory=list)


@register_training_function(
    "min_max_novelty_detector", MinMaxNoveltyDetectorHyperparameters
)
def train_min_max_novelty_detector(hyperparameters, train_batches, val=None):
    """The bounds of every batch's packed inputs, on their device."""
    det = MinMaxNoveltyDetector(hyperparameters.input_variables)
    for batch in train_batches:
        if det.minima is None:
            det.fit(batch)
        else:
            X = det._packed(batch)
            det.minima = torch.minimum(det.minima, X.min(dim=0).values)
            det.maxima = torch.maximum(det.maxima, X.max(dim=0).values)
    return det


def train_ocsvm_novelty_detector(hyperparameters, train_batches, val=None):
    raise _ocsvm_not_ported()


# ---------------------------------------------------------------------------
# out-of-sample wrapper (reference models.py:340-440)
# ---------------------------------------------------------------------------
@io.register("out_of_sample")
class OutOfSampleModel(Predictor):
    """Taper base-model outputs by novelty score."""

    def __init__(
        self,
        base_model: Predictor,
        novelty_detector: NoveltyDetector,
        cutoff: float = 0.0,
        taper: Optional[Callable] = None,
        taper_config: Optional[Dict] = None,
    ):
        inputs = sorted(
            set(base_model.input_variables)
            | set(novelty_detector.input_variables)
        )
        outputs = sorted(
            set(base_model.output_variables)
            | set(novelty_detector.output_variables)
            | {TAPER_VALUES_OUTPUT_VAR}
        )
        super().__init__(inputs, outputs)
        self.base_model = base_model
        self.novelty_detector = novelty_detector
        self.cutoff = cutoff
        self._taper_config = taper_config or {"name": "taper_mask",
                                              "cutoff": cutoff}
        self.taper = taper or get_taper_function(
            self._taper_config["name"],
            {k: v for k, v in self._taper_config.items() if k != "name"},
        )

    def to(self, device=None, dtype=None):
        self.base_model = self.base_model.to(device=device, dtype=dtype)
        self.novelty_detector = self.novelty_detector.to(device=device,
                                                         dtype=dtype)
        return self

    @torch.no_grad()
    def predict(self, X: Dataset) -> Dataset:
        base = self.base_model.predict(X)
        centered, diags = self.novelty_detector.predict_novelties(
            X, cutoff=self.cutoff
        )
        taper_values = self.taper(centered)
        out = {k: diags[k] for k in diags}
        out[TAPER_VALUES_OUTPUT_VAR] = Quantity(taper_values, ("sample",))
        for var in self.base_model.output_variables:
            q = base[var]
            arr = torch.as_tensor(q.data)
            t = taper_values.reshape((-1,) + (1,) * (arr.ndim - 1))
            out[var] = Quantity(arr * t.to(arr.device), q.dims, q.units)
        return Dataset(out)

    def dump(self, path):
        os.makedirs(path, exist_ok=True)
        io.dump(self.base_model, os.path.join(path, "base_model"))
        io.dump(self.novelty_detector, os.path.join(path, "novelty_detector"))
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {"cutoff": self.cutoff,
                 "tapering_function": self._taper_config},
                f,
            )

    @classmethod
    def load(cls, path: str) -> "OutOfSampleModel":
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        return cls(
            io.load(os.path.join(path, "base_model")),
            io.load(os.path.join(path, "novelty_detector")),
            cutoff=meta.get("cutoff", 0.0),
            taper_config=meta.get("tapering_function"),
        )


@io.register("constant-output-novelty")
class ConstantOutputNoveltyDetector(NoveltyDetector):
    """Test stub emitting a constant novelty score (reference
    fv3fit/testing.py constant-output-novelty): the out-of-sample taper
    path without a trained detector."""

    def __init__(self, input_variables: Sequence[str], score: float = 0.0):
        super().__init__(input_variables)
        self.score = float(score)

    def _score(self, X: Dataset) -> torch.Tensor:
        q = next(iter(X.values()))
        return torch.full((q.shape[0],), self.score, dtype=torch.float32,
                          device=torch.as_tensor(q.data).device)

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {"input_variables": self.input_variables,
                 "score": self.score},
                f,
            )

    @classmethod
    def load(cls, path: str) -> "ConstantOutputNoveltyDetector":
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        return cls(meta["input_variables"], meta["score"])
