"""Novelty detection and out-of-sample tapering (port of
``fv3net_tpu/fit/novelty.py``; reference:
external/fv3fit/fv3fit/_shared/novelty_detector.py:21-60,
sklearn/_min_max_novelty_detector.py:35-160, _shared/taper_function.py
and _shared/models.py:340-440 OutOfSampleModel).

The min-max and one-class SVM detectors, the constant-score stub, the
taper functions and ``OutOfSampleModel`` are ported.  The one-class SVM
fits and scores without scikit-learn (``fit/one_class_svm.py``) and
reads and writes the reference's ``model.pkl``
(``fit/_sklearn_pickle.py``).
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
from fv3net_torch.fit import _sklearn_pickle as skp
from fv3net_torch.fit import io, one_class_svm, packer
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


@io.register("ocsvm")
class OCSVMNoveltyDetector(NoveltyDetector):
    """The one-class SVM detector (reference _ocsvm_novelty_detector.py:46
    over ``sklearn.svm.OneClassSVM``): fitted by libsvm's one-class
    solver on tensors (:mod:`fv3net_torch.fit.one_class_svm`), scored
    -(K(X, SV) @ dual_coef - rho) in float64 on the support vectors'
    device (positive out of sample), saved as the reference's
    ``model.pkl`` without scikit-learn."""

    def __init__(self, input_variables, svm=None, info=None, nu=0.1,
                 gamma="scale", tol=1e-3, n_samples=0):
        super().__init__(input_variables)
        self.svm = svm
        self.info = info
        self.nu, self.gamma, self.tol = nu, gamma, tol
        self.n_samples = n_samples

    def to(self, device=None, dtype=None):
        # scoring stays float64, as scikit-learn's
        if device is not None:
            self.svm.support_vectors = self.svm.support_vectors.to(device)
            self.svm.dual_coef = self.svm.dual_coef.to(device)
        return self

    def fit(self, batch: Dataset, gamma="scale", nu: float = 0.1,
            tol: float = 1e-3):
        data = packer.dataset_to_samples(batch, self.input_variables)
        X, self.info = packer.pack(data, self.input_variables)
        X = X.to(torch.float64)
        self.nu, self.gamma, self.tol = nu, gamma, tol
        self.n_samples = X.shape[0]
        value = None if gamma == "scale" else float(gamma)
        self.svm = one_class_svm.fit(X, nu=nu, gamma=value, tol=tol)
        return self

    def decision_function(self, X: torch.Tensor) -> torch.Tensor:
        return one_class_svm.decision_function(
            X, self.svm.support_vectors, self.svm.dual_coef, self.svm.rho,
            self.svm.gamma)

    def _score(self, Xd: Dataset) -> torch.Tensor:
        data = packer.dataset_to_samples(Xd, self.input_variables)
        X, _ = packer.pack(data, self.input_variables)
        # decision_function > 0 means in-sample: flip the sign so that
        # larger = more novel (the centered-score convention); computed
        # in float64, returned in the inputs' float dtype
        score = -self.decision_function(X)
        dtype = X.dtype if X.is_floating_point() else score.dtype
        return score.to(device=X.device, dtype=dtype)

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        f = self.svm
        skp.dump(skp.one_class_svm(
            f.support.cpu().numpy(), f.support_vectors.cpu().numpy(),
            f.dual_coef.cpu().numpy(), f.rho, f.gamma, self.n_samples,
            f.n_iter, self.nu, self.gamma, self.tol),
            os.path.join(path, "model.pkl"))
        with open(os.path.join(path, "metadata.json"), "w") as fh:
            json.dump({"input_variables": self.input_variables,
                       "info": _info_dict(self.info)}, fh)

    @classmethod
    def load(cls, path: str) -> "OCSVMNoveltyDetector":
        """The detector in ``path``, on the CPU, from the reference's
        pickle read without scikit-learn."""
        with open(os.path.join(path, "metadata.json")) as fh:
            meta = json.load(fh)
        m = skp.load(os.path.join(path, "model.pkl"))
        svm = one_class_svm.OneClassSVMFit(
            torch.as_tensor(np.asarray(m.support_, np.int64)),
            torch.as_tensor(np.asarray(m.support_vectors_, np.float64)),
            torch.as_tensor(np.asarray(m._dual_coef_, np.float64)[0]),
            float(-np.asarray(m._intercept_)[0]), float(m._gamma),
            int(m.n_iter_))
        return cls(meta["input_variables"], svm=svm,
                   info=_info(meta["info"]), nu=m.nu, gamma=m.gamma,
                   tol=m.tol, n_samples=int(m.shape_fit_[0]))


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


@dataclasses.dataclass
class OCSVMNoveltyDetectorHyperparameters:
    input_variables: List[str] = dataclasses.field(default_factory=list)
    gamma: str = "scale"
    nu: float = 0.1
    max_samples: int = 20000


@register_training_function(
    "ocsvm_novelty_detector", OCSVMNoveltyDetectorHyperparameters
)
def train_ocsvm_novelty_detector(hyperparameters, train_batches, val=None):
    """Fits on the first batch only, on its device; ``max_samples`` is
    not applied (as in the reference)."""
    det = OCSVMNoveltyDetector(hyperparameters.input_variables)
    batch = list(train_batches)[0]
    det.fit(batch, gamma=hyperparameters.gamma, nu=hyperparameters.nu)
    return det


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
