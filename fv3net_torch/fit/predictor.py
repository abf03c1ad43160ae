"""Predictor protocol (port of ``fv3net_tpu/fit/predictor.py``; reference:
external/fv3fit/fv3fit/_shared/predictor.py:44-90) on the port's
Dataset-of-Quantities boundary."""
from __future__ import annotations

import abc
from typing import Iterable

from fv3net_torch.core.dataset import Dataset


class Dumpable(abc.ABC):
    @abc.abstractmethod
    def dump(self, path: str) -> None:
        """Serialize to a directory."""


class Loadable(abc.ABC):
    @classmethod
    @abc.abstractmethod
    def load(cls, path: str) -> "Loadable":
        """Load from a directory."""


class Reloadable(Dumpable, Loadable):
    pass


class Predictor(Reloadable):
    """Maps a Dataset holding ``input_variables`` (stacked
    [sample, (feature)] Quantities) to a Dataset of ``output_variables``."""

    def __init__(
        self,
        input_variables: Iterable[str],
        output_variables: Iterable[str],
    ):
        self.input_variables = list(input_variables)
        self.output_variables = list(output_variables)

    @abc.abstractmethod
    def predict(self, X: Dataset) -> Dataset:
        """Predict output variables from input variables."""
