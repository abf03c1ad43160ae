"""Serialization registry (port of ``fv3net_tpu/fit/io.py``; reference:
external/fv3fit/fv3fit/_shared/io.py:17-92): an artifact directory holds
a ``name`` file naming its model type, and ``load(path)`` dispatches on
it.  The port reads and writes the reference's artifact formats, so a
model the reference trained and dumped loads here, and the reverse.
Every model type of the reference is registered, the scikit-learn
pickles of ``ocsvm`` and ``sklearn_random_forest`` among them (read and
written without scikit-learn: ``fit/_sklearn_pickle.py``); an unknown
name raises the reference's ``ValueError``.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Type

_NAME_PATH = "name"


class _Register:
    def __init__(self) -> None:
        self._model_types: Dict[str, Type] = {}

    def __call__(self, name: str) -> Callable[[Type], Type]:
        if name in self._model_types:
            raise ValueError(
                f"{name} already registered by {self._model_types[name]}"
            )

        def decorator(cls: Type) -> Type:
            self._model_types[name] = cls
            return cls

        return decorator

    def get_name(self, obj) -> str:
        best = None
        best_cls = None
        for name, cls in self._model_types.items():
            if isinstance(obj, cls):
                if best_cls is None or issubclass(cls, best_cls):
                    best, best_cls = name, cls
        if best is None:
            raise ValueError(
                f"{type(obj)} is not registered; decorate it with "
                "@fv3net_torch.fit.io.register('name')"
            )
        return best

    def load(self, path: str):
        with open(os.path.join(path, _NAME_PATH)) as f:
            name = f.read().strip()
        try:
            cls = self._model_types[name]
        except KeyError:
            raise ValueError(f"unknown model type {name!r} at {path}")
        return cls.load(path)

    def dump(self, obj, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _NAME_PATH), "w") as f:
            f.write(self.get_name(obj))
        obj.dump(path)


register = _Register()


def dump(obj, path: str) -> None:
    register.dump(obj, path)


def load(path: str):
    """The model dumped at ``path``, on the CPU in the dtype it was saved
    in (``.to(device, dtype)`` moves it)."""
    # the registered types register on import
    from fv3net_torch.fit import (  # noqa: F401
        autoencoder,
        convolutional,
        cyclegan,
        dense,
        graph,
        models,
        novelty,
        precipitative,
        random_forest,
        recurrent,
        reservoir,
        testing,
        transformed,
        transformers,
    )

    return register.load(path)
