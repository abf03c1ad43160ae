"""Trainer registry, training config and the ``fv3fit-train-torch``
CLI (port of ``fv3net_tpu/fit/train.py``; reference:
external/fv3fit/fv3fit/_shared/training_config.py and
fv3fit/train.py:33-192).

``@register_training_function(name, HyperparamCls)`` registers
``fn(hyperparameters, train_batches, validation_batches) -> model``;
``train_main`` resolves, fits and dumps a model with its ``train.yaml``.
Every trainer of the reference is ported, ``ocsvm_novelty_detector`` and
``sklearn_random_forest`` among them (their solvers written on tensors,
without scikit-learn).  ``main`` reads the data configs as the reference does (the
loaders' configs, or the legacy ``{kind, path, variables}`` dict),
asks a loader config for the hyperparameters' ``state_variables`` too
(which the reference's CLI leaves out, so that its ``fmr``,
``dense_autoencoder`` and ``cyclegan`` trainers get no variables from
one: ROADMAP.md Queue 3) and trains on ``--device`` (default ``cuda``:
without a card it raises).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Type

import numpy as np

_TRAINING_FUNCTIONS: Dict[str, Tuple[Callable, Type]] = {}


def register_training_function(name: str, hyperparameter_class: Type):
    """Decorator registering ``fn(hyperparameters, train_batches,
    validation_batches) -> model`` under ``name``."""

    def decorator(fn):
        if name in _TRAINING_FUNCTIONS:
            raise ValueError(f"training function {name!r} already registered")
        _TRAINING_FUNCTIONS[name] = (fn, hyperparameter_class)
        return fn

    return decorator


def _import_trainers() -> None:
    # the registered trainers register on import
    from fv3net_torch.fit import (  # noqa: F401
        autoencoder,
        convolutional,
        cyclegan,
        dense,
        graph,
        novelty,
        precipitative,
        random_forest,
        recurrent,
        reservoir,
        transformed,
    )


def get_training_function(name: str) -> Callable:
    _import_trainers()
    return _TRAINING_FUNCTIONS[name][0]


def get_hyperparameter_class(name: str) -> Type:
    _import_trainers()
    return _TRAINING_FUNCTIONS[name][1]


def training_function_names():
    _import_trainers()
    return sorted(_TRAINING_FUNCTIONS)


@dataclasses.dataclass
class TrainingConfig:
    """Top-level training configuration (reference train.py:110-135)."""

    model_type: str
    hyperparameters: Any
    random_seed: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "TrainingConfig":
        model_type = d["model_type"]
        hp = get_hyperparameter_class(model_type)(
            **d.get("hyperparameters", {}))
        return cls(model_type=model_type, hyperparameters=hp,
                   random_seed=d.get("random_seed", 0))

    def to_dict(self) -> dict:
        return {
            "model_type": self.model_type,
            "hyperparameters": dataclasses.asdict(self.hyperparameters),
            "random_seed": self.random_seed,
        }


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed + 1)


def apply_config_overrides(d: dict, overrides: Sequence[str]) -> dict:
    """Apply ``a.b.c=value`` dotted-path CLI overrides (reference
    train.py:110-117)."""
    import yaml

    for item in overrides:
        path, value = item.split("=", 1)
        keys = path.split(".")
        node = d
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = yaml.safe_load(value)
    return d


def train_main(config_dict: dict, train_batches, validation_batches,
               output_path: str):
    """Resolve the trainer, fit, dump the model (the reference's artifact
    format) and its ``train.yaml``."""
    import yaml

    from fv3net_torch.fit import io

    config = TrainingConfig.from_dict(config_dict)
    set_random_seed(config.random_seed)
    train_fn = get_training_function(config.model_type)
    model = train_fn(config.hyperparameters, train_batches,
                     validation_batches)
    io.dump(model, output_path)
    with open(os.path.join(output_path, "train.yaml"), "w") as f:
        yaml.safe_dump(config.to_dict(), f)
    print(json.dumps({"step": "train", "model_type": config.model_type,
                      "output": output_path}))
    return model


def batches_on(batches, device, dtype=None):
    """``batches`` (a sequence of Datasets, or of tuples of them) with
    every tensor on ``device`` (and in ``dtype`` if given), lazily."""
    import torch

    from fv3net_torch.core.quantity import Quantity
    from fv3net_torch.loaders.sequences import Map

    def move(ds):
        if isinstance(ds, tuple):
            return tuple(move(d) for d in ds)
        return ds.map(lambda q: Quantity(
            torch.as_tensor(q.data, device=device, dtype=dtype), q.dims,
            q.units, dict(q.attrs)))

    return Map(move, batches)


def open_batches(cfg: dict, variables: Sequence[str]):
    """The batches of a data config: the legacy ``{kind, path,
    variables}`` dict, or a loader config of ``fit/data.py``'s registry
    (``FromBatches`` over the loaders' ``BatchesConfig`` /
    ``BatchesFromMapperConfig``, ``WindowedZarrLoader``,
    ``SyntheticNoise``; reference train.py:139-141)."""
    if "kind" in cfg or ("path" in cfg and "variables" in cfg):
        from fv3net_torch.loaders import batches_from_config

        return batches_from_config(cfg)
    from fv3net_torch.fit.data import tfdataset_loader_from_dict

    loader = tfdataset_loader_from_dict(cfg)
    return loader.open_tfdataset(None, variables)


def config_variables(config_dict: dict):
    """The variables the CLI asks a loader config for: the
    hyperparameters' input, output and state variables."""
    hp = config_dict.get("hyperparameters", {})
    return [v for key in ("input_variables", "output_variables",
                          "state_variables")
            for v in hp.get(key, [])]


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: train <training.yaml> <data.yaml> <output> [overrides...]
    [--device cuda|cpu] (reference: python -m fv3fit.train).  A
    ``validation`` entry of the data config opens the validation
    batches."""
    import yaml

    from fv3net_torch.pipelines import resolve_device

    parser = argparse.ArgumentParser("fv3fit-train-torch")
    parser.add_argument("training_config")
    parser.add_argument("training_data_config")
    parser.add_argument("output_path")
    parser.add_argument("overrides", nargs="*")
    parser.add_argument("--device", default="cuda",
                        help="device the batches and the trainer use "
                             "(default cuda; cpu to train on the CPU)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    with open(args.training_config) as f:
        config_dict = apply_config_overrides(yaml.safe_load(f),
                                             args.overrides)
    TrainingConfig.from_dict(config_dict)  # validate before the data
    with open(args.training_data_config) as f:
        data_config = yaml.safe_load(f)

    variables = config_variables(config_dict)
    val_config = data_config.pop("validation", None)
    train_batches = batches_on(open_batches(data_config, variables), device)
    val_batches = (batches_on(open_batches(val_config, variables), device)
                   if val_config else None)
    train_main(config_dict, train_batches, val_batches, args.output_path)
    return 0


if __name__ == "__main__":
    # `python -m fv3net_torch.fit.train` runs this file as __main__, a
    # second module whose trainer registry stays empty (the trainers
    # register in fv3net_torch.fit.train): hand over to that one
    from fv3net_torch.fit.train import main as _canonical_main

    raise SystemExit(_canonical_main())
