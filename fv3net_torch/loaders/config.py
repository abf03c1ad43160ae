"""Mapper/batches function registries and config dataclasses (port of
``fv3net_tpu/loaders/config.py``; reference:
external/loaders/loaders/_config.py):
``mapper_functions`` / ``batches_functions`` FunctionRegisters,
``MapperConfig`` (function+kwargs dispatch), ``BatchesLoader`` ABC with
subclass-dispatched ``from_dict``, ``BatchesConfig`` and
``BatchesFromMapperConfig``.  These drive YAML training-data configs and
the ``validate-batches-config`` CLI.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from fv3net_torch.core.dataset import Dataset


class FunctionRegister(Dict[str, Callable]):
    """Name -> function registry (reference _config.py:14-21)."""

    def register(self, func: Callable) -> Callable:
        self[func.__name__] = func
        return func

    def __repr__(self):
        return str(sorted(self.keys()))


mapper_functions: FunctionRegister = FunctionRegister()
batches_functions: FunctionRegister = FunctionRegister()


@dataclasses.dataclass
class MapperConfig:
    """Mapper-loading config: ``function`` names a registered mapper
    opener, ``kwargs`` are passed through (reference _config.py:28-53)."""

    function: str
    kwargs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.function not in mapper_functions:
            raise ValueError(
                f"invalid mapper function {self.function!r}, must be one of "
                f"{sorted(mapper_functions)}"
            )

    def load_mapper(self):
        return mapper_functions[self.function](**self.kwargs)


class BatchesLoader:
    """ABC for batch-loading configs; ``from_dict`` dispatches to the
    first subclass whose fields match (reference _config.py:56-87)."""

    def load_batches(self, variables: Optional[Sequence[str]] = None):
        raise NotImplementedError

    @classmethod
    def from_dict(cls, kwargs: dict) -> "BatchesLoader":
        candidates = [cls] if cls is not BatchesLoader else []
        candidates += cls.__subclasses__()
        for subclass in candidates:
            if not dataclasses.is_dataclass(subclass):
                continue
            try:
                return _from_flat_dict(subclass, kwargs)
            except (TypeError, KeyError, ValueError):
                continue
        raise ValueError(f"invalid BatchesLoader dictionary: {kwargs}")


def _from_flat_dict(dc, kwargs: dict):
    fields = {f.name: f for f in dataclasses.fields(dc)}
    unknown = set(kwargs) - set(fields)
    if unknown:
        raise TypeError(f"unknown keys {unknown} for {dc.__name__}")
    converted = {}
    for name, value in kwargs.items():
        f = fields[name]
        if f.type in ("MapperConfig", MapperConfig) and isinstance(value, dict):
            value = MapperConfig(**value)
        converted[name] = value
    return dc(**converted)


@dataclasses.dataclass
class BatchesConfig(BatchesLoader):
    """Registered-batches-function config (reference _config.py:90-125)."""

    function: str
    kwargs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.function not in batches_functions:
            raise ValueError(
                f"invalid batches function {self.function!r}, must be one of "
                f"{sorted(batches_functions)}"
            )

    def load_batches(self, variables: Optional[Sequence[str]] = None) -> List[Dataset]:
        kwargs = dict(self.kwargs)
        names = list(kwargs.get("variable_names", []))
        for v in variables or []:
            if v not in names:
                names.append(v)
        if names:
            kwargs["variable_names"] = names
        return batches_functions[self.function](**kwargs)


@dataclasses.dataclass
class BatchesFromMapperConfig(BatchesLoader):
    """Mapper -> stacked batches config (reference batches/_batch.py:45-140):
    open the configured mapper, then stack/shuffle/subsample timestep
    groups into [sample(, z)] batches."""

    mapper_config: MapperConfig
    variable_names: Sequence[str] = ()
    timesteps_per_batch: int = 1
    timesteps: Optional[Sequence[str]] = None
    subsample_ratio: float = 1.0
    shuffle_timesteps: bool = True
    shuffle_seed: Optional[int] = 0

    def __post_init__(self):
        if self.timesteps is not None:
            dupes = {t for t in self.timesteps if list(self.timesteps).count(t) > 1}
            if dupes:
                raise ValueError(f"duplicated timesteps: {sorted(dupes)}")

    def load_mapper(self):
        return self.mapper_config.load_mapper()

    def load_batches(self, variables: Optional[Sequence[str]] = None) -> List[Dataset]:
        from fv3net_torch.loaders.batches import batches_from_mapper

        names = list(self.variable_names)
        for v in variables or []:
            if v not in names:
                names.append(v)
        return batches_from_mapper(
            self.load_mapper(),
            names,
            timesteps=self.timesteps,
            timesteps_per_batch=self.timesteps_per_batch,
            subsample_ratio=self.subsample_ratio,
            shuffle_seed=self.shuffle_seed if self.shuffle_timesteps else None,
        )
