"""Schema core: describe a dataset's layout, generate deterministic
random data matching it (port of ``fv3net_tpu/synth/core.py``; reference:
external/synth/synth/core.py:33-200).

The values are the reference's: ``np.random.RandomState(seed).uniform``
on the host, in the schema's dtype; ``generate`` puts them on ``device``
as the port's Quantity tensors.  The schemas and their JSON are the
reference's, so either package reads the other's stores and schemas."""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.core import zarrio

SCHEMA_VERSION = "v3"


@dataclasses.dataclass
class Range:
    min: float = 0.0
    max: float = 1.0

    def generate_array(self, shape, dtype, seed: int = 0) -> np.ndarray:
        rng = np.random.RandomState(seed)
        return rng.uniform(self.min, self.max, size=tuple(shape)).astype(dtype)


@dataclasses.dataclass
class VariableSchema:
    name: str
    dims: Sequence[str]
    shape: Sequence[int]
    dtype: str = "<f4"
    attrs: Mapping = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CoordinateSchema:
    name: str
    dims: Sequence[str]
    value: np.ndarray
    attrs: Mapping = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DatasetSchema:
    coords: Dict[str, CoordinateSchema] = dataclasses.field(default_factory=dict)
    variables: Dict[str, VariableSchema] = dataclasses.field(default_factory=dict)


def generate(
    schema: DatasetSchema, ranges: Optional[Mapping[str, Range]] = None,
    device="cuda",
) -> Dataset:
    """Deterministically generate a Dataset matching the schema, its
    variables tensors on ``device``; per-variable value ranges via
    ``ranges`` (reference core.py generate)."""
    ranges = dict(ranges or {})
    data = {}
    for name, var in schema.variables.items():
        rng = ranges.get(name, Range(0.0, 1.0))
        arr = rng.generate_array(
            var.shape, np.dtype(var.dtype), seed=abs(hash(name)) % (2 ** 31)
        )
        data[name] = Quantity(torch.as_tensor(arr, device=device),
                              tuple(var.dims), attrs=dict(var.attrs))
    coords = {name: np.asarray(c.value) for name, c in schema.coords.items()}
    return Dataset(data, coords=coords)


def read_schema_from_dataset(ds: Dataset) -> DatasetSchema:
    variables = {
        name: VariableSchema(
            name=name,
            dims=list(q.dims),
            shape=list(q.shape),
            dtype=np.dtype(q.values.dtype).str,
            attrs=dict(q.attrs),
        )
        for name, q in ds.items()
    }
    coords = {
        name: CoordinateSchema(name=name, dims=[name], value=np.asarray(v))
        for name, v in ds.coords.items()
    }
    return DatasetSchema(coords=coords, variables=variables)


def read_schema_from_zarr(path: str) -> DatasetSchema:
    """(reference synth/__init__.py read_schema_from_zarr)"""
    return read_schema_from_dataset(zarrio.open_zarr(path))


class _Encoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        return json.JSONEncoder.default(self, o)


def dumps(schema: DatasetSchema) -> str:
    return json.dumps(
        {
            "version": SCHEMA_VERSION,
            "schema": {
                "coords": {
                    k: dataclasses.asdict(v) for k, v in schema.coords.items()
                },
                "variables": {
                    k: dataclasses.asdict(v) for k, v in schema.variables.items()
                },
            },
        },
        cls=_Encoder,
    )


def dump(schema: DatasetSchema, fp) -> None:
    fp.write(dumps(schema))


def loads(s: str) -> DatasetSchema:
    d = json.loads(s)
    sch = d["schema"]
    coords = {
        k: CoordinateSchema(
            name=v["name"], dims=v["dims"], value=np.asarray(v["value"]),
            attrs=v.get("attrs", {}),
        )
        for k, v in sch["coords"].items()
    }
    variables = {
        k: VariableSchema(**v) for k, v in sch["variables"].items()
    }
    return DatasetSchema(coords=coords, variables=variables)


def load(fp) -> DatasetSchema:
    return loads(fp.read())
