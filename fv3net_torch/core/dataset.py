"""Dataset: ordered mapping of named Quantities, the xarray.Dataset analog
(port of ``fv3net_tpu/core/dataset.py`` without its pytree registration).

Used at framework boundaries (diagnostics, training data, zarr I/O).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping

import numpy as np

from fv3net_torch.core.quantity import Quantity


class Dataset:
    """A dict of Quantity with shared coords and attrs."""

    def __init__(
        self,
        data_vars: Mapping[str, Quantity] = None,
        coords: Mapping[str, np.ndarray] = None,
        attrs: Dict[str, Any] = None,
    ):
        self._vars: Dict[str, Quantity] = dict(data_vars or {})
        self.coords: Dict[str, np.ndarray] = dict(coords or {})
        self.attrs: Dict[str, Any] = dict(attrs or {})
        for name, q in self._vars.items():
            if not isinstance(q, Quantity):
                raise TypeError(f"variable {name!r} is not a Quantity: {type(q)}")

    # -- mapping interface ---------------------------------------------------
    def __getitem__(self, key: str) -> Quantity:
        return self._vars[key]

    def __setitem__(self, key: str, value: Quantity):
        self._vars[key] = value

    def __delitem__(self, key: str):
        del self._vars[key]

    def __contains__(self, key: str) -> bool:
        return key in self._vars

    def __iter__(self) -> Iterator[str]:
        return iter(self._vars)

    def __len__(self) -> int:
        return len(self._vars)

    def keys(self):
        return self._vars.keys()

    def values(self):
        return self._vars.values()

    def items(self):
        return self._vars.items()

    @property
    def data_vars(self) -> Dict[str, Quantity]:
        return dict(self._vars)

    @property
    def dims(self) -> Dict[str, int]:
        sizes: Dict[str, int] = {}
        for q in self._vars.values():
            for d, n in q.sizes.items():
                if d in sizes and sizes[d] != n:
                    raise ValueError(
                        f"inconsistent size for dim {d}: {sizes[d]} vs {n}"
                    )
                sizes[d] = n
        return sizes

    sizes = dims

    def __repr__(self):
        lines = ["Dataset:"]
        for name, q in self._vars.items():
            lines.append(f"  {name}: {q.dims} {q.shape} {q.dtype} [{q.units}]")
        return "\n".join(lines)

    # -- operations ----------------------------------------------------------
    def isel(self, indexers: Mapping[str, Any] = None, **kwargs) -> "Dataset":
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        out = {}
        for name, q in self._vars.items():
            sub = {d: v for d, v in indexers.items() if d in q.dims}
            out[name] = q.isel(sub) if sub else q
        return Dataset(out, self.coords, self.attrs)

    def merge(self, other: "Dataset") -> "Dataset":
        merged = dict(self._vars)
        merged.update(other._vars if isinstance(other, Dataset) else other)
        coords = dict(self.coords)
        if isinstance(other, Dataset):
            coords.update(other.coords)
        return Dataset(merged, coords, self.attrs)

    def rename(self, name_map: Mapping[str, str]) -> "Dataset":
        return Dataset(
            {name_map.get(k, k): v for k, v in self._vars.items()},
            self.coords,
            self.attrs,
        )

    def rename_dims(self, name_map: Mapping[str, str]) -> "Dataset":
        return Dataset(
            {k: v.rename_dims(name_map) for k, v in self._vars.items()},
            self.coords,
            self.attrs,
        )

    def drop_vars(self, names) -> "Dataset":
        if isinstance(names, str):
            names = [names]
        return Dataset(
            {k: v for k, v in self._vars.items() if k not in set(names)},
            self.coords,
            self.attrs,
        )

    def map(self, fn) -> "Dataset":
        return Dataset(
            {k: fn(v) for k, v in self._vars.items()}, self.coords, self.attrs
        )

    def as_numpy(self) -> "Dataset":
        return self.map(lambda q: Quantity(q.values, q.dims, q.units, dict(q.attrs)))


def merge(datasets) -> Dataset:
    out = Dataset()
    for ds in datasets:
        out = out.merge(ds)
    return out
