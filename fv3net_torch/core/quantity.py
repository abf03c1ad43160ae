"""Named-array container (port of ``fv3net_tpu/core/quantity.py``).

``Quantity`` wraps a numpy array or a ``torch.Tensor`` with named
dimensions, units and attributes: boundary code (diagnostics, zarr I/O,
pipelines) keeps xarray-like ergonomics while ``.data`` goes straight
into tensor code.  The reference registers it as a JAX pytree; the port
has no counterpart of that and drops it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def _normalize_dims(dims: Sequence[Hashable], ndim: int) -> Tuple[str, ...]:
    dims = tuple(str(d) for d in dims)
    if len(dims) != ndim:
        raise ValueError(f"got {len(dims)} dims {dims} for array with ndim={ndim}")
    return dims


def _transpose(data: Array, axes: Sequence[int]) -> Array:
    if torch.is_tensor(data):
        return data.permute(*axes) if axes else data
    return np.transpose(data, axes)


def _reduce_fn(name: str):
    """``fn(data, axes)`` of a named reduction for either array type."""
    torch_names = {"min": "amin", "max": "amax"}

    def fn(data, axes=None):
        if torch.is_tensor(data):
            f = getattr(torch, torch_names.get(name, name))
            return f(data) if axes is None else f(data, dim=axes)
        return getattr(np, name)(data, axis=axes)

    return fn


@dataclasses.dataclass
class Quantity:
    """An array with named dimensions, units and attributes."""

    data: Array
    dims: Tuple[str, ...]
    units: str = ""
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not isinstance(self.data, (np.ndarray, torch.Tensor)):
            self.data = np.asarray(self.data)
        self.dims = _normalize_dims(self.dims, self.data.ndim)
        if self.units and "units" not in self.attrs:
            self.attrs = {**self.attrs, "units": self.units}

    # -- basic properties --------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.dims, self.data.shape))

    @property
    def values(self) -> np.ndarray:
        """The data as a numpy array (copied from the device if need be)."""
        if torch.is_tensor(self.data):
            return self.data.detach().cpu().numpy()
        return np.asarray(self.data)

    def item(self):
        return self.values.item()

    def get_axis_num(self, dim: str) -> int:
        return self.dims.index(dim)

    def __repr__(self):
        return (
            f"Quantity(dims={self.dims}, shape={self.shape}, "
            f"dtype={self.dtype}, units={self.units!r})"
        )

    # -- construction helpers ----------------------------------------------
    def with_data(self, data: Array) -> "Quantity":
        return Quantity(data, self.dims, self.units, dict(self.attrs))

    def assign_attrs(self, **attrs) -> "Quantity":
        new = dict(self.attrs)
        new.update(attrs)
        units = attrs.get("units", self.units)
        return Quantity(self.data, self.dims, units, new)

    def astype(self, dtype) -> "Quantity":
        if torch.is_tensor(self.data):
            return self.with_data(self.data.to(dtype))
        return self.with_data(self.data.astype(dtype))

    def copy(self) -> "Quantity":
        data = (self.data.clone() if torch.is_tensor(self.data)
                else self.data.copy())
        return Quantity(data, self.dims, self.units, dict(self.attrs))

    def rename_dims(self, name_map: Mapping[str, str]) -> "Quantity":
        dims = tuple(name_map.get(d, d) for d in self.dims)
        return Quantity(self.data, dims, self.units, dict(self.attrs))

    def expand_dims(self, dim: str, axis: int = 0) -> "Quantity":
        data = (self.data.unsqueeze(axis) if torch.is_tensor(self.data)
                else np.expand_dims(self.data, axis))
        dims = list(self.dims)
        dims.insert(axis if axis >= 0 else len(dims) + axis + 1, dim)
        return Quantity(data, tuple(dims), self.units, dict(self.attrs))

    # -- indexing ------------------------------------------------------------
    def isel(self, indexers: Mapping[str, Any] = None, **kwargs) -> "Quantity":
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        idx = []
        out_dims = []
        for d in self.dims:
            if d in indexers:
                sel = indexers[d]
                idx.append(sel)
                if isinstance(sel, (slice, list, tuple)) or (
                    getattr(sel, "ndim", 0) > 0
                ):
                    out_dims.append(d)
            else:
                idx.append(slice(None))
                out_dims.append(d)
        return Quantity(self.data[tuple(idx)], tuple(out_dims), self.units,
                        dict(self.attrs))

    def transpose(self, *dims: str) -> "Quantity":
        if not dims:
            dims = tuple(reversed(self.dims))
        axes = [self.dims.index(d) for d in dims]
        return Quantity(_transpose(self.data, axes), tuple(dims), self.units,
                        dict(self.attrs))

    # -- dim-aligned broadcasting -------------------------------------------
    def _binary_op(self, other, op):
        if isinstance(other, Quantity):
            dims, a, b = _align(self, other)
            return Quantity(op(a, b), dims)
        return Quantity(op(self.data, other), self.dims, self.units,
                        dict(self.attrs))

    def _rbinary_op(self, other, op):
        if isinstance(other, Quantity):
            dims, a, b = _align(self, other)
            return Quantity(op(b, a), dims)
        return Quantity(op(other, self.data), self.dims, self.units,
                        dict(self.attrs))

    def __add__(self, o): return self._binary_op(o, lambda a, b: a + b)
    def __radd__(self, o): return self._rbinary_op(o, lambda a, b: a + b)
    def __sub__(self, o): return self._binary_op(o, lambda a, b: a - b)
    def __rsub__(self, o): return self._rbinary_op(o, lambda a, b: a - b)
    def __mul__(self, o): return self._binary_op(o, lambda a, b: a * b)
    def __rmul__(self, o): return self._rbinary_op(o, lambda a, b: a * b)
    def __truediv__(self, o): return self._binary_op(o, lambda a, b: a / b)
    def __rtruediv__(self, o): return self._rbinary_op(o, lambda a, b: a / b)
    def __pow__(self, o): return self._binary_op(o, lambda a, b: a ** b)
    def __neg__(self): return self.with_data(-self.data)
    def __abs__(self): return self.with_data(abs(self.data))
    def __lt__(self, o): return self._binary_op(o, lambda a, b: a < b)
    def __le__(self, o): return self._binary_op(o, lambda a, b: a <= b)
    def __gt__(self, o): return self._binary_op(o, lambda a, b: a > b)
    def __ge__(self, o): return self._binary_op(o, lambda a, b: a >= b)

    # -- reductions -----------------------------------------------------------
    def _reduce(self, name: str, dim=None):
        fn = _reduce_fn(name)
        if dim is None:
            return Quantity(fn(self.data), ())
        dims = (dim,) if isinstance(dim, str) else tuple(dim)
        axes = tuple(self.dims.index(d) for d in dims)
        out_dims = tuple(d for d in self.dims if d not in dims)
        return Quantity(fn(self.data, axes), out_dims)

    def sum(self, dim=None):
        return self._reduce("sum", dim)

    def mean(self, dim=None):
        return self._reduce("mean", dim)

    def min(self, dim=None):
        return self._reduce("min", dim)

    def max(self, dim=None):
        return self._reduce("max", dim)

    def cumsum(self, dim: str):
        axis = self.dims.index(dim)
        data = (self.data.cumsum(dim=axis) if torch.is_tensor(self.data)
                else np.cumsum(self.data, axis=axis))
        return self.with_data(data)

    def diff(self, dim: str):
        axis = self.dims.index(dim)
        data = (self.data.diff(dim=axis) if torch.is_tensor(self.data)
                else np.diff(self.data, axis=axis))
        return self.with_data(data)

    def fillna(self, value) -> "Quantity":
        return self.where(~_isnan(self.data), value)

    def where(self, cond, other=np.nan) -> "Quantity":
        cond_data = cond.data if isinstance(cond, Quantity) else cond
        other_data = other.data if isinstance(other, Quantity) else other
        if torch.is_tensor(self.data):
            cond_data = torch.as_tensor(cond_data, device=self.data.device)
            return self.with_data(torch.where(cond_data, self.data, other_data))
        return self.with_data(np.where(cond_data, self.data, other_data))


def _isnan(data: Array):
    return torch.isnan(data) if torch.is_tensor(data) else np.isnan(data)


def _align(a: Quantity, b: Quantity):
    """Broadcast two quantities by dim name, xarray-style.

    Output dims: dims of ``a`` followed by dims of ``b`` not in ``a``.
    """
    out_dims = list(a.dims) + [d for d in b.dims if d not in a.dims]

    def expand(q: Quantity):
        # move existing axes into out_dims order, inserting size-1 axes
        src_order = [q.dims.index(d) for d in out_dims if d in q.dims]
        data = _transpose(q.data, src_order)
        shape_iter = iter(data.shape)
        full_shape = [
            next(shape_iter) if d in q.dims else 1 for d in out_dims
        ]
        return data.reshape(full_shape)

    return tuple(out_dims), expand(a), expand(b)


def _like(q: Quantity, value) -> Quantity:
    data = (torch.full_like(q.data, value) if torch.is_tensor(q.data)
            else np.full_like(q.data, value))
    return Quantity(data, q.dims, q.units, dict(q.attrs))


def zeros_like(q: Quantity) -> Quantity:
    return _like(q, 0)


def ones_like(q: Quantity) -> Quantity:
    return _like(q, 1)


def full_like(q: Quantity, value) -> Quantity:
    return _like(q, value)


def where(cond, x, y) -> Quantity:
    """Dim-aligned three-way where; at least one argument must be a
    Quantity.  The output's dims are the union of the Quantities' dims in
    order of appearance (cond, x, y); on tensors when any data is one."""
    qs = [v for v in (cond, x, y) if isinstance(v, Quantity)]
    if not qs:
        raise TypeError("where() requires at least one Quantity argument")
    out_dims = []
    for q in qs:
        for d in q.dims:
            if d not in out_dims:
                out_dims.append(d)
    datas = [v.data if isinstance(v, Quantity) else v for v in (cond, x, y)]
    tensor = next((d for d in datas if torch.is_tensor(d)), None)

    def expand(v):
        if not isinstance(v, Quantity):
            return v
        src_order = [v.dims.index(d) for d in out_dims if d in v.dims]
        data = _transpose(v.data, src_order)
        shape_iter = iter(data.shape)
        full_shape = [next(shape_iter) if d in v.dims else 1
                      for d in out_dims]
        return data.reshape(full_shape)

    c, a, b = (expand(v) for v in (cond, x, y))
    if tensor is None:
        return Quantity(np.where(c, a, b), tuple(out_dims))
    device = tensor.device

    def as_tensor(v):
        return (v.to(device) if torch.is_tensor(v)
                else torch.as_tensor(v, device=device))

    return Quantity(torch.where(as_tensor(c).bool(), as_tensor(a),
                                as_tensor(b)), tuple(out_dims))
