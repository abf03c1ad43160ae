"""CDL (Common Data Language) -> Dataset (a copy of the host-only
``fv3net_tpu/synth/cdl.py``; its arrays stay numpy).

Reference semantics: external/vcm/vcm/cdl/{parser,generate}.py — a
lark-grammar parser used to write compact synthetic test datasets as CDL
text.  This implementation is a small hand-rolled recursive-descent
parser over the same CDL subset (dimensions / variables with dtypes and
attributes / data section, // comments, UNLIMITED dims, NaN literals,
``_`` fill placeholders) producing a ``fv3net_torch.core.Dataset``.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity

_DTYPES = {
    "float": np.float32,
    "double": np.float64,
    "int": np.int32,
    "int64": np.int64,
    "byte": np.int8,
    "char": np.dtype("S1"),
}

_TOKEN_RE = re.compile(
    r'"(?:[^"\\]|\\.)*"'  # string literal
    r"|[A-Za-z_][A-Za-z0-9_]*"  # name / keyword
    r"|[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?[fF]?"  # number
    r"|[{}();:,=_]"  # punctuation
)


def _tokenize(text: str) -> List[str]:
    text = re.sub(r"//[^\n]*", "", text)
    return _TOKEN_RE.findall(text)


def _parse_value(tok: str):
    if tok.startswith('"'):
        return tok[1:-1].replace('\\"', '"')
    if tok in ("NaN", "NaNf"):
        return np.nan
    return float(tok.rstrip("fF"))


class _Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.i = 0
        self.dims: Dict[str, int] = {}
        self.var_dims: Dict[str, List[str]] = {}
        self.var_dtype: Dict[str, np.dtype] = {}
        self.var_attrs: Dict[str, dict] = {}
        self.var_data: Dict[str, list] = {}
        self.global_attrs: Dict[str, object] = {}

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, tok: str):
        got = self.next()
        if got != tok:
            raise ValueError(f"CDL parse error: expected {tok!r}, got {got!r}")

    def parse(self):
        self.expect("netcdf")
        while self.peek() != "{":
            self.next()  # dataset name tokens
        self.expect("{")
        while self.peek() not in ("}", None):
            section = self.next()
            self.expect(":")
            if section == "dimensions":
                self._dimensions()
            elif section == "variables":
                self._variables()
            elif section == "data":
                self._data()
            else:
                raise ValueError(f"CDL parse error: unknown section {section!r}")
        return self

    def _at_section(self):
        return (
            self.peek() in ("dimensions", "variables", "data")
            and self.i + 1 < len(self.toks)
            and self.toks[self.i + 1] == ":"
        )

    def _dimensions(self):
        while self.peek() not in ("}", None) and not self._at_section():
            name = self.next()
            self.expect("=")
            size = self.next()
            self.dims[name] = 0 if size == "UNLIMITED" else int(size)
            self.expect(";")

    def _variables(self):
        while self.peek() not in ("}", None) and not self._at_section():
            tok = self.next()
            if tok == ":":  # global attribute:  :title = "..." ;
                attr = self.next()
                self.expect("=")
                self.global_attrs[attr] = _parse_value(self.next())
                self.expect(";")
            elif tok in _DTYPES:  # variable declaration
                name = self.next()
                dims: List[str] = []
                if self.peek() == "(":
                    self.next()
                    while self.peek() != ")":
                        d = self.next()
                        if d != ",":
                            dims.append(d)
                    self.expect(")")
                self.var_dims[name] = dims
                self.var_dtype[name] = np.dtype(_DTYPES[tok])
                self.expect(";")
            else:  # variable attribute:  var:attr = value ;
                self.expect(":")
                attr = self.next()
                self.expect("=")
                self.var_attrs.setdefault(tok, {})[attr] = _parse_value(self.next())
                self.expect(";")

    def _data(self):
        while self.peek() not in ("}", None) and not self._at_section():
            name = self.next()
            self.expect("=")
            values = []
            while self.peek() != ";":
                tok = self.next()
                if tok == ",":
                    continue
                values.append(np.nan if tok == "_" else _parse_value(tok))
            self.expect(";")
            self.var_data[name] = values


def cdl_to_dataset(cdl: str) -> Dataset:
    """Build a Dataset from CDL text (reference
    external/vcm/vcm/cdl/generate.py:91-130 ``cdl_to_dataset``): declared
    variables are zero-initialized to their dimension shapes, then filled
    row-major with any values given in the ``data:`` section."""
    p = _Parser(_tokenize(cdl)).parse()
    data_vars = {}
    coords = {}
    for name, dims in p.var_dims.items():
        shape = tuple(p.dims[d] for d in dims)
        dtype = p.var_dtype[name]
        arr = np.zeros(shape, dtype=np.float64 if dtype.kind == "f" else dtype)
        if name in p.var_data:
            flat = arr.ravel()
            vals = p.var_data[name]
            n = min(flat.size, len(vals))
            flat[:n] = vals[:n]
        arr = arr.astype(dtype) if dtype.kind != "S" else arr
        attrs = p.var_attrs.get(name, {})
        if "_FillValue" in attrs and dtype.kind == "f":
            # CF decoding of declared fill values (the reference applies
            # xarray.decode_cf, generate.py:130)
            fill = attrs.pop("_FillValue")
            arr = np.where(arr == fill, np.nan, arr).astype(np.float64)
        if tuple(dims) == (name,):
            coords[name] = arr
        else:
            data_vars[name] = Quantity(
                arr, tuple(dims), units=str(attrs.get("units", "")), attrs=attrs
            )
    return Dataset(data_vars, coords=coords, attrs=p.global_attrs)
