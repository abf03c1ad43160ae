"""Wrappers of the CUDA k-table selection kernels ``csrc/ktable.cu``.

K4 (:func:`weighted_select_dot_cuda`) replaces the TPU kernel
``fv3net_tpu/ops/pallas_ktable.py::_ktable_kernel`` and K3
(:func:`spec_band_dot_cuda`) replaces ``pallas_ktable.py::_spec_kernel``;
their plain PyTorch versions are in :mod:`fv3net_torch.ops.ktable`, whose
dispatchers call these wrappers on CUDA tensors.

Both take their (ids, weight) terms as the caller holds them: up to
``MAX_TERMS`` pairs, ids int32 or int64, a weight of the table's dtype or
None (weight 1), packed by :func:`pack_terms` into a :class:`SelectTerms`
struct of pointers that the kernel receives by value.  Only a term that is
broadcast or not contiguous is copied.  K3's terms are its paths' base
pairs, then their stencil pairs.

Build: :func:`fv3net_torch.ops.cuda_build.build` compiles the source at
first use (nothing is built when this module is imported).  There is no
fallback: a missing compiler, a failed build or a failed launch raises.

``SELECT_LAUNCHES`` and ``SPEC_LAUNCHES`` count the K4 and K3 launches of
this process; a run resets them to 0 and reads them to show that its
k-table selections went through the kernels.  With ``CHECK_RANGES`` set,
the wrappers also check (with a device synchronisation) that every id, as
the caller passed it, is inside its table; the kernels clamp ids either
way.  The LW gas optics pass some ids outside on purpose and leave them to
that clamp (``lw.py::_weighted_rows``: a lerp's ``index + 1`` past the last
row, rows under the other atmosphere's mask), so with the switch on an LW
radiation call raises ``IndexError``: it is for checking a caller whose
ids all lie inside.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from fv3net_torch.ops import cuda_build
from fv3net_torch.ops.cuda_build import check_tensor

SOURCE = "ktable.cu"
MAX_TERMS = 16  # the (ids, weight) pairs one K4 or K3 call takes
MAX_BASE = 4  # K3's base pairs per path

SELECT_LAUNCHES = 0
SPEC_LAUNCHES = 0
CHECK_RANGES = False

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def build() -> cuda_build.BuildInfo:
    """Compile the kernel library if needed; returns its build info."""
    return cuda_build.build(SOURCE)


class SelectTerms(ctypes.Structure):
    """K4's and K3's terms as the kernels take them (``csrc/ktable.cu``):
    the id and weight pointers of each term (a null weight means 1), their
    count, and a bit per term whose ids are int64 rather than int32."""

    _fields_ = [("ids", ctypes.c_void_p * MAX_TERMS),
                ("w", ctypes.c_void_p * MAX_TERMS),
                ("n_terms", ctypes.c_int),
                ("ids64", ctypes.c_uint)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fv3_ktable_select_{sfx}")
        fn.argtypes = [SelectTerms, ptr, ptr, i64, i32, i32, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"fv3_ktable_spec_{sfx}")
        fn.argtypes = [SelectTerms, ptr, ptr, i64] + [i32] * 6 + [ptr]
        fn.restype = ctypes.c_int
    lib.fv3_ktable_spec_plan.argtypes = (
        [i32] * 3 + [ctypes.POINTER(i32), ctypes.POINTER(i64),
                     ctypes.POINTER(i32)])
    lib.fv3_ktable_spec_plan.restype = ctypes.c_int
    return lib


def _check_table(kernel: str, tab: torch.Tensor):
    if tab.dtype not in _SUFFIX:
        raise TypeError(f"{kernel} kernel takes float32 or float64 tables, "
                        f"got {tab.dtype}")
    if tab.ndim != 2:
        raise ValueError(f"{kernel} kernel: tab must be 2-D, got shape "
                         f"{tuple(tab.shape)}")
    check_tensor(kernel, "tab", tab, tab.shape, tab.dtype, tab.device)


def _check_range(kernel: str, name: str, ids: torch.Tensor, hi: int):
    if CHECK_RANGES and ids.numel():
        lo_v, hi_v = int(ids.min()), int(ids.max())
        if lo_v < 0 or hi_v >= hi:
            raise IndexError(f"{kernel} kernel: {name} spans [{lo_v}, "
                             f"{hi_v}], outside [0, {hi})")


def _raise_on(kernel: str, err: int):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")


def _as_lead(x: torch.Tensor, lead: tuple) -> torch.Tensor:
    """``x`` over ``lead``, copied only if broadcast or not contiguous."""
    if tuple(x.shape) != lead:
        x = x.expand(lead)
    return x if x.is_contiguous() else x.contiguous()


def pack_terms(terms, tab: torch.Tensor, kernel="weighted_select_dot"):
    """K4's (or, as ``kernel`` names it, K3's) terms as a
    :class:`SelectTerms` struct.

    terms: 1 to ``MAX_TERMS`` (ids, w) pairs over one broadcast leading
    shape, on ``tab``'s device; ids int32 or int64, w of ``tab``'s dtype
    or None.  Returns ``(struct, keep, lead)``: ``keep`` holds the tensors
    the struct points into (the caller's own, or a contiguous copy of a
    broadcast or strided one), which must live until the launch is done."""
    K = len(terms)
    if not 1 <= K <= MAX_TERMS:
        raise ValueError(f"{kernel} kernel takes 1 to {MAX_TERMS} terms, "
                         f"got {K}")
    # the host's work here is a fair share of a call: the common case, all
    # terms of one shape, skips torch.broadcast_shapes
    shapes = [x.shape for pair in terms for x in pair if x is not None]
    lead = shapes[0]
    if any(s != lead for s in shapes):
        lead = torch.broadcast_shapes(*shapes)
    lead = tuple(lead)
    device, dtype = tab.device, tab.dtype
    struct = SelectTerms()
    struct.n_terms = K
    keep = []
    for k, (ids, w) in enumerate(terms):
        if ids.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{kernel} kernel: ids of term {k} are "
                            f"{ids.dtype}, not int32 or int64")
        if w is not None and w.dtype != dtype:
            raise TypeError(f"{kernel} kernel: weight of term {k} is "
                            f"{w.dtype}, the table {dtype}")
        for name, x in (("ids", ids), ("weight", w)):
            if x is not None and x.device != device:
                raise ValueError(f"{kernel} kernel: {name} of term {k} is "
                                 f"on {x.device}, the table on {device}")
        ids = _as_lead(ids, lead)
        keep.append(ids)
        struct.ids[k] = ids.data_ptr()
        if ids.dtype == torch.int64:
            struct.ids64 |= 1 << k
        if w is not None:
            w = _as_lead(w, lead)
            keep.append(w)
            struct.w[k] = w.data_ptr()
    return struct, keep, lead


def weighted_select_dot_cuda(terms, tab: torch.Tensor) -> torch.Tensor:
    """K4: ``out[...] = sum_k w_k[...] * tab[ids_k[...]]``.

    terms: (ids, w) pairs as :func:`pack_terms` takes them; tab [R, G]
    float32 or float64, contiguous, on a CUDA device.  Returns
    [*lead, G]."""
    global SELECT_LAUNCHES
    kernel = "weighted_select_dot"
    _check_table(kernel, tab)
    struct, keep, lead = pack_terms(terms, tab)
    R, G = tab.shape
    for k, (ids, _) in enumerate(terms):
        _check_range(kernel, f"ids of term {k}", ids, R)
    out = torch.empty(lead + (G,), dtype=tab.dtype, device=tab.device)
    N = math.prod(lead)
    if N == 0:
        return out
    fn = getattr(_library(), f"fv3_ktable_select_{_SUFFIX[tab.dtype]}")
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = fn(struct, tab.data_ptr(), out.data_ptr(), N, R, G, stream)
    _raise_on(kernel, err)
    SELECT_LAUNCHES += 1
    return out


def pack_spec_terms(w_paths, s_paths, tab: torch.Tensor):
    """K3's terms as a :class:`SelectTerms` struct: the paths' base pairs,
    path-major, then their stencil pairs.

    Every path has the same kw <= ``MAX_BASE`` base pairs and st stencil
    pairs, ``MAX_TERMS`` at most in all, each pair as :func:`pack_terms`
    takes it.  Returns ``(struct, keep, lead, (n_paths, kw, st))``."""
    kernel = "spec_band_dot"
    n_paths = len(w_paths)
    kw = len(w_paths[0]) if n_paths else 0
    st = len(s_paths[0]) if len(s_paths) else 0
    if (n_paths < 1 or len(s_paths) != n_paths or kw < 1 or st < 1
            or any(len(p) != kw for p in w_paths)
            or any(len(p) != st for p in s_paths)):
        raise ValueError(f"{kernel} kernel: every path needs the same "
                         f"number of base pairs and of stencil pairs")
    if kw > MAX_BASE:
        raise ValueError(f"{kernel} kernel takes at most {MAX_BASE} base "
                         f"pairs a path, got {kw}")
    terms = ([pair for p in w_paths for pair in p]
             + [pair for p in s_paths for pair in p])
    struct, keep, lead = pack_terms(terms, tab, kernel)
    return struct, keep, lead, (n_paths, kw, st)


def spec_band_dot_cuda(w_paths, s_paths, tab: torch.Tensor,
                       nspa: int) -> torch.Tensor:
    """K3: the species-interpolated band tau of ``len(w_paths)`` paths.

    w_paths: per path its (base row, weight) pairs; s_paths: per path its
    (stencil position, weight) pairs, as :func:`pack_spec_terms` takes
    them; tab [nbase, nspa*ng] float32 or float64, contiguous, on a CUDA
    device.  Returns [*lead, ng]."""
    global SPEC_LAUNCHES
    kernel = "spec_band_dot"
    _check_table(kernel, tab)
    nbase, width = tab.shape
    if nspa < 1 or width % nspa:
        raise ValueError(f"{kernel} kernel: table width {width} is not a "
                         f"multiple of nspa={nspa}")
    ng = width // nspa
    struct, keep, lead, (n_paths, kw, st) = pack_spec_terms(
        w_paths, s_paths, tab)
    for p, path in enumerate(w_paths):
        for k, (ids, _) in enumerate(path):
            _check_range(kernel, f"base ids {k} of path {p}", ids, nbase)
    for p, path in enumerate(s_paths):
        for k, (ids, _) in enumerate(path):
            _check_range(kernel, f"stencil ids {k} of path {p}", ids, nspa)
    out = torch.empty(lead + (ng,), dtype=tab.dtype, device=tab.device)
    N = math.prod(lead)
    if N == 0:
        return out
    fn = getattr(_library(), f"fv3_ktable_spec_{_SUFFIX[tab.dtype]}")
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = fn(struct, tab.data_ptr(), out.data_ptr(), N, n_paths, kw, st,
                 nbase, nspa, ng, stream)
    _raise_on(kernel, err)
    SPEC_LAUNCHES += 1
    return out


def spec_plan(dtype: torch.dtype, n_terms: int, ng: int) -> dict:
    """How K3 launches on the current card for a call of ``n_terms`` terms
    and ``ng`` outputs a point in ``dtype``: points per tile, a block's
    shared bytes and the blocks an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    P, per_sm, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    err = _library().fv3_ktable_spec_plan(
        int(dtype == torch.float64), n_terms, ng, ctypes.byref(P),
        ctypes.byref(smem), ctypes.byref(per_sm))
    _raise_on("spec_band_dot", err)
    return {"points_per_tile": P.value, "smem_bytes": smem.value,
            "blocks_per_sm": per_sm.value}
