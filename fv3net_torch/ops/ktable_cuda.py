"""Wrappers of the CUDA k-table selection kernels ``csrc/ktable.cu``.

K4 (:func:`weighted_select_dot_cuda`) replaces the TPU kernel
``fv3net_tpu/ops/pallas_ktable.py::_ktable_kernel`` and K3
(:func:`spec_band_dot_cuda`) replaces ``pallas_ktable.py::_spec_kernel``;
their plain PyTorch versions are in :mod:`fv3net_torch.ops.ktable`, whose
dispatchers call these wrappers on CUDA tensors.

K4 takes its (ids, weight) terms as the caller holds them: up to
``MAX_TERMS`` pairs, ids int32 or int64, a weight of the table's dtype or
None (weight 1), packed by :func:`pack_terms` into a :class:`SelectTerms`
struct of pointers that the kernel receives by value.  Only a term that is
broadcast or not contiguous is copied.

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
SMEM_MAX = 232448  # bytes of shared memory a block may opt in to (H100)
MAX_TERMS = 16  # the (ids, weight) pairs one K4 call takes

SELECT_LAUNCHES = 0
SPEC_LAUNCHES = 0
CHECK_RANGES = False

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def build() -> cuda_build.BuildInfo:
    """Compile the kernel library if needed; returns its build info."""
    return cuda_build.build(SOURCE)


class SelectTerms(ctypes.Structure):
    """K4's terms as the kernel takes them (``csrc/ktable.cu``): the id and
    weight pointers of each term (a null weight means 1), their count, and
    a bit per term whose ids are int64 rather than int32."""

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
        fn.argtypes = [ptr] * 6 + [i64] + [i32] * 6 + [ptr]
        fn.restype = ctypes.c_int
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


def pack_terms(terms, tab: torch.Tensor):
    """K4's terms as a :class:`SelectTerms` struct.

    terms: 1 to ``MAX_TERMS`` (ids, w) pairs over one broadcast leading
    shape, on ``tab``'s device; ids int32 or int64, w of ``tab``'s dtype
    or None.  Returns ``(struct, keep, lead)``: ``keep`` holds the tensors
    the struct points into (the caller's own, or a contiguous copy of a
    broadcast or strided one), which must live until the launch is done."""
    K = len(terms)
    if not 1 <= K <= MAX_TERMS:
        raise ValueError(f"weighted_select_dot kernel takes 1 to "
                         f"{MAX_TERMS} terms, got {K}")
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
            raise TypeError(f"weighted_select_dot kernel: ids of term {k} "
                            f"are {ids.dtype}, not int32 or int64")
        if w is not None and w.dtype != dtype:
            raise TypeError(f"weighted_select_dot kernel: weight of term {k} "
                            f"is {w.dtype}, the table {dtype}")
        for name, x in (("ids", ids), ("weight", w)):
            if x is not None and x.device != device:
                raise ValueError(f"weighted_select_dot kernel: {name} of "
                                 f"term {k} is on {x.device}, the table on "
                                 f"{device}")
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


def spec_band_dot_cuda(wids: torch.Tensor, ww: torch.Tensor,
                       sids: torch.Tensor, sw: torch.Tensor,
                       tab: torch.Tensor, n_paths: int,
                       nspa: int) -> torch.Tensor:
    """K3: the species-interpolated band tau of ``n_paths`` paths.

    wids int32 / ww [n_paths*kw, N]: the (base row, weight) pairs of each
    path, path-major; sids int32 / sw [n_paths*st, N]: its (stencil
    position, weight) pairs; tab [nbase, nspa*ng].  Returns [N, ng]."""
    global SPEC_LAUNCHES
    kernel = "spec_band_dot"
    _check_table(kernel, tab)
    if wids.ndim != 2 or sids.ndim != 2:
        raise ValueError(f"{kernel} kernel: ids must be 2-D")
    nbase, width = tab.shape
    if nspa < 1 or width % nspa:
        raise ValueError(f"{kernel} kernel: table width {width} is not a "
                         f"multiple of nspa={nspa}")
    ng = width // nspa
    n_w, N = wids.shape
    n_s = sids.shape[0]
    if n_paths < 1 or n_w % n_paths or n_s % n_paths:
        raise ValueError(f"{kernel} kernel: {n_w} base and {n_s} stencil "
                         f"rows do not split into {n_paths} paths")
    if tab.numel() * tab.element_size() > SMEM_MAX:
        raise ValueError(f"{kernel} kernel: table of "
                         f"{tab.numel() * tab.element_size()} bytes exceeds "
                         f"shared memory ({SMEM_MAX})")
    check_tensor(kernel, "wids", wids, (n_w, N), torch.int32, tab.device)
    check_tensor(kernel, "ww", ww, (n_w, N), tab.dtype, tab.device)
    check_tensor(kernel, "sids", sids, (n_s, N), torch.int32, tab.device)
    check_tensor(kernel, "sw", sw, (n_s, N), tab.dtype, tab.device)
    _check_range(kernel, "wids", wids, nbase)
    _check_range(kernel, "sids", sids, nspa)
    out = torch.empty((N, ng), dtype=tab.dtype, device=tab.device)
    fn = getattr(_library(), f"fv3_ktable_spec_{_SUFFIX[tab.dtype]}")
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = fn(wids.data_ptr(), ww.data_ptr(), sids.data_ptr(),
                 sw.data_ptr(), tab.data_ptr(), out.data_ptr(), N, n_paths,
                 n_w // n_paths, n_s // n_paths, nbase, nspa, ng, stream)
    _raise_on(kernel, err)
    SPEC_LAUNCHES += 1
    return out
