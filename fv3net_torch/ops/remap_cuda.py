"""Wrapper of the CUDA remap-application kernel ``csrc/remap_apply.cu``.

The kernel replaces the TPU kernel ``fv3net_tpu/ops/pallas_remap.py::
_kernel``; its plain PyTorch version is
:func:`fv3net_torch.ops.remap.remap_apply_plain`.  It runs a warp per
column (lane j holds levels j, j+32, ...) and walks all of a call's
fields with the column's search planes read once, so one call on a stack
of F fields costs far less than F calls.

Build: :func:`fv3net_torch.ops.cuda_build.build` compiles the source at
first use (nothing is built when this module is imported).  There is no
fallback: a missing compiler, a failed build or a failed launch raises.

``LAUNCHES`` counts the kernel launches of this process; a run resets it
to 0 and reads it to show that its remaps went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from fv3net_torch.ops import cuda_build
from fv3net_torch.ops.cuda_build import check_tensor

SOURCE = "remap_apply.cu"
KM_MAX = 128  # 4 levels per lane, the largest bucket compiled

LAUNCHES = 0


def build() -> cuda_build.BuildInfo:
    """Compile the kernel library if needed; returns its build info."""
    return cuda_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    for name in ("fv3_remap_apply_f32", "fv3_remap_apply_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


_ENTRY = {torch.float32: "fv3_remap_apply_f32",
          torch.float64: "fv3_remap_apply_f64"}


def _check(name: str, x: torch.Tensor, shape, dtype, device):
    check_tensor("remap", name, x, shape, dtype, device)


def remap_apply_cuda(search, q1, al, ar, a6) -> torch.Tensor:
    """Launch the kernel on ``search`` (from ``banded_search``) and the
    profile tables of ``q1``; returns q2 with ``q1``'s shape.

    All tensors must be contiguous CUDA tensors of one dtype, float32 or
    float64; ``q1``/``al``/``ar``/``a6`` are (..., km) or (F, ..., km)
    over the search's leading shape.
    """
    global LAUNCHES
    if q1.dtype not in _ENTRY:
        raise TypeError(f"remap kernel takes float32 or float64, got "
                        f"{q1.dtype}")
    if not q1.is_cuda:
        raise ValueError(f"remap kernel needs CUDA tensors, got device "
                         f"{q1.device}")
    dtype, device = q1.dtype, q1.device
    p = search["p"]
    lead = tuple(p.shape[:-1])
    kn1 = p.shape[-1]
    km = kn1 - 1
    n_off = 2 * search["window"] + 1
    if km > KM_MAX:
        raise ValueError(f"remap kernel supports km <= {KM_MAX}, got {km}")
    if tuple(q1.shape[q1.ndim - len(lead) - 1:]) != lead + (km,):
        raise ValueError(f"remap kernel: field shape {tuple(q1.shape)} "
                         f"does not end in {lead + (km,)}")
    n_fields = 1
    for s in q1.shape[: q1.ndim - len(lead) - 1]:
        n_fields *= s
    n_cols = 1
    for s in lead:
        n_cols *= s
    for name, x in (("q1", q1), ("al", al), ("ar", ar), ("a6", a6)):
        _check(name, x, q1.shape, dtype, device)
    _check("dp1", search["dp1"], lead + (km,), dtype, device)
    _check("w", search["w"], lead + (n_off, 4, kn1), dtype, device)
    for name in ("p", "pe1", "pe2"):
        _check(name, search[name], lead + (kn1,), dtype, device)

    out = torch.empty_like(q1)
    fn = getattr(_library(), _ENTRY[dtype])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            q1.data_ptr(), al.data_ptr(), ar.data_ptr(), a6.data_ptr(),
            search["dp1"].data_ptr(), search["w"].data_ptr(),
            p.data_ptr(), search["pe1"].data_ptr(),
            search["pe2"].data_ptr(), out.data_ptr(),
            n_fields, n_cols, km, search["window"], stream,
        )
    if err != 0:
        raise RuntimeError(f"remap kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
