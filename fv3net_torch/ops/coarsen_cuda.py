"""Wrapper of the CUDA weighted block average ``csrc/wavg.cu`` (K5).

K5 replaces the TPU kernel ``fv3net_tpu/ops/pallas_kernels.py::
_wavg_kernel``; its plain PyTorch version is
:func:`fv3net_torch.ops.coarsen.weighted_block_average_plain`, whose
dispatcher calls this wrapper on CUDA tensors.

Build: :func:`fv3net_torch.ops.cuda_build.build` compiles the source at
first use.  There is no fallback: a missing compiler, a failed build or a
failed launch raises.  ``WAVG_LAUNCHES`` counts the launches of this
process, from any thread (the surface pipeline launches from a pool).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from fv3net_torch.ops import cuda_build
from fv3net_torch.ops.cuda_build import check_tensor

SOURCE = "wavg.cu"
MAX_FACTOR = 1024  # fine columns a block holds in shared memory

WAVG_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def build() -> cuda_build.BuildInfo:
    """Compile the kernel library if needed; returns its build info."""
    return cuda_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fv3_wavg_{sfx}")
        fn.argtypes = [ptr] * 3 + [i64, i32, i32, i32, i64, i64, ptr]
        fn.restype = ctypes.c_int
    return lib


def weight_batches(lead: Tuple[int, ...],
                   w_lead: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
    """How a weight of leading shape ``w_lead`` broadcasts over x's leading
    shape ``lead``: ``(div, mod)`` such that the flattened batch ``b`` of x
    reads weight plane ``(b // div) % mod``, or None where no such pair
    exists (a broadcast axis between two full ones)."""
    if len(w_lead) > len(lead):
        raise ValueError(f"weights' leading shape {w_lead} has more axes "
                         f"than x's {lead}")
    w_lead = (1,) * (len(lead) - len(w_lead)) + tuple(w_lead)
    for n, m in zip(lead, w_lead):
        if m not in (1, n):
            raise ValueError(f"weights' leading shape {w_lead} does not "
                             f"broadcast to x's {lead}")
    full = [i for i, m in enumerate(w_lead) if m != 1]
    if not full:
        return 1, 1
    lo, hi = full[0], full[-1]
    if any(w_lead[i] != lead[i] for i in range(lo, hi + 1)):
        return None
    return math.prod(lead[hi + 1:]), math.prod(lead[lo:hi + 1])


def weighted_block_average_cuda(x: torch.Tensor, w: torch.Tensor,
                                factor: int) -> torch.Tensor:
    """K5: ``sum(x * w) / sum(w)`` over factor x factor blocks of the last
    two axes.

    x [..., ny, nx] and w [..., ny, nx] of one dtype (float32 or float64),
    contiguous on one CUDA device; w's leading axes broadcast to x's and
    are read in place.  ny and nx must be multiples of ``factor``.
    Returns [..., ny // factor, nx // factor]."""
    global WAVG_LAUNCHES
    kernel = "weighted_block_average"
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{kernel} kernel takes float32 or float64, got "
                        f"{x.dtype}")
    if x.ndim < 2 or w.ndim < 2:
        raise ValueError(f"{kernel} kernel: x and w need at least 2 axes")
    lead, (ny, nx) = tuple(x.shape[:-2]), x.shape[-2:]
    if not 1 <= factor <= MAX_FACTOR:
        raise ValueError(f"{kernel} kernel: factor {factor} outside "
                         f"[1, {MAX_FACTOR}]")
    if ny % factor or nx % factor:
        raise ValueError(f"spatial shape ({ny},{nx}) not divisible by "
                         f"factor {factor}")
    batches = weight_batches(lead, tuple(w.shape[:-2]))
    if batches is None:  # no (div, mod) form: one weight plane per batch
        w = w.expand(lead + (ny, nx)).contiguous()
        batches = (1, math.prod(lead))
    check_tensor(kernel, "x", x, x.shape, x.dtype, x.device)
    check_tensor(kernel, "w", w, tuple(w.shape[:-2]) + (ny, nx), x.dtype,
                 x.device)
    out = torch.empty(lead + (ny // factor, nx // factor), dtype=x.dtype,
                      device=x.device)
    fn = getattr(_library(), f"fv3_wavg_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 math.prod(lead), ny, nx, factor, batches[0], batches[1],
                 stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    with _COUNT_LOCK:
        WAVG_LAUNCHES += 1
    return out
