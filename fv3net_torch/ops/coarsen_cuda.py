"""Wrapper of the CUDA weighted block average ``csrc/wavg.cu`` (K5).

K5 replaces the TPU kernel ``fv3net_tpu/ops/pallas_kernels.py::
_wavg_kernel``; its plain PyTorch version is
:func:`fv3net_torch.ops.coarsen.weighted_block_average_plain`, whose
dispatcher calls this wrapper on CUDA tensors.
:func:`weighted_block_average_many_cuda` averages a group of variables
that share one weight tensor in one launch (up to ``MAX_GROUP`` of them;
a single variable is a group of one).

Build: :func:`fv3net_torch.ops.cuda_build.build` compiles the source at
first use.  There is no fallback: a missing compiler, a failed build or a
failed launch raises.  ``WAVG_LAUNCHES`` counts the launches of this
process, from any thread (the surface pipeline launches from a pool), and
``WAVG_INSTANCES`` the launches by instance (``instance_name``).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from fv3net_torch.ops import cuda_build
from fv3net_torch.ops.cuda_build import check_tensor

SOURCE = "wavg.cu"
MAX_FACTOR = 1024  # the generic instance's fine columns in shared memory
MAX_GROUP = 64  # variables of one launch (kMaxVars)

WAVG_LAUNCHES = 0
WAVG_INSTANCES: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def instance_name(code: int) -> str:
    """The instance the library reports: 0 the generic one, else
    ``factor * 10 + V`` (V fine columns a load: 16 bytes, or 1)."""
    if code == 0:
        return "generic"
    return f"f{code // 10}x{code % 10}"


def build() -> cuda_build.BuildInfo:
    """Compile the kernel library if needed; returns its build info."""
    return cuda_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    p64 = ctypes.POINTER(i64)
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fv3_wavg_group_{sfx}")
        fn.argtypes = [ptr, ptr, p64, p64, p64, i32, ptr, i32, i32, i32,
                       ctypes.POINTER(i32), ptr]
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


def group_args(members: Sequence[tuple]):
    """The group's ctypes arguments from its members, each (x, out,
    batches, w_div, w_mod): the x and output pointers and each variable's
    (B, w_div, w_mod), as arrays."""
    n = len(members)
    ptr, i64 = ctypes.c_void_p * n, ctypes.c_longlong * n
    x, out, B, div, mod = zip(*members)
    return (ptr(*[t.data_ptr() for t in x]), ptr(*[t.data_ptr() for t in out]),
            i64(*B), i64(*div), i64(*mod))


def weighted_block_average_many_cuda(xs: Sequence[torch.Tensor],
                                     w: torch.Tensor,
                                     factor: int) -> List[torch.Tensor]:
    """K5 on a group of variables: ``sum(x * w) / sum(w)`` over factor x
    factor blocks of the last two axes of each x, in one launch per
    ``MAX_GROUP`` variables.

    Each x [..., ny, nx] is contiguous, of w's dtype (float32 or float64)
    and on its CUDA device, with its own leading shape; w [..., ny, nx] is
    shared, its leading axes broadcast to each x's and are read in place.
    ny and nx must be multiples of ``factor``.  Returns the averages
    [..., ny // factor, nx // factor], in the order of ``xs``; each equals,
    bit for bit, that variable's average launched alone."""
    global WAVG_LAUNCHES
    kernel = "weighted_block_average"
    if w.dtype not in _SUFFIX:
        raise TypeError(f"{kernel} kernel takes float32 or float64, got "
                        f"{w.dtype}")
    if w.ndim < 2:
        raise ValueError(f"{kernel} kernel: x and w need at least 2 axes")
    ny, nx = w.shape[-2:]
    if not 1 <= factor <= MAX_FACTOR:
        raise ValueError(f"{kernel} kernel: factor {factor} outside "
                         f"[1, {MAX_FACTOR}]")
    if ny % factor or nx % factor:
        raise ValueError(f"spatial shape ({ny},{nx}) not divisible by "
                         f"factor {factor}")
    check_tensor(kernel, "w", w, w.shape, w.dtype, w.device)
    lead_w = tuple(w.shape[:-2])
    # (variables, their weights): the shared weight in groups of
    # MAX_GROUP; a variable whose weight has no (div, mod) form alone,
    # with one weight plane per batch
    shared, groups, outs = [], [], []
    for k, x in enumerate(xs):
        if x.ndim < 2:
            raise ValueError(f"{kernel} kernel: x and w need at least 2 "
                             "axes")
        lead = tuple(x.shape[:-2])
        check_tensor(kernel, f"x[{k}]", x, lead + (ny, nx), w.dtype,
                     w.device)
        out = torch.empty(lead + (ny // factor, nx // factor),
                          dtype=w.dtype, device=w.device)
        outs.append(out)
        batches = weight_batches(lead, lead_w)
        if batches is None:
            groups.append(([(x, out, math.prod(lead), 1, math.prod(lead))],
                           w.expand(x.shape).contiguous()))
        else:
            shared.append((x, out, math.prod(lead)) + batches)
    groups[:0] = [(shared[i:i + MAX_GROUP], w)
                  for i in range(0, len(shared), MAX_GROUP)]
    fn = getattr(_library(), f"fv3_wavg_group_{_SUFFIX[w.dtype]}")
    chosen = ctypes.c_int(-1)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        for members, gw in groups:
            err = fn(*group_args(members), len(members), gw.data_ptr(), ny,
                     nx, factor, ctypes.byref(chosen), stream)
            if err != 0:
                raise RuntimeError(f"{kernel} kernel launch failed: "
                                   f"cudaError {err}")
            with _COUNT_LOCK:
                WAVG_LAUNCHES += 1
                WAVG_INSTANCES[instance_name(chosen.value)] += 1
    return outs
