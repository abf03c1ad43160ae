"""Builds the port's CUDA sources (``fv3net_torch/csrc/*.cu``) into shared
libraries with a plain C interface, loaded with ``ctypes``.

At first use, ``nvcc`` compiles a source for ``sm_90a`` into
``fv3net_torch/_build/`` (listed in ``.gitignore``), named by a hash of the
source and flags.  Nothing is built when a module is imported, and there
is no fallback: a missing compiler or a failed build raises.  Builds of
different sources may run at the same time (one thread each).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """What :func:`build` did: the library path, the seconds the compile
    took (0.0 when a library of the same hash was already there) and the
    compiler's output (``-Xptxas -v``: registers, local memory, spills)."""

    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin); the "
        "kernels are built from fv3net_torch/csrc on the machine with the "
        "card"
    )


@functools.lru_cache(maxsize=None)
def build(source_name: str, extra_flags: tuple = ()) -> BuildInfo:
    """Compile ``csrc/<source_name>`` if needed, with ``extra_flags`` after
    the common ones; returns its :class:`BuildInfo`."""
    source = CSRC / source_name
    src = source.read_bytes()
    flags = NVCC_FLAGS + tuple(extra_flags)
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    path = BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"
    if path.exists():
        return BuildInfo(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return BuildInfo(path, seconds, proc.stdout + proc.stderr)


def check_tensor(kernel: str, name: str, x, shape, dtype, device):
    """Raise unless ``x`` is a contiguous CUDA tensor of ``shape`` and
    ``dtype`` on ``device``."""
    if not x.is_cuda:
        raise ValueError(f"{kernel} kernel: {name} must be a CUDA tensor, "
                         f"got device {x.device}")
    if x.device != device:
        raise ValueError(f"{kernel} kernel: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel} kernel: {name} has dtype {x.dtype}, "
                        f"expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel} kernel: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} must be contiguous")
