"""Native (C++) host components, loaded with ctypes (port of
``fv3net_tpu/native/__init__.py``).

The threaded zarr chunk reader and writer of ``chunkio.cpp``: the read
and write paths of :mod:`fv3net_torch.core.zarrio` for stores of more
than one chunk.  At first use, ``g++`` builds the library into
``fv3net_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and flags; nothing is built next to the source.  Where the
compiler or zlib is missing, the callers take the Python path, as the
reference's do.  ``COUNTS`` counts the calls that went through the
library (``reads`` and ``writes``) and the chunks they moved.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "chunkio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")

#: calls that went through the native library, and the chunks they moved
COUNTS = {"reads": 0, "writes": 0, "read_chunks": 0, "written_chunks": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    flags = " ".join(GXX_FLAGS + LIBS).encode()
    digest = hashlib.sha256(SOURCE.read_bytes() + flags).hexdigest()
    return BUILD_DIR / f"libchunkio_{digest[:16]}.so"


def _build(path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    os.replace(tmp, path)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The chunkio library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.assemble_chunks.restype = ctypes.c_int
        lib.assemble_chunks.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int,  # n_chunks
            ctypes.POINTER(ctypes.c_int64),  # chunk_starts
            ctypes.POINTER(ctypes.c_int64),  # chunk_shape
            ctypes.POINTER(ctypes.c_int64),  # out_shape
            ctypes.c_int,  # ndim
            ctypes.c_int,  # compressed
            ctypes.c_double,  # fill_value
            ctypes.c_int,  # itemsize
            ctypes.c_int,  # is_float
            ctypes.c_char_p,  # out buffer
            ctypes.c_int,  # n_threads
        ]
        lib.write_chunks.restype = ctypes.c_int
        lib.write_chunks.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int,  # n_chunks
            ctypes.POINTER(ctypes.c_char_p),  # buffers
            ctypes.POINTER(ctypes.c_int64),  # nbytes
            ctypes.c_int,  # compress_level
            ctypes.c_int,  # n_threads
        ]
        _lib = lib
        return _lib


def _count(kind: str, chunks_key: str, n: int) -> None:
    with _lock:
        COUNTS[kind] += 1
        COUNTS[chunks_key] += n


def reset_counts() -> None:
    with _lock:
        for k in COUNTS:
            COUNTS[k] = 0


def assemble_chunks(
    paths: Sequence[Optional[str]],
    chunk_starts: np.ndarray,  # [n_chunks, ndim] element offsets
    chunk_shape: Sequence[int],
    out_shape: Sequence[int],
    compressed: bool,
    fill_value: float,
    dtype: np.dtype,
    n_threads: int = 8,
) -> Optional[np.ndarray]:
    """Read + decompress + assemble chunks into one array using the
    native thread pool; None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    dtype = np.dtype(dtype)
    out = np.empty(tuple(out_shape), dtype)
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(
        *[p.encode() if p is not None else None for p in paths]
    )
    starts = np.ascontiguousarray(chunk_starts, np.int64)
    cshape = np.ascontiguousarray(chunk_shape, np.int64)
    oshape = np.ascontiguousarray(out_shape, np.int64)
    fv = fill_value
    if fv is None or (isinstance(fv, float) and np.isnan(fv)):
        fv = np.nan if np.issubdtype(dtype, np.floating) else 0.0
    rc = lib.assemble_chunks(
        c_paths,
        n,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cshape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        oshape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(out_shape),
        int(compressed),
        float(fv),
        dtype.itemsize,
        int(np.issubdtype(dtype, np.floating)),
        out.ctypes.data_as(ctypes.c_char_p),
        n_threads,
    )
    if rc != 0:
        return None
    _count("reads", "read_chunks", n)
    return out


def write_chunks(
    paths: Sequence[str],
    buffers: Sequence[np.ndarray],
    compress_level: int = 0,
    n_threads: int = 8,
) -> bool:
    """Deflate + write chunk files with the native thread pool (atomic
    via tmp+rename).  False if the native library is unavailable or any
    chunk failed: callers fall back to the Python writer."""
    lib = get_lib()
    if lib is None:
        return False
    n = len(paths)
    arrs = [np.ascontiguousarray(b) for b in buffers]
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    # cast raw addresses (NOT .value, which would copy to the first NUL)
    c_bufs = (ctypes.c_char_p * n)()
    for i, a in enumerate(arrs):
        c_bufs[i] = ctypes.cast(a.ctypes.data, ctypes.c_char_p)
    nbytes = np.asarray([a.nbytes for a in arrs], np.int64)
    rc = lib.write_chunks(
        c_paths,
        n,
        c_bufs,
        nbytes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(compress_level),
        n_threads,
    )
    if rc != 0:
        return False
    _count("writes", "written_chunks", n)
    return True
