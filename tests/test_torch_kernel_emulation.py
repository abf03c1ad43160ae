"""The CUDA sources of K1 (``csrc/remap_apply.cu``) and K4 (the weighted
selection of ``csrc/ktable.cu``) run on the CPU, held against their plain
versions.

There is no CUDA compiler or card where these tests run, and a kernel that
is right on the card is checked there (``-m gpu``).  Here each source is
built with g++ against a small emulation of the CUDA it uses (``EMULATION``
below): a ``std::thread`` per CUDA thread, a ``std::barrier`` per block for
``__syncthreads`` and per warp for ``__syncwarp`` and the shuffles, and each
``kernel<<<grid, block, smem, stream>>>(args)`` rewritten as a call that
runs the grid's blocks one after another.  That runs the kernels' own index
arithmetic, warp layout and tiling, which the plain versions do not share.
"""
import ctypes
import functools
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fv3net_torch.ops import cuda_build, ktable, ktable_cuda
from fv3net_torch.ops import remap as tr

EMULATION = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __launch_bounds__(x)
#define __shared__ static

struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 2; return 0; }
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int, size_t) {
  *v = 1;
  return 0;
}

struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline double2 make_double2(double a, double b) { return {a, b}; }

template <class T> T __ldg(const T* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }

struct EmuWarp {
  std::barrier<> bar{32};
  alignas(8) unsigned char slot[32][8];
};
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
};
inline thread_local EmuWarp* emu_warp = nullptr;
inline thread_local EmuBlock* emu_block = nullptr;
inline thread_local int emu_lane = 0;
alignas(16) inline unsigned char emu_smem[1 << 20];

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp->bar.arrive_and_wait();
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  std::memcpy(emu_warp->slot[emu_lane], &v, sizeof(T));
  emu_warp->bar.arrive_and_wait();
  T r;
  std::memcpy(&r, emu_warp->slot[src & 31], sizeof(T));
  emu_warp->bar.arrive_and_wait();
  return r;
}
template <class T> T __shfl_up_sync(unsigned m, T v, int d) {
  return __shfl_sync(m, v, emu_lane >= d ? emu_lane - d : emu_lane);
}

// Runs fn on every thread of every block, block after block; a thread that
// returns leaves its warp's and its block's barriers.
template <class F>
void emu_launch(unsigned grid, unsigned block, size_t, void*, F fn) {
  gridDim.x = grid;
  blockDim.x = block;
  for (unsigned b = 0; b < grid; ++b) {
    EmuBlock blk;
    blk.bar = std::make_unique<std::barrier<>>(block);
    for (unsigned w = 0; w < (block + 31) / 32; ++w)
      blk.warps.push_back(std::make_unique<EmuWarp>());
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t) {
      threads.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        emu_block = &blk;
        emu_warp = blk.warps[t / 32].get();
        emu_lane = t % 32;
        fn();
        emu_warp->bar.arrive_and_drop();
        emu_block->bar->arrive_and_drop();
      });
    }
    for (auto& th : threads) th.join();
  }
}
"""

DYNAMIC_SMEM = "extern __shared__ __align__(16) unsigned char smem_raw[];"


def _rewrite_launches(src: str) -> str:
    """``name<<<cfg>>>(args);`` -> ``emu_launch(cfg, [&]() { name(args); });``
    and the dynamic shared memory -> the emulation's buffer."""
    out, i = [], 0
    for m in re.finditer(r"<<<", src):
        j = m.start()
        if j < i:
            continue
        k, depth = j, 0
        while k > 0:  # back over the kernel's name and template arguments
            c = src[k - 1]
            depth += {">": 1, "<": -1}.get(c, 0)
            if depth == 0 and c in " \t\n;{}(":
                break
            k -= 1
        e = src.index(">>>", j)
        d, p = 0, e + 3
        while True:  # the balanced argument list
            d += {"(": 1, ")": -1}.get(src[p], 0)
            if d == 0:
                break
            p += 1
        out += [src[i:k], f"emu_launch({src[j + 3:e]}, [&]() {{ "
                f"{src[k:j]}({src[e + 4:p]}); }})"]
        i = p + 1
    out.append(src[i:])
    return "".join(out).replace(DYNAMIC_SMEM,
                                "unsigned char* smem_raw = ::emu_smem;")


@functools.lru_cache(maxsize=None)
def _emulated(source: str, tmp: str) -> ctypes.CDLL:
    from pathlib import Path

    tmp = Path(tmp)
    (tmp / "include").mkdir(exist_ok=True)
    (tmp / "include" / "cuda_runtime.h").write_text(EMULATION)
    cc = tmp / (source + ".cc")
    cc.write_text(_rewrite_launches((cuda_build.CSRC / source).read_text()))
    lib = tmp / f"lib{source}.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-I", str(tmp / "include"), str(cc), "-o", str(lib), "-lpthread"],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources' CPU emulation")
    tmp = str(tmp_path_factory.mktemp("cuda_emulation"))
    return lambda source: _emulated(source, tmp)


def _edges(C, km, seed):
    """Source and target edges of C columns; column 0 reaches below the
    source's surface, column 1 has a target layer of zero thickness."""
    rng = np.random.RandomState(seed)
    pe1 = np.cumsum(np.abs(rng.rand(C, km + 1)) + 1.0, -1) * 300.0
    pe2 = pe1.copy()
    pe2[:, 1:-1] += (0.3 * np.diff(pe1, axis=-1)[:, :-1]
                     * rng.randn(C, km - 1))
    pe2.sort(-1)
    pe2[0, -1] = pe1[0, -1] * 1.02
    pe2[1, 1] = pe2[1, 0]
    return pe1, pe2, rng


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("km,window", [(32, 0), (32, 1), (32, 2), (32, 3),
                                       (33, 2), (79, 2)])
def test_remap_kernel_source_matches_plain(emulated, km, window, dtype):
    """K1 on 3 fields of 6 columns (a block and a part), each of the
    kernel's instances (1, 2 and 4 levels per lane; the window's weights in
    registers or not), against the plain version: within the dtype's
    tolerance of each output's scale, and column mass kept."""
    tdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    rtol = {"float32": 1e-5, "float64": 1e-12}[dtype]
    pe1, pe2, rng = _edges(6, km, km + window)
    s = tr.banded_search(torch.tensor(pe1, dtype=tdt),
                         torch.tensor(pe2, dtype=tdt), window)
    q = torch.tensor(rng.rand(3, 6, km) - 0.3, dtype=tdt)
    al, ar, a6 = [x.contiguous() for x in tr.cs_profile(q, s["dp1"], -1, 9)]
    fn = getattr(emulated("remap_apply.cu"),
                 "fv3_remap_apply_" + ("f32" if dtype == "float32" else "f64"))
    fn.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    got = torch.full_like(q, float("nan"))
    planes = [s[k].contiguous() for k in ("dp1", "w", "p", "pe1", "pe2")]
    err = fn(q.data_ptr(), al.data_ptr(), ar.data_ptr(), a6.data_ptr(),
             *[x.data_ptr() for x in planes], got.data_ptr(), 3, 6, km,
             window, None)
    assert err == 0
    want = tr.remap_apply_plain(s, q, al, ar, a6)
    dp2 = s["pe2"][..., 1:] - s["pe2"][..., :-1]
    scale = (q * s["dp1"]).abs().sum(-1)
    # the layer masses (float32: the prefix sums' roundoff over a thin
    # target layer is large against its value, not against its mass) and,
    # in float64, each value
    assert ((got - want) * dp2).abs().max() <= rtol * scale.max()
    if dtype == "float64":
        assert (got - want).abs().max() <= rtol * want.abs().max()
    # column mass, where the target column spans the source's (not 0)
    m1 = (q * s["dp1"]).sum(-1)[:, 1:]
    m2 = (got * dp2).sum(-1)[:, 1:]
    assert ((m2 - m1).abs() <= rtol * scale[:, 1:]).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("K,G,N", [(1, 1, 13001), (2, 7, 2003),
                                   (4, 54, 1001), (16, 140, 77), (3, 16, 0)])
def test_select_kernel_source_matches_plain(emulated, K, G, N, dtype):
    """K4 over tiles of points (several, the last a part), K terms with
    int32 and int64 ids (out of range too), None weights and a broadcast
    id term, against the plain version."""
    tdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    rtol = {"float32": 2e-6, "float64": 1e-13}[dtype]
    rng = np.random.default_rng(K * 100 + G)
    R = 13
    tab = torch.tensor(rng.standard_normal((R, G)), dtype=tdt)
    terms = []
    for k in range(K):
        ids = torch.tensor(rng.integers(-2, R + 2, N),
                           dtype=torch.int64 if k % 2 else torch.int32)
        w = None if k % 3 == 0 else torch.tensor(rng.random(N), dtype=tdt)
        terms.append((ids, w))
    if K > 1 and N:
        terms[1] = (terms[1][0][:1], terms[1][1])  # broadcast over N
    struct, keep, lead = ktable_cuda.pack_terms(terms, tab)
    fn = getattr(emulated("ktable.cu"), "fv3_ktable_select_"
                 + ("f32" if dtype == "float32" else "f64"))
    fn.argtypes = [ktable_cuda.SelectTerms, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    got = torch.full(lead + (G,), float("nan"), dtype=tdt)
    assert fn(struct, tab.data_ptr(), got.data_ptr(), N, R, G, None) == 0
    want = ktable.weighted_select_dot_plain(terms, tab)
    assert got.shape == want.shape == (N, G)
    if N:
        assert (got - want).abs().max() <= rtol * want.abs().max()
