"""The CUDA sources of K1 (``csrc/remap_apply.cu``), K4 and K3 (the
weighted selection and the species-interpolated band tau of
``csrc/ktable.cu``), K2 (``csrc/taumol_lw.cu``) and K5 (the weighted
block average of ``csrc/wavg.cu``) run on the CPU, held against their
plain versions.

There is no CUDA compiler or card where these tests run, and a kernel that
is right on the card is checked there (``-m gpu``).  Here each source is
built with g++ against a small emulation of the CUDA it uses (``EMULATION``
below): a ``std::thread`` per CUDA thread, a ``std::barrier`` per block for
``__syncthreads`` and per warp for ``__syncwarp`` and the shuffles, and each
``kernel<<<grid, block, smem, stream>>>(args)`` rewritten as a call that
runs the grid's blocks one after another.  That runs the kernels' own index
arithmetic, warp layout and tiling, which the plain versions do not share:
K3's tiles of points in persistent blocks with two outputs a thread, K2's
tiles with their output rows in shared
memory, its band groups between barriers and its 16-byte stores.  (K2
stores its rows with plain vector stores, so the emulation needs no
stand-in for a bulk copy.)  ``BF16_EMULATION`` stands in for
``cuda_bf16.h``: a 16-bit ``__nv_bfloat16`` and its pair, float
conversions that round to nearest even, and the rounded float multiply
and add, so that K4's and K3's bfloat16 instances build and run here too.
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
from torch_port_util import column_state

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
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16,
       cudaDevAttrMaxSharedMemoryPerMultiprocessor = 81,
       cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline int cudaGetLastError() { return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
// two SMs with an H100's shared memory
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerMultiprocessor ? 233472
       : attr == cudaDevAttrMaxSharedMemoryPerBlockOptin   ? 232448
                                                           : 2;
  return 0;
}
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int, size_t) {
  *v = 1;
  return 0;
}

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct double2 { double x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
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

BF16_EMULATION = r"""
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { unsigned short bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };

inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// round to nearest, ties to even (NaN kept quiet)
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return {(unsigned short)((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
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
def _emulated(source: str, tmp: str, flags: tuple = ()) -> ctypes.CDLL:
    from pathlib import Path

    tmp = Path(tmp)
    (tmp / "include").mkdir(exist_ok=True)
    (tmp / "include" / "cuda_runtime.h").write_text(EMULATION)
    (tmp / "include" / "cuda_bf16.h").write_text(BF16_EMULATION)
    cc = tmp / (source + ".cc")
    cc.write_text(_rewrite_launches((cuda_build.CSRC / source).read_text()))
    lib = tmp / f"lib{source}.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         *flags, "-I", str(tmp / "include"), str(cc), "-o", str(lib),
         "-lpthread"],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources' CPU emulation")
    tmp = str(tmp_path_factory.mktemp("cuda_emulation"))
    return lambda source, *flags: _emulated(source, tmp, flags)


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


TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64,
               "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("K,G,N", [(1, 1, 13001), (2, 7, 2003),
                                   (4, 54, 1001), (16, 140, 77), (3, 16, 0)])
def test_select_kernel_source_matches_plain(emulated, K, G, N, dtype):
    """K4 over tiles of points (several, the last a part), K terms with
    int32 and int64 ids (out of range too), None weights and a broadcast
    id term, against the plain version; the bfloat16 instance bit for
    bit."""
    tdt = TORCH_DTYPE[dtype]
    rtol = {"float32": 2e-6, "float64": 1e-13, "bfloat16": 0.0}[dtype]
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
                 + ktable_cuda._SUFFIX[tdt])
    fn.argtypes = [ktable_cuda.SelectTerms, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    got = torch.full(lead + (G,), float("nan"), dtype=tdt)
    assert fn(struct, tab.data_ptr(), got.data_ptr(), N, R, G, None) == 0
    want = ktable.weighted_select_dot_plain(terms, tab)
    assert got.shape == want.shape == (N, G)
    assert got.dtype == want.dtype == tdt
    if N and dtype == "bfloat16":
        assert torch.equal(got, want)
    elif N:
        assert (got - want).abs().max() <= rtol * want.abs().max()


# (n_paths, kw, st, nbase, nspa, ng, N): LW band 3 lower (the main path's
# kernel-line call), LW band 3 upper (the largest table, 236 x 80), an SW
# upper band, ng 2 (a tile of many points), an odd ng (one output a
# thread), and no points; N is off any multiple of the tile
K3_EMULATION_CASES = [(2, 2, 3, 70, 9, 16, 700), (2, 2, 2, 236, 5, 16, 300),
                      (1, 4, 2, 236, 5, 12, 517), (1, 4, 2, 70, 9, 2, 2100),
                      (3, 1, 1, 10, 3, 5, 97), (1, 2, 2, 7, 3, 4, 0)]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("case", K3_EMULATION_CASES)
def test_spec_kernel_source_matches_plain(emulated, case, dtype, offset):
    """K3 over persistent blocks walking tiles of points (the last a
    part), its terms by pointer with int32 and int64 ids (out of range
    too), a weight of 1 (None) and a broadcast term, two outputs a thread
    (even ng, an aligned table) or one (odd ng, or a table one value past
    an aligned address), against the plain version; the bfloat16
    instance bit for bit."""
    n_paths, kw, st, nbase, nspa, ng, N = case
    tdt = TORCH_DTYPE[dtype]
    rtol = {"float32": 2e-6, "float64": 1e-13, "bfloat16": 0.0}[dtype]
    rng = np.random.default_rng(sum(case))
    buf = torch.tensor(rng.random(offset + nbase * nspa * ng), dtype=tdt)
    tab = buf[offset:].view(nbase, nspa * ng)

    def pairs(hi, n, scale, k0):
        out = []
        for k in range(k0, k0 + n):
            ids = torch.tensor(rng.integers(-2, hi + 2, N),
                               dtype=torch.int64 if k % 2 else torch.int32)
            w = (None if k % 5 == 1 else
                 torch.tensor(scale * rng.random(N), dtype=tdt))
            out.append((ids, w))
        return out

    w_paths = [pairs(nbase, kw, 1.0, p * kw) for p in range(n_paths)]
    s_paths = [pairs(nspa, st, 1e3, 7 + p * st) for p in range(n_paths)]
    if N:
        w_paths[0][0] = (w_paths[0][0][0][:1], w_paths[0][0][1])  # broadcast
    terms = ([t for p in w_paths for t in p] + [t for p in s_paths for t in p])
    struct, keep, lead = ktable_cuda.pack_terms(terms, tab, "spec_band_dot")
    lib = emulated("ktable.cu")
    fn = getattr(lib, "fv3_ktable_spec_" + ktable_cuda._SUFFIX[tdt])
    fn.argtypes = [ktable_cuda.SelectTerms, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    # a bfloat16 table's band tau comes back in float32
    out_dt = torch.float32 if tdt == torch.bfloat16 else tdt
    got = torch.full(lead + (ng,), float("nan"), dtype=out_dt)
    assert fn(struct, tab.data_ptr(), got.data_ptr(), N, n_paths, kw, st,
              nbase, nspa, ng, None) == 0
    want = ktable.spec_band_dot_plain(w_paths, s_paths, tab, nspa)
    assert got.shape == want.shape == (N, ng)
    assert got.dtype == want.dtype == out_dt
    if N and dtype == "bfloat16":
        assert torch.equal(got, want)
    elif N:
        assert (got - want).abs().max() <= rtol * want.abs().max()
    # the launch plan: about 4,096 outputs a tile, the pairs within 48 KB
    i32 = ctypes.c_int
    P, per_sm, smem = i32(), i32(), ctypes.c_longlong()
    assert lib.fv3_ktable_spec_plan(
        ktable_cuda._PLAN_CODE[tdt], len(terms), ng, ctypes.byref(P),
        ctypes.byref(smem), ctypes.byref(per_sm)) == 0
    pair = 16 if dtype == "float64" else 8  # a bfloat16 weight as float
    assert P.value == min(-(-4096 // ng), 48 * 1024 // (len(terms) * pair))
    assert smem.value == len(terms) * P.value * pair


@functools.lru_cache(maxsize=None)
def _taumol_args(dtype, storage=None):
    """The arguments one RRTMG call on the CPU hands to its LW gas optics,
    on 3 seeded columns of 32 levels (``storage`` its RRTMGConfig's
    storage_dtype)."""
    import datetime

    from fv3net_torch.physics.radiation.rrtmg import driver as tdrv
    from fv3net_torch.physics.radiation.rrtmg import lw as tlw

    tdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    state, cosz = column_state(3, 32)
    seen = []
    orig = tlw.taumol_lw_mega

    def wrapped(*args):
        seen.append(args[:7])
        return orig(*args)

    tlw.taumol_lw_mega = wrapped
    try:
        tdrv.RRTMGDriver(tdrv.RRTMGConfig(storage_dtype=storage), dtype=tdt,
                         device="cpu", lw_taumol="mega")(
            datetime.datetime(2016, 7, 1),
            {k: torch.tensor(v, dtype=tdt) for k, v in state.items()},
            cosz=torch.tensor(cosz, dtype=tdt))
    finally:
        tlw.taumol_lw_mega = orig
    return seen[0]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_taumol_kernel_source_matches_plain(emulated, dtype):
    """K2 itself (its tiles of points with the output rows in shared
    memory, its band groups between barriers, its persistent blocks and
    16-byte stores) on 2.5 columns whose levels straddle the tropopause, so
    that each tile holds both atmospheres and the last is a part, against
    ``taumol_lw_plain``: within 2e-6 (float32) and 1e-12 (float64) of each
    output's scale and value by value, the Planck fractions equal."""
    from fv3net_torch.physics.radiation.rrtmg import lw as tlw
    from fv3net_torch.physics.radiation.rrtmg import params as P
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda as tc

    rtol = {"float32": 2e-6, "float64": 1e-12}[dtype]
    value_rtol = {"float32": 2e-6, "float64": 1e-13}[dtype]
    args = _taumol_args(dtype)
    c = args[0]
    N = 80  # 2.5 columns of 32 levels: tiles of 32 points
    tropo = c["tropo"].reshape(-1)[:N]
    assert tropo[:32].any() and (~tropo[:32]).any()
    flat, meta, _ = tc.pack_tables(args[6])
    planes, keep = tc.pack_planes(*args[:6], flat)
    lib = emulated("taumol_lw.cu", "-D__CUDACC__")
    fn = getattr(lib, "fv3_taumol_lw_" + ("f32" if dtype == "float32"
                                           else "f64"))
    fn.argtypes = [tc.Planes] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_double, ctypes.c_void_p]
    shape = tuple(args[2].shape) + (P.NGPT_LW,)
    fracs = torch.full(shape, float("nan"), dtype=flat.dtype)
    tautot = torch.full_like(fracs, float("nan"))
    assert fn(planes, flat.data_ptr(), meta.data_ptr(), fracs.data_ptr(),
              tautot.data_ptr(), N, float(P.ONEMINUS), None) == 0
    want = tlw.taumol_lw_plain(*args)
    for g, w, name in zip((fracs, tautot), want, ("fracs", "tautot")):
        g, w = g.reshape(-1, P.NGPT_LW), w.reshape(-1, P.NGPT_LW)
        assert torch.isnan(g[N:]).all(), name  # nothing past the N points
        g, w = g[:N], w[:N]
        assert torch.isfinite(g).all() and torch.isfinite(w).all()
        err = (g - w).abs().max().item()
        assert err <= rtol * w.abs().max().item(), (name, err)
        assert ((g - w).abs() <= value_rtol * w.abs()).all(), name
    assert torch.equal(fracs.reshape(-1, P.NGPT_LW)[:N],
                       want[0].reshape(-1, P.NGPT_LW)[:N])


def test_taumol_bf16_kernel_source_matches_plain(emulated):
    """K2's bfloat16 instance (the RRTMG bf16 storage mode: float32 and
    bfloat16 tables, the aerosol taus a bfloat16 plane, bfloat16 outputs
    through its 8-value stores and the odd tile's scalar tail) on 2.5
    columns, against ``taumol_lw_plain`` under bfloat16 storage.  The
    kernel takes the plain version's operations in its order, so the
    outputs are equal bit for bit (tolerance 0)."""
    from fv3net_torch.physics.radiation.rrtmg import lw as tlw
    from fv3net_torch.physics.radiation.rrtmg import params as P
    from fv3net_torch.physics.radiation.rrtmg import taumol_cuda as tc

    args = _taumol_args("float32", "bfloat16")
    assert args[5].dtype == torch.bfloat16  # the aerosol taus
    N = 80  # 2.5 columns of 32 levels: tiles of 32 points
    flat, meta, _ = tc.pack_tables(args[6])
    flat_bf16 = tc.stored_flat(args[6])
    assert torch.equal(flat_bf16, flat.to(torch.bfloat16))
    planes, keep = tc.pack_planes(*args[:6], flat)
    assert list(planes.fw) == [4] * 37 + [2] * 16
    lib = emulated("taumol_lw.cu", "-D__CUDACC__")
    fn = lib.fv3_taumol_lw_bf16
    fn.argtypes = [tc.Planes] + [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_double, ctypes.c_void_p]
    shape = tuple(args[2].shape) + (P.NGPT_LW,)
    fracs = torch.full(shape, float("nan"), dtype=torch.bfloat16)
    tautot = torch.full_like(fracs, float("nan"))
    assert fn(planes, flat.data_ptr(), flat_bf16.data_ptr(), meta.data_ptr(),
              fracs.data_ptr(), tautot.data_ptr(), N, float(P.ONEMINUS),
              None) == 0
    want = tlw.taumol_lw_plain(*args, storage=torch.bfloat16)
    for g, w, name in zip((fracs, tautot), want, ("fracs", "tautot")):
        assert w.dtype == torch.bfloat16
        g, w = g.reshape(-1, P.NGPT_LW), w.reshape(-1, P.NGPT_LW)
        assert torch.isnan(g[N:]).all(), name  # nothing past the N points
        assert torch.isfinite(w[:N]).all()
        assert torch.equal(g[:N], w[:N]), name


# (x shape, w shape, factor, zero block): the restart coarsening's mass
# weights of x's full shape, an area plane per tile shared by the levels,
# weights with a block all 0 (a coarse level below the fine surface), and
# a row wider than the kernel's chunk of 1024 fine columns, so that one
# coarse row's sums come from two blocks
K5_EMULATION_CASES = [((6, 3, 8, 8), (6, 3, 8, 8), 2, False),
                      ((6, 3, 8, 8), (6, 1, 8, 8), 4, False),
                      ((6, 2, 8, 8), (6, 2, 8, 8), 2, True),
                      ((2, 4, 1032), (2, 4, 1032), 4, False)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", range(len(K5_EMULATION_CASES)))
def test_wavg_kernel_source_matches_plain(emulated, case, dtype):
    """K5 (``csrc/wavg.cu``: a block per batch, coarse row and chunk of
    fine columns, the column sums in shared memory) against
    ``weighted_block_average_plain``: within 2e-6 (float32) and 1e-13
    (float64) of each value, NaN (0 / 0) where a block's weights are all
    0, as the plain version gives it."""
    from fv3net_torch.ops import coarsen, coarsen_cuda

    shape, w_shape, factor, zero_block = K5_EMULATION_CASES[case]
    tdt = TORCH_DTYPE[dtype]
    rng = np.random.default_rng(case)
    x = torch.tensor(rng.standard_normal(shape) + 3.0, dtype=tdt)
    w = torch.tensor(rng.random(w_shape) + 0.1, dtype=tdt)
    if zero_block:
        w[1, 1, :factor, factor:2 * factor] = 0.0
    div, mod = coarsen_cuda.weight_batches(shape[:-2], w_shape[:-2])
    fn = getattr(emulated("wavg.cu"), "fv3_wavg_"
                 + coarsen_cuda._SUFFIX[tdt])
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    ny, nx = shape[-2:]
    got = torch.full(shape[:-2] + (ny // factor, nx // factor),
                     float("nan"), dtype=tdt)
    assert fn(x.data_ptr(), w.data_ptr(), got.data_ptr(),
              int(np.prod(shape[:-2])), ny, nx, factor, div, mod,
              None) == 0
    want = coarsen.weighted_block_average_plain(x, w, factor)
    nan = torch.isnan(want)
    assert nan.any() == zero_block
    assert torch.equal(torch.isnan(got), nan)
    rtol = {"float32": 2e-6, "float64": 1e-13}[dtype]
    assert ((got - want).abs()[~nan] <= rtol * want.abs()[~nan]).all()
