// Fused weighted block average (K5) for NVIDIA Hopper, sm_90a.
//
// Replaces fv3net_tpu/ops/pallas_kernels.py::_wavg_kernel (the Pallas call
// in weighted_block_average_pallas); its plain PyTorch statement is
// fv3net_torch/ops/coarsen.py::weighted_block_average_plain.  With x
// [B, ny, nx], weight planes w [W, ny, nx] and f = factor:
//
//   out[b, i, j] = sum_{r, c < f} x[b, i*f + r, j*f + c] * w[p, i*f + r, j*f + c]
//                / sum_{r, c < f} w[p, i*f + r, j*f + c],   p = (b / w_div) % w_mod
//
// so a weight that broadcasts over leading axes of x is read in place and
// never expanded to x's shape in memory.
//
// The TPU kernel wrote the block sums as two matrix products against 0/1
// aggregation matrices, because Mosaic cannot reshape across lanes, and
// needed (8, 128)-tiled shapes, falling back to XLA otherwise.  Here it
// is a plain reduction and any shape divisible by f runs.
//
// What bounds it: memory traffic, 2 flops per value of x read.  The
// float32 calls (the levels of a C384 tile, one area plane per tile) want
// HBM bandwidth; the float64 calls of the surface shards (a [2, 192, 192]
// variable, 48 blocks of work) are latency- and launch-bound.  The design:
//
// - A group of variables goes in one launch: the variables share one
//   dtype, one weight tensor and (ny, nx, f), each has its own batches
//   (B, w_div, w_mod); their descriptors travel by value in the kernel's
//   parameters (WavgGroup), so nothing is copied and nothing waits.
// - A unit of work is (variable, weight plane, coarse row, column chunk,
//   chunk of the batches that read that plane).  A block takes one unit
//   and walks its batches: the weights and sum(w) stay in registers, so
//   w is read once a unit, not once a batch (79 times for a tile's
//   levels).  The first batch's rows load beside the weights, and each
//   next batch's while the current one sums.
// - The factor is a template parameter (2, 4, 8: the C384 -> C48
//   pipelines and the tests): a thread's f row loads are unrolled and all
//   in flight at once.  A thread holds V neighbouring fine columns, loaded
//   16 bytes at a time (float4, double2) where nx and the pointers allow,
//   else one value at a time (V = 1).  A cell's f columns lie in f / V
//   neighbouring lanes of a warp and are reduced with shuffles: there is
//   no shared memory and no barrier.
// - Every specialised instance adds in one order, so the 16-byte and the
//   scalar loads give the same bits: each column's rows in turn with fused
//   multiply-adds, then the f column sums as a pairwise tree ((c0 + c1) +
//   (c2 + c3)) + ...; a variable's output does not depend on the group it
//   came in.
// - Any other factor up to kChunk runs the generic instance: a thread per
//   fine column sums its f rows into shared memory, then a thread per cell
//   sums its f columns in turn.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxVars = 64;      // variables of one launch
constexpr int kThreads = 256;     // the specialised instances' largest block
constexpr int kGenThreads = 128;  // the generic instance's block
constexpr int kChunk = 1024;      // generic: fine columns a block holds
constexpr int kBlocksPerSm = 8;   // units a launch aims at, per SM

struct WavgVar {
  const void* x;
  void* out;
  long long B;       // x's batches: the product of its leading axes
  long long w_div;   // batch b reads weight plane (b / w_div) % w_mod
  long long w_mod;
  long long chunks;  // chunks of the B / w_mod batches that read a plane
  long long first;   // the variable's first unit
};

struct WavgGroup {
  WavgVar v[kMaxVars];
  int n;          // variables
  int ny, nx, nyc, nxc;
  int cols;       // fine columns of a column chunk
  int col_chunks;
  int per_chunk;  // batches of a batch chunk
};

struct Unit {
  WavgVar v;       // the variable
  long long p, s;  // weight plane, batch chunk
  int i, x0;       // coarse row, first fine column
};

// The group stays in the kernel's parameter space (__grid_constant__): a
// block copies its own variable's descriptor from there, not the group.
__device__ __forceinline__ Unit find_unit(const WavgGroup& g,
                                          long long u) {
  int k = 0;
  while (k + 1 < g.n && u >= g.v[k + 1].first) ++k;
  Unit t;
  t.v = g.v[k];
  u -= t.v.first;
  t.x0 = (int)(u % g.col_chunks) * g.cols;
  u /= g.col_chunks;
  t.i = (int)(u % g.nyc);
  u /= g.nyc;
  t.p = u % t.v.w_mod;
  t.s = u / t.v.w_mod;
  return t;
}

// the j-th batch that reads plane p
__device__ __forceinline__ long long batch_of(const WavgVar& v, long long p,
                                              long long j) {
  return ((j / v.w_div) * v.w_mod + p) * v.w_div + j % v.w_div;
}

template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* o) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  }
};
template <>
struct Vec<double, 2> {
  __device__ static void load(const double* p, double* o) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    o[0] = a.x; o[1] = a.y;
  }
};
template <typename T>
struct Vec<T, 1> {
  __device__ static void load(const T* p, T* o) { o[0] = __ldg(p); }
};

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

// the pairwise tree over n (a power of two) neighbouring values
template <int N, typename T>
__device__ __forceinline__ T tree(const T* a) {
  if constexpr (N == 1) {
    return a[0];
  } else {
    return tree<N / 2>(a) + tree<N / 2>(a + N / 2);
  }
}

// F rows of V neighbouring values from p on, rows nx apart (zeros for a
// thread past the row's end)
template <typename T, int F, int V>
__device__ __forceinline__ void load_rows(const T* p, int nx, bool active,
                                          T (&o)[F][V]) {
#pragma unroll
  for (int r = 0; r < F; ++r) {
    if (active) {
      Vec<T, V>::load(p + (long long)r * nx, o[r]);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) o[r][c] = T(0);
    }
  }
}

// F the factor, V the fine columns a thread loads at once (4 or 2: 16
// bytes; 1: one value).  blockDim.x is a multiple of 32; a block's cols =
// blockDim.x * V fine columns.
template <typename T, int F, int V>
__global__ void __launch_bounds__(kThreads)
wavg_kernel(const __grid_constant__ WavgGroup g, const T* __restrict__ w) {
  constexpr int kLanes = F >= V ? F / V : 1;  // lanes of a cell
  constexpr int kCells = F >= V ? 1 : V / F;  // cells of a thread
  const Unit t = find_unit(g, blockIdx.x);
  const WavgVar& v = t.v;
  const int col = t.x0 + threadIdx.x * V;
  const bool active = col < g.nx;  // whole cells: nx % F == 0
  const long long row0 = (long long)t.i * F;
  const T* wp = w + (t.p * g.ny + row0) * g.nx + col;

  const long long nshare = v.B / v.w_mod;
  const long long j0 = t.s * g.per_chunk;
  const long long j1 = j0 + g.per_chunk < nshare ? j0 + g.per_chunk : nshare;
  const T* xs = static_cast<const T*>(v.x) + row0 * g.nx + col;
  T* outs = static_cast<T*>(v.out);
  const bool writer = active && (threadIdx.x % kLanes) == 0;
  const long long plane = (long long)g.ny * g.nx;

  // the first batch's rows load beside the weights' rows
  T xv[F][V], wv[F][V];
  if (j0 < j1) load_rows<T, F, V>(xs + batch_of(v, t.p, j0) * plane, g.nx,
                                  active, xv);
  load_rows<T, F, V>(wp, g.nx, active, wv);
  T den[kCells];
  {
    T cd[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      cd[c] = wv[0][c];
#pragma unroll
      for (int r = 1; r < F; ++r) cd[c] += wv[r][c];
    }
#pragma unroll
    for (int k = 0; k < kCells; ++k)
      den[k] = tree<V / kCells>(cd + k * (V / kCells));
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      den[0] += __shfl_xor_sync(0xffffffffu, den[0], o);
  }

  for (long long j = j0; j < j1; ++j) {
    const long long b = batch_of(v, t.p, j);
    T xn[F][V];  // the next batch's rows, in flight while this one sums
    if (j + 1 < j1)
      load_rows<T, F, V>(xs + batch_of(v, t.p, j + 1) * plane, g.nx, active,
                         xn);
    T cn[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      cn[c] = fma_(xv[0][c], wv[0][c], T(0));
#pragma unroll
      for (int r = 1; r < F; ++r) cn[c] = fma_(xv[r][c], wv[r][c], cn[c]);
    }
    T num[kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k)
      num[k] = tree<V / kCells>(cn + k * (V / kCells));
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      num[0] += __shfl_xor_sync(0xffffffffu, num[0], o);
    if (writer) {
      T* op = outs + (b * g.nyc + t.i) * g.nxc + col / F;
#pragma unroll
      for (int k = 0; k < kCells; ++k) op[k] = num[k] / den[k];
    }
    if (j + 1 < j1) {
#pragma unroll
      for (int r = 0; r < F; ++r)
#pragma unroll
        for (int c = 0; c < V; ++c) xv[r][c] = xn[r][c];
    }
  }
}

// Any factor: a thread per fine column of the chunk sums its f rows into
// shared memory, then a thread per coarse cell sums its f columns in turn.
template <typename T>
__global__ void __launch_bounds__(kGenThreads)
wavg_generic_kernel(const __grid_constant__ WavgGroup g,
                    const T* __restrict__ w, int f) {
  __shared__ T snum[kChunk];
  __shared__ T sden[kChunk];
  const Unit t = find_unit(g, blockIdx.x);
  const WavgVar& v = t.v;
  const int width = g.nx - t.x0 < g.cols ? g.nx - t.x0 : g.cols;
  const long long row0 = (long long)t.i * f;
  const T* wp = w + (t.p * g.ny + row0) * g.nx + t.x0;
  const long long nshare = v.B / v.w_mod;
  const long long j0 = t.s * g.per_chunk;
  const long long j1 = j0 + g.per_chunk < nshare ? j0 + g.per_chunk : nshare;
  const T* xs = static_cast<const T*>(v.x);
  T* outs = static_cast<T*>(v.out);
  const int cells = width / f;
  for (long long j = j0; j < j1; ++j) {
    const long long b = batch_of(v, t.p, j);
    const T* xp = xs + (b * g.ny + row0) * g.nx + t.x0;
    for (int c = threadIdx.x; c < width; c += kGenThreads) {
      T num = T(0), den = T(0);
      for (int r = 0; r < f; ++r) {
        const T wv = __ldg(wp + (long long)r * g.nx + c);
        num = fma_(__ldg(xp + (long long)r * g.nx + c), wv, num);
        den += wv;
      }
      snum[c] = num;
      sden[c] = den;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cells; c += kGenThreads) {
      T num = T(0), den = T(0);
      for (int k = 0; k < f; ++k) {
        num += snum[c * f + k];
        den += sden[c * f + k];
      }
      outs[(b * g.nyc + t.i) * g.nxc + t.x0 / f + c] = num / den;
    }
    __syncthreads();
  }
}

template <typename T, int F, int V>
void launch_special(const WavgGroup& g, const T* w, long long units,
                    int threads, cudaStream_t s) {
  wavg_kernel<T, F, V><<<(unsigned int)units, threads, 0, s>>>(g, w);
}

template <typename T, int F>
void launch_factor(const WavgGroup& g, const T* w, long long units,
                   int threads, int v, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (v == kV) {
    launch_special<T, F, kV>(g, w, units, threads, s);
  } else {
    launch_special<T, F, 1>(g, w, units, threads, s);
  }
}

bool templated(int f) { return f == 2 || f == 4 || f == 8; }

// The instance a group takes: 0 the generic one, else f * 10 + V.
template <typename T>
int instance(const void* const* xs, int n, const void* w, int nx, int f) {
  if (!templated(f)) return 0;
  constexpr int kV = 16 / sizeof(T);
  bool vec = nx % kV == 0 && reinterpret_cast<unsigned long long>(w) % 16 == 0;
  for (int k = 0; k < n && vec; ++k)
    vec = reinterpret_cast<unsigned long long>(xs[k]) % 16 == 0;
  return f * 10 + (vec ? kV : 1);
}

template <typename T>
int launch_group(const void* const* xs, void* const* outs,
                 const long long* Bs, const long long* w_divs,
                 const long long* w_mods, int n, const void* w, int ny,
                 int nx, int f, int* chosen, void* stream) {
  if (n < 1 || n > kMaxVars || f < 1 || f > kChunk || ny % f || nx % f)
    return (int)cudaErrorInvalidValue;
  const int inst = instance<T>(xs, n, w, nx, f);
  if (chosen) *chosen = inst;
  WavgGroup g;
  g.n = n;
  g.ny = ny;
  g.nx = nx;
  g.nyc = ny / f;
  g.nxc = nx / f;
  int threads = kGenThreads;
  if (inst) {
    const int vw = inst % 10;
    const int lanes = (nx / vw + 31) / 32 * 32;
    threads = lanes < kThreads ? lanes : kThreads;
    g.cols = threads * vw;
  } else {
    g.cols = (kChunk / f) * f;
  }
  g.col_chunks = nx == 0 ? 0 : (nx + g.cols - 1) / g.cols;
  // the batch chunks: as few as give the card kBlocksPerSm units an SM
  long long base = 0, most = 1;
  for (int k = 0; k < n; ++k) {
    if (Bs[k] < 0 || w_divs[k] < 1 || w_mods[k] < 1 ||
        Bs[k] % (w_divs[k] * w_mods[k]))
      return (int)cudaErrorInvalidValue;
    base += w_mods[k] * g.nyc * g.col_chunks;
    const long long share = Bs[k] / w_mods[k];
    if (share > most) most = share;
  }
  if (base == 0) return 0;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (long long)sms * kBlocksPerSm;
  long long split = base >= want ? 1 : (want + base - 1) / base;
  if (split > most) split = most;
  g.per_chunk = (int)((most + split - 1) / split);
  long long units = 0;
  for (int k = 0; k < n; ++k) {
    WavgVar& v = g.v[k];
    v.x = xs[k];
    v.out = outs[k];
    v.B = Bs[k];
    v.w_div = w_divs[k];
    v.w_mod = w_mods[k];
    v.chunks = (Bs[k] / w_mods[k] + g.per_chunk - 1) / g.per_chunk;
    v.first = units;
    units += v.w_mod * g.nyc * g.col_chunks * v.chunks;
  }
  if (units == 0) return 0;
  if (units > 2147483647LL) return (int)cudaErrorInvalidValue;
  const T* wt = static_cast<const T*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (inst / 10) {
    case 2: launch_factor<T, 2>(g, wt, units, threads, inst % 10, s); break;
    case 4: launch_factor<T, 4>(g, wt, units, threads, inst % 10, s); break;
    case 8: launch_factor<T, 8>(g, wt, units, threads, inst % 10, s); break;
    default:
      wavg_generic_kernel<T><<<(unsigned int)units, kGenThreads, 0, s>>>(
          g, wt, f);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// A group of n variables in one launch: xs[k] [Bs[k], ny, nx] averaged
// into outs[k] [Bs[k], ny / f, nx / f] with the weight planes w, batch b
// of variable k reading plane (b / w_divs[k]) % w_mods[k].  ``chosen``
// (may be null) receives the instance: 0 the generic one, else f * 10 + V.
extern "C" int fv3_wavg_group_f32(const void* const* xs, void* const* outs,
                                  const long long* Bs,
                                  const long long* w_divs,
                                  const long long* w_mods, int n,
                                  const void* w, int ny, int nx, int f,
                                  int* chosen, void* stream) {
  return launch_group<float>(xs, outs, Bs, w_divs, w_mods, n, w, ny, nx, f,
                             chosen, stream);
}

extern "C" int fv3_wavg_group_f64(const void* const* xs, void* const* outs,
                                  const long long* Bs,
                                  const long long* w_divs,
                                  const long long* w_mods, int n,
                                  const void* w, int ny, int nx, int f,
                                  int* chosen, void* stream) {
  return launch_group<double>(xs, outs, Bs, w_divs, w_mods, n, w, ny, nx,
                              f, chosen, stream);
}

