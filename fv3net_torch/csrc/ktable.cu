// RRTMG k-table selection kernels (K4 and K3) for NVIDIA Hopper, sm_90a.
//
// K4 replaces fv3net_tpu/ops/pallas_ktable.py::_ktable_kernel (the Pallas
// call in weighted_select_dot); its plain PyTorch statement is
// fv3net_torch/ops/ktable.py::weighted_select_dot_plain:
//
//   out[n, g] = sum_k w_k[n] * tab[clamp(ids_k[n], 0, R-1), g]
//
// for K <= 16 (id, weight) terms (1-4 at the RRTMG sites) and tab [R, G].
//
// K3 replaces fv3net_tpu/ops/pallas_ktable.py::_spec_kernel (the Pallas
// call in spec_band_dot); plain statement ktable.py::spec_band_dot_plain.
// With tab [nbase, nspa*ng] read as [nbase, nspa, ng]:
//
//   out[n, g] = sum_p sum_s sw[p*st+s, n] *
//               sum_k ww[p*kw+k, n] * tab[row(p, k, n), pos(p, s, n), g]
//
// where row = clamp(wids[p*kw+k, n], 0, nbase-1) is a pressure/temperature
// base row and pos = clamp(sids[p*st+s, n], 0, nspa-1) a species-stencil
// column.  The [N, nspa*ng] interpolation block the TPU kernel formed in
// VMEM (a one-hot matrix times the table) never exists: both kernels are
// gathers, since the one-hot matmul only stood in for the gather the TPU
// lacked.
//
// What bounds them: memory traffic.  Per point K4 reads K ids and weights
// and writes G values, 2 flops per table value read; at the main path's
// mtab_lo1 call (K=4, N=442,368, G=54, int64 ids) that is 117 MB,
// 0.035 ms at 3.35 TB/s, nearly all of it the output.  K3 reads
// n_paths*(kw+st) ids and weights per point and writes ng values.  Table
// reads hit L1 (every RRTMG table is at most 236 x 140 values).
//
// K4 design: a block owns a tile of P consecutive points (about 8,192 / G
// of them), whose P*G outputs are one contiguous range.  It takes its K
// terms as the caller holds them: a struct of up to 16 id and weight
// pointers passed by value, ids int32 or int64 (a bit per term), a null
// weight meaning 1.  The block loads the tile's ids and weights once,
// coalesced, clamps the ids and keeps (row offset, weight) per term and
// point in shared memory; its threads then walk the tile's outputs with
// 32-bit indices, the (point, g) of each output carried forward from the
// last without a division.  Consecutive threads take consecutive outputs:
// the table gathers through the read-only cache, not the stores, set the
// pace, and a warp's K gathers then touch one run of each of at most two
// rows.  (With 4 outputs per thread and 16-byte stores a warp's gathers
// spanned 4 times the cache lines: K4 took 3.41 ms of the RRTMG chunk
// against 3.14-3.17 ms this way, on an NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py.)  What holds it near 43% of its bound at mtab_lo1: the K
// gathers and shared-memory reads per output, not the bytes; float64
// takes nearly the same time for twice the bytes.  Terms are summed
// k = 0..K-1, one multiply-add each, in the order of the plain version.
//
// K3 design: K4's, with the stencil on top.  It takes its terms in K4's
// struct, by pointer as the caller holds them: first the n_paths * kw base
// pairs, path-major, then the n_paths * st stencil pairs (kw <= 4).  A
// block owns a tile of P consecutive points, whose P*ng outputs are one
// contiguous range.  It loads the tile's ids and weights once, coalesced,
// clamps them and keeps per term and point in shared memory the base row's
// offset row * nspa * ng, or the stencil position's pos * ng, with its
// weight; its threads then walk the tile's outputs, consecutive threads on
// consecutive pairs of outputs (ng is even at every RRTMG band; an odd ng
// takes one output a thread), the (point, g) of each carried forward from
// the last with 32-bit indices and no division.  A thread's two outputs
// share its point's pairs, read once, and each table read brings both
// (8 or 16 bytes); a path's base pairs go to registers once and serve its
// st stencil positions.  The blocks are persistent (as many as are
// resident, walking the tiles); the table is read through the read-only
// cache.  Sums keep the plain version's order, for p, for s:
// a = sum_k ww * tab, then acc += sw * a, each step one fused multiply-add,
// written out.
//
// What holds K3 back (LW band 3 lower, float32, NVIDIA H100 80GB HBM3 at
// 700 W, chip_smoke.py --kernel-times): latency, not bytes: per pair of
// outputs 12 gathers and 10 shared-memory pair reads.  One output a
// thread with the table in shared memory read 0.115 ms, two outputs with
// the table in shared memory 0.090-0.108 ms (2-3 blocks an SM), two
// outputs through the cache 0.082-0.083 ms (6 blocks an SM).

#include <cuda_runtime.h>
#include <math.h>

// The K4 terms as the wrapper packs them (ops/ktable_cuda.py::SelectTerms),
// passed by value.
constexpr int kMaxTerms = 16;
struct SelectTerms {
  const void* ids[kMaxTerms];
  const void* w[kMaxTerms];
  int n_terms;
  unsigned int ids64;  // bit k set: ids[k] holds int64, else int32
};

namespace {

constexpr int kSelectThreads = 256;
constexpr int kSelectTileValues = 8192;  // outputs per tile, about
constexpr int kSelectSmem = 48 * 1024;   // bytes of (row, weight) per tile

// a term's clamped row offset r * G and its weight, at one point
template <typename T>
struct SelectPair {
  int row;
  T w;
};

template <typename T>
__global__ void __launch_bounds__(kSelectThreads) weighted_select_kernel(
    const SelectTerms terms, const T* __restrict__ tab, T* __restrict__ out,
    long long N, int R, int G, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = terms.n_terms;
  SelectPair<T>* s_pair = reinterpret_cast<SelectPair<T>*>(smem_raw);
  const long long n0 = (long long)blockIdx.x * P;
  const int np = (int)min((long long)P, N - n0);

  for (int k = 0; k < K; ++k) {  // [K][P]
    const bool wide = (terms.ids64 >> k) & 1u;
    const T* wk = static_cast<const T*>(terms.w[k]);
    const int* id32 = static_cast<const int*>(terms.ids[k]) + n0;
    const long long* id64 = static_cast<const long long*>(terms.ids[k]) + n0;
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
      long long r = wide ? __ldg(id64 + i) : (long long)__ldg(id32 + i);
      r = r < 0 ? 0 : (r >= R ? R - 1 : r);
      s_pair[k * P + i] = {(int)r * G, wk ? __ldg(wk + n0 + i) : T(1)};
    }
  }
  __syncthreads();

  // consecutive threads on consecutive outputs: a warp's store is one
  // contiguous run, and its table reads one run per row (at most two rows)
  T* o = out + n0 * G;
  const int total = np * G;
  const int dn = blockDim.x / G, dg = blockDim.x - dn * G;
  int n = threadIdx.x / G, g = threadIdx.x - n * G;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    T acc = T(0);
    for (int k = 0; k < K; ++k) {
      const SelectPair<T> pr = s_pair[k * P + n];
      acc += pr.w * __ldg(tab + pr.row + g);
    }
    o[e] = acc;
    n += dn;
    g += dg;
    if (g >= G) {
      g -= G;
      ++n;
    }
  }
}

// a + x * y rounded once: the plain version's multiply-add, fused as the
// compiler contracted it in the one-output-a-thread design before this
// one, whose results this kernel keeps to the bit
__device__ __forceinline__ float mad(float x, float y, float a) {
  return fmaf(x, y, a);
}
__device__ __forceinline__ double mad(double x, double y, double a) {
  return fma(x, y, a);
}

// kVec neighbouring values of T, read and written as one
template <typename T, int kVec>
struct Vec {
  using type = T;
};
template <>
struct Vec<float, 2> {
  using type = float2;
};
template <>
struct Vec<double, 2> {
  using type = double2;
};
__device__ __forceinline__ float lane(float x, int) { return x; }
__device__ __forceinline__ double lane(double x, int) { return x; }
__device__ __forceinline__ float lane(float2 x, int j) {
  return j ? x.y : x.x;
}
__device__ __forceinline__ double lane(double2 x, int j) {
  return j ? x.y : x.x;
}
__device__ __forceinline__ void set(float* o, const float* a) { *o = a[0]; }
__device__ __forceinline__ void set(double* o, const double* a) {
  *o = a[0];
}
__device__ __forceinline__ void set(float2* o, const float* a) {
  *o = make_float2(a[0], a[1]);
}
__device__ __forceinline__ void set(double2* o, const double* a) {
  *o = make_double2(a[0], a[1]);
}

constexpr int kSpecThreads = 256;
constexpr int kSpecTileValues = 4096;  // outputs per tile, about
constexpr int kSpecPairSmem = 48 * 1024;  // bytes of pairs per tile, at most
constexpr int kSpecMaxBase = 4;        // base pairs per path (kw)

template <typename T, int kVec>
__global__ void __launch_bounds__(kSpecThreads) spec_band_kernel(
    const SelectTerms terms, const T* __restrict__ tab, T* __restrict__ out,
    long long N, int n_paths, int kw, int st, int nbase, int nspa, int ng,
    int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = terms.n_terms;  // n_paths * (kw + st)
  const int n_base = n_paths * kw;
  const int row_len = nspa * ng;
  SelectPair<T>* s_pair = reinterpret_cast<SelectPair<T>*>(smem_raw);
  const long long tiles = (N + P - 1) / P;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long n0 = tile * P;
    const int np = (int)min((long long)P, N - n0);
    __syncthreads();  // the last tile's readers are done
    for (int k = 0; k < K; ++k) {  // [K][P]
      const bool wide = (terms.ids64 >> k) & 1u;
      const bool base = k < n_base;
      const int hi = base ? nbase - 1 : nspa - 1;
      const int step = base ? row_len : ng;
      const T* wk = static_cast<const T*>(terms.w[k]);
      const int* id32 = static_cast<const int*>(terms.ids[k]) + n0;
      const long long* id64 =
          static_cast<const long long*>(terms.ids[k]) + n0;
      for (int i = threadIdx.x; i < np; i += blockDim.x) {
        long long r = wide ? __ldg(id64 + i) : (long long)__ldg(id32 + i);
        r = r < 0 ? 0 : (r > hi ? hi : r);
        s_pair[k * P + i] = {(int)r * step, wk ? __ldg(wk + n0 + i) : T(1)};
      }
    }
    __syncthreads();

    // a thread takes kVec neighbouring outputs of a point (ng is a
    // multiple of kVec), its table reads kVec wide
    using V = typename Vec<T, kVec>::type;
    V* o = reinterpret_cast<V*>(out + n0 * ng);
    const int nv = ng / kVec;  // a point's vectors
    const int total = np * nv;
    const int dn = blockDim.x / nv, dh = blockDim.x - dn * nv;
    int n = threadIdx.x / nv, h = threadIdx.x - n * nv;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int g = kVec * h;
      T acc[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = T(0);
      for (int p = 0; p < n_paths; ++p) {
        int row[kSpecMaxBase];
        T ww[kSpecMaxBase];
#pragma unroll
        for (int k = 0; k < kSpecMaxBase; ++k) {
          if (k < kw) {
            const SelectPair<T> pr = s_pair[(p * kw + k) * P + n];
            row[k] = pr.row + g;
            ww[k] = pr.w;
          }
        }
        for (int s = 0; s < st; ++s) {
          const SelectPair<T> ps = s_pair[(n_base + p * st + s) * P + n];
          const T* ts = tab + ps.row;
          T a[kVec];
#pragma unroll
          for (int j = 0; j < kVec; ++j) a[j] = T(0);
#pragma unroll
          for (int k = 0; k < kSpecMaxBase; ++k) {
            if (k < kw) {
              const V* src = reinterpret_cast<const V*>(ts + row[k]);
              const V x = __ldg(src);
#pragma unroll
              for (int j = 0; j < kVec; ++j)
                a[j] = mad(ww[k], lane(x, j), a[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[j] = mad(ps.w, a[j], acc[j]);
        }
      }
      set(o + e, acc);
      n += dn;
      h += dh;
      if (h >= nv) {
        h -= nv;
        ++n;
      }
    }
  }
}

template <typename T>
int launch_select(SelectTerms terms, const void* tab, void* out, long long N,
                  int R, int G, void* stream) {
  if (N == 0) return 0;
  const int K = terms.n_terms;
  if (K < 1 || K > kMaxTerms || R < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)R * G > 2147483647LL) return (int)cudaErrorInvalidValue;
  // points per tile: about kSelectTileValues outputs, within kSelectSmem
  int P = (kSelectTileValues + G - 1) / G;
  const int p_max = kSelectSmem / (K * (int)sizeof(SelectPair<T>));
  if (P > p_max) P = p_max;
  if ((long long)P * G + kSelectThreads > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (N + P - 1) / P;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * P * sizeof(SelectPair<T>);
  weighted_select_kernel<T><<<(unsigned int)blocks, kSelectThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      terms, (const T*)tab, (T*)out, N, R, G, P);
  return (int)cudaGetLastError();
}

// K3's instance: two outputs a thread, or one (an odd ng, or a table not
// aligned to its pairs of values)
template <typename T>
auto spec_kernel(bool pairs) {
  return pairs ? spec_band_kernel<T, 2> : spec_band_kernel<T, 1>;
}

// K3's launch configuration: points per tile, shared memory for the
// pairs, blocks per SM
struct SpecPlan {
  int P;
  size_t smem;
  int per_sm;
};

template <typename T>
int plan_spec(int K, int ng, SpecPlan* plan) {
  int P = (kSpecTileValues + ng - 1) / ng;
  const int p_max = kSpecPairSmem / (K * (int)sizeof(SelectPair<T>));
  if (P > p_max) P = p_max;
  plan->P = P;
  plan->smem = (size_t)K * P * sizeof(SelectPair<T>);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &plan->per_sm, spec_kernel<T>(ng % 2 == 0), kSpecThreads,
      plan->smem);
  if (err != cudaSuccess) return (int)err;
  return plan->per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <typename T>
int launch_spec(SelectTerms terms, const void* tab, void* out, long long N,
                int n_paths, int kw, int st, int nbase, int nspa, int ng,
                void* stream) {
  if (N == 0) return 0;
  if (n_paths < 1 || kw < 1 || kw > kSpecMaxBase || st < 1 || nbase < 1 ||
      nspa < 1 || ng < 1 || terms.n_terms != n_paths * (kw + st) ||
      terms.n_terms > kMaxTerms)
    return (int)cudaErrorInvalidValue;
  if ((long long)nbase * nspa * ng > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  SpecPlan plan;
  int err = plan_spec<T>(terms.n_terms, ng, &plan);
  if (err != 0) return err;
  int device = 0, sms = 0;
  cudaError_t cerr;
  if ((cerr = cudaGetDevice(&device)) != cudaSuccess) return (int)cerr;
  cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cerr != cudaSuccess) return (int)cerr;
  const long long tiles = (N + plan.P - 1) / plan.P;
  const long long resident = (long long)sms * plan.per_sm;
  const unsigned int blocks =
      (unsigned int)(tiles < resident ? tiles : resident);
  auto kernel = spec_kernel<T>(ng % 2 == 0 &&
                               (size_t)tab % (2 * sizeof(T)) == 0);
  kernel<<<blocks, kSpecThreads, plan.smem,
           static_cast<cudaStream_t>(stream)>>>(
      terms, (const T*)tab, (T*)out, N, n_paths, kw, st, nbase, nspa, ng,
      plan.P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fv3_ktable_select_f32(SelectTerms terms, const void* tab,
                                     void* out, long long N, int R, int G,
                                     void* stream) {
  return launch_select<float>(terms, tab, out, N, R, G, stream);
}

extern "C" int fv3_ktable_select_f64(SelectTerms terms, const void* tab,
                                     void* out, long long N, int R, int G,
                                     void* stream) {
  return launch_select<double>(terms, tab, out, N, R, G, stream);
}

extern "C" int fv3_ktable_spec_f32(SelectTerms terms, const void* tab,
                                   void* out, long long N, int n_paths,
                                   int kw, int st, int nbase, int nspa,
                                   int ng, void* stream) {
  return launch_spec<float>(terms, tab, out, N, n_paths, kw, st, nbase, nspa,
                            ng, stream);
}

extern "C" int fv3_ktable_spec_f64(SelectTerms terms, const void* tab,
                                   void* out, long long N, int n_paths,
                                   int kw, int st, int nbase, int nspa,
                                   int ng, void* stream) {
  return launch_spec<double>(terms, tab, out, N, n_paths, kw, st, nbase,
                             nspa, ng, stream);
}

// K3's plan for a call of K terms with ng outputs a point: points per
// tile, the shared bytes of a block and the blocks a SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
extern "C" int fv3_ktable_spec_plan(int f64, int K, int ng, int* P,
                                    long long* smem, int* per_sm) {
  SpecPlan plan;
  const int err = f64 ? plan_spec<double>(K, ng, &plan)
                      : plan_spec<float>(K, ng, &plan);
  if (err != 0) return err;
  *P = plan.P;
  *smem = (long long)plan.smem;
  *per_sm = plan.per_sm;
  return 0;
}
