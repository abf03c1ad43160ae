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
// 0.035 ms at 3.35 TB/s, nearly all of it the output.  K3 reads n_paths*(kw+st) ids
// and weights per point and writes ng values.  Table reads hit L1 /
// shared memory (every RRTMG table is at most 181 x 140 values).
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
// K3 design: one thread per output element (n, g), consecutive threads
// along g; the table (at most 236 x 80 values, 151 KB in float64) is
// staged in dynamic shared memory once per block, and each block walks the
// points with a grid-stride loop so the staging is paid once per resident
// block.  Sums run in the compute type, in the same order as the plain
// versions.

#include <cuda_runtime.h>

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

template <typename T>
__global__ void spec_band_kernel(const int* __restrict__ wids,
                                 const T* __restrict__ ww,
                                 const int* __restrict__ sids,
                                 const T* __restrict__ sw,
                                 const T* __restrict__ tab,
                                 T* __restrict__ out, long long N,
                                 int n_paths, int kw, int st, int nbase,
                                 int nspa, int ng) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stab = reinterpret_cast<T*>(smem_raw);
  const int row_len = nspa * ng;
  const int tab_n = nbase * row_len;
  for (int i = threadIdx.x; i < tab_n; i += blockDim.x) stab[i] = tab[i];
  __syncthreads();

  const long long total = N * ng;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long n = t / ng;
    const int g = (int)(t - n * ng);
    T acc = T(0);
    for (int p = 0; p < n_paths; ++p) {
      for (int s = 0; s < st; ++s) {
        const long long si = (long long)(p * st + s) * N + n;
        const int pos = min(max(__ldg(sids + si), 0), nspa - 1);
        T a = T(0);
        for (int k = 0; k < kw; ++k) {
          const long long wi = (long long)(p * kw + k) * N + n;
          const int row = min(max(__ldg(wids + wi), 0), nbase - 1);
          a += __ldg(ww + wi) * stab[row * row_len + pos * ng + g];
        }
        acc += __ldg(sw + si) * a;
      }
    }
    out[t] = acc;
  }
}

constexpr int kThreads = 256;

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

template <typename T>
int launch_spec(const void* wids, const void* ww, const void* sids,
                const void* sw, const void* tab, void* out, long long N,
                int n_paths, int kw, int st, int nbase, int nspa, int ng,
                void* stream) {
  if (N == 0) return 0;
  if (n_paths < 1 || kw < 1 || st < 1 || nbase < 1 || nspa < 1 || ng < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nbase * nspa * ng * sizeof(T);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(spec_band_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, spec_band_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (N * ng + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * per_sm;
  const unsigned int blocks =
      (unsigned int)(want < resident ? want : resident);
  spec_band_kernel<T><<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      (const int*)wids, (const T*)ww, (const int*)sids, (const T*)sw,
      (const T*)tab, (T*)out, N, n_paths, kw, st, nbase, nspa, ng);
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

extern "C" int fv3_ktable_spec_f32(const void* wids, const void* ww,
                                   const void* sids, const void* sw,
                                   const void* tab, void* out, long long N,
                                   int n_paths, int kw, int st, int nbase,
                                   int nspa, int ng, void* stream) {
  return launch_spec<float>(wids, ww, sids, sw, tab, out, N, n_paths, kw, st,
                            nbase, nspa, ng, stream);
}

extern "C" int fv3_ktable_spec_f64(const void* wids, const void* ww,
                                   const void* sids, const void* sw,
                                   const void* tab, void* out, long long N,
                                   int n_paths, int kw, int st, int nbase,
                                   int nspa, int ng, void* stream) {
  return launch_spec<double>(wids, ww, sids, sw, tab, out, N, n_paths, kw,
                             st, nbase, nspa, ng, stream);
}
