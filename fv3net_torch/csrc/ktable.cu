// RRTMG k-table selection kernels (K4 and K3) for NVIDIA Hopper, sm_90a.
//
// K4 replaces fv3net_tpu/ops/pallas_ktable.py::_ktable_kernel (the Pallas
// call in weighted_select_dot); its plain PyTorch statement is
// fv3net_torch/ops/ktable.py::weighted_select_dot_plain:
//
//   out[n, g] = sum_k w[k, n] * tab[clamp(ids[k, n], 0, R-1), g]
//
// with ids/w [K, N] (K small: 1-4 at the RRTMG sites) and tab [R, G].
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
// Design: one thread per output element (n, g), consecutive threads along
// g, so the output is written coalesced and the K (id, weight) pairs of a
// point are read once per warp through the cache.  K4 reads its table
// (at most 181 x 140 values at the RRTMG sites) through L1; K3 stages its
// table (at most 236 x 80 values, 151 KB in float64) in dynamic shared
// memory once per block, and each block then walks the points with a
// grid-stride loop so the staging is paid once per resident block.
// Sums run in the compute type, in the same order as the plain versions.
//
// What bounds them: memory traffic.  Per point K4 reads K ids and weights
// and writes G values (2-4 flops per value read); K3 reads
// n_paths*(kw+st) ids and weights and writes ng values.  Table reads hit
// L1 / shared memory.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void weighted_select_kernel(const int* __restrict__ ids,
                                       const T* __restrict__ w,
                                       const T* __restrict__ tab,
                                       T* __restrict__ out, int K,
                                       long long N, int R, int G) {
  const long long total = N * G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long n = t / G;
    const int g = (int)(t - n * G);
    T acc = T(0);
    for (int k = 0; k < K; ++k) {
      int r = __ldg(ids + k * N + n);
      r = min(max(r, 0), R - 1);
      acc += __ldg(w + k * N + n) * __ldg(tab + (long long)r * G + g);
    }
    out[t] = acc;
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
int launch_select(const void* ids, const void* w, const void* tab, void* out,
                  int K, long long N, int R, int G, void* stream) {
  if (N == 0) return 0;
  if (K < 1 || R < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (N * G + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  weighted_select_kernel<T><<<(unsigned int)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      (const int*)ids, (const T*)w, (const T*)tab, (T*)out, K, N, R, G);
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

extern "C" int fv3_ktable_select_f32(const void* ids, const void* w,
                                     const void* tab, void* out, int K,
                                     long long N, int R, int G,
                                     void* stream) {
  return launch_select<float>(ids, w, tab, out, K, N, R, G, stream);
}

extern "C" int fv3_ktable_select_f64(const void* ids, const void* w,
                                     const void* tab, void* out, int K,
                                     long long N, int R, int G,
                                     void* stream) {
  return launch_select<double>(ids, w, tab, out, K, N, R, G, stream);
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
