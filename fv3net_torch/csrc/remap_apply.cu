// Banded PPM remap application (K1) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel fv3net_tpu/ops/pallas_remap.py::_kernel (the
// Pallas call in apply_packed).  It computes the post-profile half of
// ops/remap.py::remap_apply, whose plain PyTorch statement is
// fv3net_torch/ops/remap.py::remap_apply_plain:
//
//   m_lay[L]  = sum_{l<L} q[l] * dp1[l]           (exclusive prefix sum)
//   M[k]      = sum_{o=-w..w} use*m_lay[L] + wA*al[L] + wB*ar[L] + wC*a6[L]
//               with L = clip(clip(k-1, 0, km-1) + o, 0, km-1)
//   M[k]      = m_total + (p[k] - pe1[km]) * q[km-1]   where p[k] > pe1[km]
//   q2[k]     = (M[k+1] - M[k]) / dp2[k], then the top / zero-thickness /
//               below-surface masks.
//
// Layout: the natural z-last layout banded_search produces.  Fields q, al,
// ar, a6 and the output are [F, C, km]; the shared search planes are
// dp1 [C, km], w [C, 2w+1, 4, km+1] and p, pe1, pe2 [C, km+1].
//
// Design: one thread per (field, column).  The running prefix sum lives in
// a per-thread array (local memory, sized by the KMAX template bucket); the
// banded evaluation walks the km+1 target edges once and writes each q2 as
// soon as its upper edge is known.
//
// What bounds it: memory traffic.  A call reads about 4F + 4*(2w+1) + 6
// planes of km*C values (F fields of q/al/ar/a6, 20 weight planes at w=2,
// dp1/p/pe1/pe2 and their edges) and writes F planes, with O(1) flops per
// value.  What this simple design leaves on the table: neighbouring
// threads read addresses km apart (a column is contiguous), so loads are
// not coalesced and rely on L1/L2; the weight planes are re-read once per
// field instead of once per column; and the profile (cs_profile) runs as
// separate launches in front of it.  A warp per column (z across lanes,
// coalesced), all F fields per thread block, or fusing cs_profile in front
// are the next steps.

#include <cuda_runtime.h>

namespace {

template <typename T, int KMAX>
__global__ void remap_apply_kernel(
    const T* __restrict__ q, const T* __restrict__ al,
    const T* __restrict__ ar, const T* __restrict__ a6,
    const T* __restrict__ dp1, const T* __restrict__ w,
    const T* __restrict__ p, const T* __restrict__ pe1,
    const T* __restrict__ pe2, T* __restrict__ out,
    long long n_fields, long long n_cols, int km, int window) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_fields * n_cols) return;
  const long long c = t % n_cols;
  const int kn1 = km + 1;
  const int n_off = 2 * window + 1;

  const T* qc = q + t * km;
  const T* alc = al + t * km;
  const T* arc = ar + t * km;
  const T* a6c = a6 + t * km;
  const T* dpc = dp1 + c * km;
  const T* wc = w + c * (long long)n_off * 4 * kn1;
  const T* pc = p + c * kn1;
  const T* pe1c = pe1 + c * kn1;
  const T* pe2c = pe2 + c * kn1;
  T* outc = out + t * km;

  // mass above each source layer
  T m_lay[KMAX];
  T acc = T(0);
  for (int k = 0; k < km; ++k) {
    m_lay[k] = acc;
    acc += qc[k] * dpc[k];
  }
  const T m_total = acc;
  const T q_first = qc[0];
  const T q_last = qc[km - 1];
  const T pe1_top = pe1c[0];
  const T pe1_bot = pe1c[km];

  T m_prev = T(0);
  T p_prev = T(0);
  for (int k = 0; k < kn1; ++k) {
    const int base = min(max(k - 1, 0), km - 1);
    T m = T(0);
    for (int i = 0; i < n_off; ++i) {
      const int L = min(max(base + i - window, 0), km - 1);
      const T* wk = wc + (long long)i * 4 * kn1 + k;
      m += wk[0] * m_lay[L] + wk[kn1] * alc[L] + wk[2 * kn1] * arc[L] +
           wk[3 * kn1] * a6c[L];
    }
    const T pk = pc[k];
    if (pk > pe1_bot) m = m_total + (pk - pe1_bot) * q_last;
    if (k > 0) {
      const int j = k - 1;
      const T dp2 = pk - p_prev;
      T q2 = (m - m_prev) / (dp2 == T(0) ? T(1) : dp2);
      if (pe2c[j + 1] <= pe1_top) q2 = q_first;
      if (dp2 == T(0)) q2 = q_first;
      if (pe2c[j] >= pe1_bot) q2 = q_last;
      outc[j] = q2;
    }
    m_prev = m;
    p_prev = pk;
  }
}

template <typename T>
int launch(const void* q, const void* al, const void* ar, const void* a6,
           const void* dp1, const void* w, const void* p, const void* pe1,
           const void* pe2, void* out, long long n_fields, long long n_cols,
           int km, int window, void* stream) {
  const long long n = n_fields * n_cols;
  if (n == 0) return 0;
  if (km < 1 || window < 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FV3_LAUNCH(KMAX)                                                    \
  remap_apply_kernel<T, KMAX><<<blocks, threads, 0, s>>>(                  \
      (const T*)q, (const T*)al, (const T*)ar, (const T*)a6,               \
      (const T*)dp1, (const T*)w, (const T*)p, (const T*)pe1,              \
      (const T*)pe2, (T*)out, n_fields, n_cols, km, window)
  if (km <= 32) {
    FV3_LAUNCH(32);
  } else if (km <= 64) {
    FV3_LAUNCH(64);
  } else if (km <= 128) {
    FV3_LAUNCH(128);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef FV3_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fv3_remap_apply_f32(const void* q, const void* al,
                                   const void* ar, const void* a6,
                                   const void* dp1, const void* w,
                                   const void* p, const void* pe1,
                                   const void* pe2, void* out,
                                   long long n_fields, long long n_cols,
                                   int km, int window, void* stream) {
  return launch<float>(q, al, ar, a6, dp1, w, p, pe1, pe2, out, n_fields,
                       n_cols, km, window, stream);
}

extern "C" int fv3_remap_apply_f64(const void* q, const void* al,
                                   const void* ar, const void* a6,
                                   const void* dp1, const void* w,
                                   const void* p, const void* pe1,
                                   const void* pe2, void* out,
                                   long long n_fields, long long n_cols,
                                   int km, int window, void* stream) {
  return launch<double>(q, al, ar, a6, dp1, w, p, pe1, pe2, out, n_fields,
                        n_cols, km, window, stream);
}
