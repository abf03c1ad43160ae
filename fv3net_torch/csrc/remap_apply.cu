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
// What bounds it: memory traffic.  A call reads 4F planes of the fields,
// the 4 (2w+1) weight planes and dp1, p, pe1, pe2 once and writes F
// planes, with O(10) flops per value read: at F=3, C=13,824, km=32 in
// float32 that is 70.3 MB, 0.021 ms at 3.35 TB/s.  This design takes
// 0.043 ms there and 0.105 ms for a dycore step's three calls (F = 3, 2,
// 1; 52% of their bound) on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py): each field still costs a column about 70 shared-memory
// accesses and shuffles against some 640 bytes of its own traffic.
//
// Design: a warp per column.  Lane j holds levels j, j+32, ... (NPL levels
// per lane, km <= 32*NPL <= 128), so every load of q, al, ar, a6, dp1 and
// the search planes, and every store of q2, is a coalesced row.  The warp
// reads the column's search planes once and then walks the call's F
// fields, so w is read once per column, not once per field; at km <= 32
// and 2w+1 in {3, 5, 7} a lane keeps its edge's (2w+1) x 4 weights, and
// those of edge 0, in registers across the fields (reading them through
// __ldg for each field instead, as km > 32 does, costs 19% at F=3 there:
// chip_smoke.py --kernel-times).  Per field:
//   - the field's q, al, ar, a6 go into small shared-memory rows of the
//     warp (dp1 once per column);
//   - the prefix sum runs level by level in the original order: every lane
//     reads the rows of q and dp1 as 16-byte broadcasts, adds q*dp1 to one
//     running sum and keeps the value it had when its own level came by
//     (4 float levels per shared-memory access, where shuffles took 2
//     accesses per level);
//   - the banded evaluation reads its neighbours m_lay[L], al[L], ar[L],
//     a6[L] from the rows;
//   - lane j evaluates edge l+1 (the lower edge of its layer l); edge 0 is
//     evaluated by every lane alike; q2[l] takes M[l] from lane j-1 by
//     __shfl_up_sync (lane 0 from the slot before, or edge 0).
// Each sum runs in the order of a serial walk down the column (levels in
// turn, then the offsets in turn), so the results are those of one thread
// per column, bit for bit.  Registers are indexed only by unrolled loops
// (at km <= 64 in float64 nothing spills to local memory).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // columns per block
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of T, read from shared memory in one access
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};
template <typename T>
union Row16 {
  typename Vec16<T>::type v;
  T a[16 / sizeof(T)];
};

template <typename T, int NPL, int NOFF>
__global__ void __launch_bounds__(kWarps * 32) remap_apply_kernel(
    const T* __restrict__ q, const T* __restrict__ al,
    const T* __restrict__ ar, const T* __restrict__ a6,
    const T* __restrict__ dp1, const T* __restrict__ w,
    const T* __restrict__ p, const T* __restrict__ pe1,
    const T* __restrict__ pe2, T* __restrict__ out, int n_fields,
    long long n_cols, int km, int window) {
  constexpr int KMAX = 32 * NPL;
  constexpr int NV = 16 / sizeof(T);
  using V16 = typename Vec16<T>::type;  // 16-byte aligned rows
  __shared__ V16 s_q[kWarps][KMAX / NV];
  __shared__ V16 s_dp[kWarps][KMAX / NV];
  __shared__ T s_m[kWarps][KMAX];
  __shared__ T s_al[kWarps][KMAX];
  __shared__ T s_ar[kWarps][KMAX];
  __shared__ T s_a6[kWarps][KMAX];

  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * kWarps + wid;
  if (c >= n_cols) return;  // the whole warp leaves together
  const int kn1 = km + 1;
  const int n_off = 2 * window + 1;
  T* sq = reinterpret_cast<T*>(s_q[wid]);
  T* sdp = reinterpret_cast<T*>(s_dp[wid]);
  T* sm = s_m[wid];
  T* sal = s_al[wid];
  T* sar = s_ar[wid];
  T* sa6 = s_a6[wid];

  const T* wc = w + c * (long long)n_off * 4 * kn1;
  const T* pc = p + c * kn1;
  const T* pe2c = pe2 + c * kn1;
  const T pe1_top = __ldg(pe1 + c * kn1);
  const T pe1_bot = __ldg(pe1 + c * kn1 + km);
  const T p_top = __ldg(pc);

  // the lane's levels l = 32 s + lane: layer thickness (into the warp's
  // row, zero past km), the pressures at its upper (l) and lower (l+1)
  // edge, and its edge weights; and the weights of edge 0
  T p_hi[NPL], p_lo[NPL], e2_hi[NPL], e2_lo[NPL];
  T wr[NPL][NOFF > 0 ? NOFF : 1][4];
  T w0[NOFF > 0 ? NOFF : 1][4];
  if constexpr (NOFF > 0) {
#pragma unroll
    for (int i = 0; i < NOFF; ++i) {
#pragma unroll
      for (int a = 0; a < 4; ++a) w0[i][a] = __ldg(wc + (i * 4 + a) * kn1);
    }
  }
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int l = 32 * s + lane;
    const bool ok = l < km;
    sdp[l] = ok ? __ldg(dp1 + c * km + l) : T(0);
    p_hi[s] = ok ? __ldg(pc + l) : T(0);
    p_lo[s] = ok ? __ldg(pc + l + 1) : T(0);
    e2_hi[s] = ok ? __ldg(pe2c + l) : T(0);
    e2_lo[s] = ok ? __ldg(pe2c + l + 1) : T(0);
    if constexpr (NOFF > 0) {
#pragma unroll
      for (int i = 0; i < NOFF; ++i) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          wr[s][i][a] = ok ? __ldg(wc + (i * 4 + a) * kn1 + l + 1) : T(0);
      }
    }
  }

  for (int f = 0; f < n_fields; ++f) {
    const long long off = ((long long)f * n_cols + c) * km;
    const T* qf = q + off;
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const int l = 32 * s + lane;
      if (l < km) {
        sq[l] = __ldg(qf + l);
        sal[l] = __ldg(al + off + l);
        sar[l] = __ldg(ar + off + l);
        sa6[l] = __ldg(a6 + off + l);
      } else {
        sq[l] = T(0);
      }
    }
    const T q_first = __ldg(qf);
    const T q_last = __ldg(qf + km - 1);
    __syncwarp();

    // mass above each layer, summed level by level (every lane alike, from
    // 16-byte broadcasts of the rows; the zeros past km add nothing)
    T acc = T(0);
    T mine[NPL];
#pragma unroll
    for (int s = 0; s < NPL; ++s) mine[s] = T(0);
    for (int l0 = 0; l0 < km; l0 += NV) {
      Row16<T> q4, d4;
      q4.v = s_q[wid][l0 / NV];
      d4.v = s_dp[wid][l0 / NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int s = 0; s < NPL; ++s)
          if (l0 + j == 32 * s + lane) mine[s] = acc;
        acc += q4.a[j] * d4.a[j];
      }
    }
#pragma unroll
    for (int s = 0; s < NPL; ++s)
      if (32 * s + lane < km) sm[32 * s + lane] = mine[s];
    const T m_total = acc;
    __syncwarp();

    // edge 0, the same on every lane
    T m0 = T(0);
    if constexpr (NOFF > 0) {
#pragma unroll
      for (int i = 0; i < NOFF; ++i) {
        const int L = min(max(i - window, 0), km - 1);
        m0 += w0[i][0] * sm[L] + w0[i][1] * sal[L] + w0[i][2] * sar[L] +
              w0[i][3] * sa6[L];
      }
    } else {
      for (int i = 0; i < n_off; ++i) {
        const int L = min(max(i - window, 0), km - 1);
        const T* wk = wc + i * 4 * kn1;
        m0 += __ldg(wk) * sm[L] + __ldg(wk + kn1) * sal[L] +
              __ldg(wk + 2 * kn1) * sar[L] + __ldg(wk + 3 * kn1) * sa6[L];
      }
    }
    if (p_top > pe1_bot) m0 = m_total + (p_top - pe1_bot) * q_last;

    // edge l+1 of each of the lane's levels
    T m_lo[NPL];
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const int l = 32 * s + lane;
      const int base = min(l, km - 1);
      T m = T(0);
      if constexpr (NOFF > 0) {
#pragma unroll
        for (int i = 0; i < NOFF; ++i) {
          const int L = min(max(base + i - window, 0), km - 1);
          m += wr[s][i][0] * sm[L] + wr[s][i][1] * sal[L] +
               wr[s][i][2] * sar[L] + wr[s][i][3] * sa6[L];
        }
      } else {
        const T* wk = wc + min(l + 1, km);
        for (int i = 0; i < n_off; ++i, wk += 4 * kn1) {
          const int L = min(max(base + i - window, 0), km - 1);
          m += __ldg(wk) * sm[L] + __ldg(wk + kn1) * sal[L] +
               __ldg(wk + 2 * kn1) * sar[L] + __ldg(wk + 3 * kn1) * sa6[L];
        }
      }
      if (p_lo[s] > pe1_bot) m = m_total + (p_lo[s] - pe1_bot) * q_last;
      m_lo[s] = m;
    }

    // q2[l] from M[l+1] (this lane) and M[l] (the lane before)
    T* of = out + off;
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const T up = __shfl_up_sync(kFull, m_lo[s], 1);
      const T wrap =
          s == 0 ? m0 : __shfl_sync(kFull, m_lo[s > 0 ? s - 1 : 0], 31);
      const T m_hi = lane == 0 ? wrap : up;
      const int l = 32 * s + lane;
      if (l < km) {
        const T dp2 = p_lo[s] - p_hi[s];
        T q2 = (m_lo[s] - m_hi) / (dp2 == T(0) ? T(1) : dp2);
        if (e2_lo[s] <= pe1_top) q2 = q_first;
        if (dp2 == T(0)) q2 = q_first;
        if (e2_hi[s] >= pe1_bot) q2 = q_last;
        of[l] = q2;
      }
    }
    __syncwarp();  // the next field overwrites the shared rows
  }
}

template <typename T, int NPL, int NOFF>
void launch_one(unsigned int blocks, cudaStream_t s, const void* q,
                const void* al, const void* ar, const void* a6,
                const void* dp1, const void* w, const void* p,
                const void* pe1, const void* pe2, void* out, int n_fields,
                long long n_cols, int km, int window) {
  remap_apply_kernel<T, NPL, NOFF><<<blocks, kWarps * 32, 0, s>>>(
      (const T*)q, (const T*)al, (const T*)ar, (const T*)a6, (const T*)dp1,
      (const T*)w, (const T*)p, (const T*)pe1, (const T*)pe2, (T*)out,
      n_fields, n_cols, km, window);
}

template <typename T>
int launch(const void* q, const void* al, const void* ar, const void* a6,
           const void* dp1, const void* w, const void* p, const void* pe1,
           const void* pe2, void* out, long long n_fields, long long n_cols,
           int km, int window, void* stream) {
  if (n_fields == 0 || n_cols == 0) return 0;
  if (km < 1 || km > 128 || window < 0 || n_fields > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_cols + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int b = (unsigned int)blocks;
  const int nf = (int)n_fields;
#define FV3_LAUNCH(NPL, NOFF)                                                \
  launch_one<T, NPL, NOFF>(b, s, q, al, ar, a6, dp1, w, p, pe1, pe2, out,   \
                           nf, n_cols, km, window)
  if (km <= 32) {
    switch (2 * window + 1) {
      case 3: FV3_LAUNCH(1, 3); break;
      case 5: FV3_LAUNCH(1, 5); break;
      case 7: FV3_LAUNCH(1, 7); break;
      default: FV3_LAUNCH(1, 0);
    }
  } else if (km <= 64) {
    FV3_LAUNCH(2, 0);
  } else {
    FV3_LAUNCH(4, 0);
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
