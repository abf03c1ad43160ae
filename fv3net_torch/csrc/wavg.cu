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
// Design: one block per (batch, coarse row, chunk of at most 1024 fine
// columns).  Phase 1: threads run along the fine columns, neighbouring
// threads on neighbouring addresses, and sum their column's f rows of
// x * w and of w into shared memory.  Phase 2: threads run along the
// coarse cells, sum f neighbouring column sums each, divide and write.
// Sums run in the input's type (float32 sums for float32 input).
//
// What bounds it: memory traffic.  x is read once (the weights, 0.6 MB per
// plane at C384, stay in L2), 2 flops per value read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;  // fine columns a block holds in shared memory

template <typename T>
__global__ void __launch_bounds__(kThreads)
wavg_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ out, int ny, int nx, int f, int nyc, int nxc,
            int cw, int nchunks, long long w_div, long long w_mod) {
  __shared__ T snum[kChunk];
  __shared__ T sden[kChunk];
  long long blk = blockIdx.x;
  const int chunk = (int)(blk % nchunks);
  blk /= nchunks;
  const int yc = (int)(blk % nyc);
  const long long b = blk / nyc;
  const int x0 = chunk * cw;
  const int width = (nx - x0 < cw) ? nx - x0 : cw;
  const long long row0 = (long long)yc * f;
  const T* xb = x + (b * ny + row0) * nx + x0;
  const T* wb = w + (((b / w_div) % w_mod) * ny + row0) * nx + x0;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    T num = T(0), den = T(0);
    for (int r = 0; r < f; ++r) {
      const T wv = __ldg(wb + (long long)r * nx + i);
      num += __ldg(xb + (long long)r * nx + i) * wv;
      den += wv;
    }
    snum[i] = num;
    sden[i] = den;
  }
  __syncthreads();
  const int cells = width / f;
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    T num = T(0), den = T(0);
    for (int k = 0; k < f; ++k) {
      num += snum[c * f + k];
      den += sden[c * f + k];
    }
    out[(b * nyc + yc) * nxc + x0 / f + c] = num / den;
  }
}

template <typename T>
int launch_wavg(const void* x, const void* w, void* out, long long B, int ny,
                int nx, int f, long long w_div, long long w_mod,
                void* stream) {
  if (B == 0 || ny == 0 || nx == 0) return 0;
  if (f < 1 || f > kChunk || ny % f || nx % f || w_div < 1 || w_mod < 1)
    return (int)cudaErrorInvalidValue;
  const int nyc = ny / f, nxc = nx / f;
  const int cw = (kChunk / f) * f;
  const int nchunks = (nx + cw - 1) / cw;
  const long long blocks = B * nyc * nchunks;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  wavg_kernel<T><<<(unsigned int)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      (const T*)x, (const T*)w, (T*)out, ny, nx, f, nyc, nxc, cw, nchunks,
      w_div, w_mod);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fv3_wavg_f32(const void* x, const void* w, void* out,
                            long long B, int ny, int nx, int f,
                            long long w_div, long long w_mod, void* stream) {
  return launch_wavg<float>(x, w, out, B, ny, nx, f, w_div, w_mod, stream);
}

extern "C" int fv3_wavg_f64(const void* x, const void* w, void* out,
                            long long B, int ny, int nx, int f,
                            long long w_div, long long w_mod, void* stream) {
  return launch_wavg<double>(x, w, out, B, ny, nx, f, w_div, w_mod, stream);
}
