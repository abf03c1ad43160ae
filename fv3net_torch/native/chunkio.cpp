// Threaded zarr chunk assembler.
//
// The reference's data path leans on dask worker pools + the zarr-python
// C codecs for chunked reads (reference: external/vcm xarray/zarr usage
// throughout).  This framework's pure-python zarr store (core/zarrio.py)
// reads chunks serially under the GIL; this native module provides the
// production read path: a thread pool that, per chunk, reads the file,
// zlib-inflates if needed, and strided-copies into the destination
// array, entirely outside the GIL.
//
// C ABI only (loaded via ctypes; no pybind11 in this image).
//
// Build (fv3net_torch/native/__init__.py does it at first use, into
// fv3net_torch/_build/): g++ -O3 -shared -fPIC -std=c++17 -o LIB.so
// chunkio.cpp -lz -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

struct ChunkJob {
  const char* path;       // may be null -> fill with fill_value
  const int64_t* start;   // ndim element offsets into the output
};

// copy a chunk (possibly clipped at array edges) into the output
void copy_chunk(const char* src, char* out, const int64_t* start,
                const int64_t* chunk_shape, const int64_t* out_shape,
                int ndim, int itemsize) {
  // compute clipped extents per dim
  std::vector<int64_t> extent(ndim);
  for (int d = 0; d < ndim; ++d) {
    int64_t e = chunk_shape[d];
    if (start[d] + e > out_shape[d]) e = out_shape[d] - start[d];
    if (e < 0) e = 0;
    extent[d] = e;
  }
  // strides in elements
  std::vector<int64_t> out_stride(ndim, 1), chunk_stride(ndim, 1);
  for (int d = ndim - 2; d >= 0; --d) {
    out_stride[d] = out_stride[d + 1] * out_shape[d + 1];
    chunk_stride[d] = chunk_stride[d + 1] * chunk_shape[d + 1];
  }
  int64_t inner = extent[ndim - 1] * itemsize;
  if (inner <= 0) return;
  // iterate over all outer index combinations
  std::vector<int64_t> idx(ndim - 1, 0);
  while (true) {
    int64_t src_off = 0, dst_off = 0;
    for (int d = 0; d < ndim - 1; ++d) {
      src_off += idx[d] * chunk_stride[d];
      dst_off += (start[d] + idx[d]) * out_stride[d];
    }
    dst_off += start[ndim - 1];
    std::memcpy(out + (dst_off)*itemsize + 0,
                src + (src_off + 0) * itemsize, inner);
    // increment odometer
    int d = ndim - 2;
    for (; d >= 0; --d) {
      if (++idx[d] < extent[d]) break;
      idx[d] = 0;
    }
    if (d < 0) break;
    if (ndim == 1) break;
  }
}

}  // namespace

extern "C" int assemble_chunks(
    const char** paths, int n_chunks, const int64_t* chunk_starts,
    const int64_t* chunk_shape, const int64_t* out_shape, int ndim,
    int compressed, double fill_value, int itemsize, int is_float,
    char* out, int n_threads) {
  // pre-fill with fill_value
  int64_t total = 1;
  for (int d = 0; d < ndim; ++d) total *= out_shape[d];
  if (fill_value == 0.0) {
    std::memset(out, 0, total * itemsize);
  } else {
    // element-wise fill of the first element then pattern copy
    std::vector<char> pat(itemsize, 0);
    if (is_float && itemsize == 4) {
      float v = (float)fill_value;
      std::memcpy(pat.data(), &v, 4);
    } else if (is_float && itemsize == 8) {
      std::memcpy(pat.data(), &fill_value, 8);
    } else {
      int64_t v = (int64_t)fill_value;
      std::memcpy(pat.data(), &v, itemsize < 8 ? itemsize : 8);
    }
    for (int64_t i = 0; i < total; ++i)
      std::memcpy(out + i * itemsize, pat.data(), itemsize);
  }

  int64_t chunk_elems = 1;
  for (int d = 0; d < ndim; ++d) chunk_elems *= chunk_shape[d];
  const int64_t chunk_bytes = chunk_elems * itemsize;

  std::atomic<int> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    std::vector<char> raw;
    std::vector<char> buf((size_t)chunk_bytes);
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_chunks) return;
      const char* path = paths[i];
      if (path == nullptr) continue;  // missing chunk stays at fill
      FILE* f = std::fopen(path, "rb");
      if (!f) continue;  // treat unreadable as missing
      std::fseek(f, 0, SEEK_END);
      long sz = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      raw.resize(sz);
      if ((long)std::fread(raw.data(), 1, sz, f) != sz) {
        std::fclose(f);
        err.store(1);
        continue;
      }
      std::fclose(f);
      const char* data;
      if (compressed) {
        uLongf dest_len = (uLongf)chunk_bytes;
        if (uncompress((Bytef*)buf.data(), &dest_len, (const Bytef*)raw.data(),
                       (uLong)sz) != Z_OK) {
          err.store(2);
          continue;
        }
        data = buf.data();
      } else {
        if (sz != chunk_bytes) {
          err.store(3);
          continue;
        }
        data = raw.data();
      }
      copy_chunk(data, out, chunk_starts + (int64_t)i * ndim, chunk_shape,
                 out_shape, ndim, itemsize);
    }
  };

  int nt = n_threads > 0 ? n_threads : 4;
  if (nt > n_chunks) nt = n_chunks > 0 ? n_chunks : 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return err.load();
}

extern "C" int write_chunks(
    const char** paths, int n_chunks, const char** bufs,
    const int64_t* nbytes, int compress_level, int n_threads) {
  // The write-side twin of assemble_chunks: a thread pool that, per
  // chunk, optionally zlib-deflates the buffer and writes the file --
  // the parallel store path behind zarrio batch writes (the
  // pace.util.ZarrMonitor per-rank write role, reference
  // runtime/diagnostics/manager.py:58-60), entirely outside the GIL.
  std::atomic<int> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    std::vector<char> out;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_chunks) return;
      const char* data = bufs[i];
      int64_t sz = nbytes[i];
      const char* to_write = data;
      uLongf out_len = 0;
      if (compress_level > 0) {
        uLongf bound = compressBound((uLong)sz);
        out.resize(bound);
        out_len = bound;
        if (compress2((Bytef*)out.data(), &out_len, (const Bytef*)data,
                      (uLong)sz, compress_level) != Z_OK) {
          err.store(2);
          continue;
        }
        to_write = out.data();
        sz = (int64_t)out_len;
      }
      // write to a temp name then rename: readers never see torn chunks
      std::string tmp = std::string(paths[i]) + ".tmp";
      FILE* f = std::fopen(tmp.c_str(), "wb");
      if (!f) {
        err.store(1);
        continue;
      }
      if ((int64_t)std::fwrite(to_write, 1, sz, f) != sz) {
        std::fclose(f);
        std::remove(tmp.c_str());
        err.store(1);
        continue;
      }
      std::fclose(f);
      if (std::rename(tmp.c_str(), paths[i]) != 0) {
        std::remove(tmp.c_str());
        err.store(1);
      }
    }
  };

  int nt = n_threads > 0 ? n_threads : 4;
  if (nt > n_chunks) nt = n_chunks > 0 ? n_chunks : 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return err.load();
}
