// The 32-bit tag probe: for each query, the first lane of its window
// whose key equals the query, and that lane's value.  One warp per query.
//
// Replaces, in the JAX package, src/repro/kernels/clht_probe/kernel.py
// clht_probe (_probe_kernel).  The TPU form compares a tile of 256
// queries against their [256, W] windows on the VPU, takes the first hit
// with an argmax over the hit mask and a one-hot select, and asserts
// Q % 256 == 0.  Here each warp takes one query: lane i compares columns
// i, i + 32, ... of the window, 32 at a time in order, and a ballot over
// each group of 32 gives the first hit (the lowest set bit) without a
// reduction; the warp stops at the first group that hits.  Q takes any
// value.
//
// Semantics, those of the TPU kernel: found[q] = any(keys[q, :] ==
// query[q]); value[q] = vals[q, first hit] when found, else 0.  Lanes
// that pad a window are key 0, so query 0 hits the first padding lane
// (or an empty slot) and comes back found with value 0, as in the TPU
// kernel and its oracle.
//
// What bounds it on an H100: the windows it reads.  At 4096 queries of
// 128 lanes the two int32 windows are 4 MB (1.3 us at HBM bandwidth);
// a query that hits at lane j needs only lanes 0..j of its keys and one
// value, so on hit-heavy data far less.  A warp reads its 32 keys in one
// 128-byte transaction and the value with one more load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // queries per block of 256 threads

__global__ void __launch_bounds__(kWarps * 32)
clht_probe_kernel(const int32_t* __restrict__ queries,
                  const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ vals, bool* __restrict__ found,
                  int32_t* __restrict__ values, int n_queries, int width) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= n_queries) return;
  const int32_t query = queries[q];
  const int32_t* row = keys + static_cast<size_t>(q) * width;
  int hit = -1;
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    const unsigned mask =
        __ballot_sync(0xffffffffu, c < width && row[c] == query);
    if (mask) {
      hit = c0 + __ffs(mask) - 1;
      break;
    }
  }
  if (lane == 0) {
    found[q] = hit >= 0;
    values[q] = hit >= 0 ? vals[static_cast<size_t>(q) * width + hit] : 0;
  }
}

}  // namespace

// C interface, loaded with ctypes.  queries: [n_queries] int32; keys,
// vals: [n_queries, width] int32; found: [n_queries] bool (one byte);
// values: [n_queries] int32; all contiguous.  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int clht_probe(const void* queries, const void* keys,
                          const void* vals, void* found, void* values,
                          int n_queries, int width, void* stream) {
  if (n_queries <= 0) return 0;
  if (width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_queries + kWarps - 1) / kWarps;
  clht_probe_kernel<<<blocks, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(queries), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(vals), static_cast<bool*>(found),
      static_cast<int32_t*>(values), n_queries, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* clht_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
