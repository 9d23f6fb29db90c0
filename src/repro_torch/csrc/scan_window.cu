// Batched sorted-run search: per query a lower bound over a sorted run,
// then a window of up to C consecutive entries.  One warp per query.
//
// Replaces, in the JAX package, src/repro/kernels/scan/kernel.py
// scan_window (_scan_kernel).  The TPU form carries keys as (lo, hi)
// int32 halves with the low halves XOR-biased, pads the run to a power
// of two and the batch to whole blocks, and runs a fixed number of
// lockstep halvings.  Here 64-bit words are native, the run is used at
// its own length n, and exactly Q queries run.
//
// Semantics, bit for bit those of the TPU kernel:
//   * lb = the first index in [0, n) whose key is >= the query, n if
//     none.  The order is SIGNED int64: the TPU kernel compares the high
//     half as a signed int32 and the biased low half, which is signed
//     64-bit order, the order of np.searchsorted on int64.  A query of
//     2^63 or above (negative as int64) gets lb = 0;
//   * lane j < C of the row: valid = j < count && lb + j < n; key and
//     value of entry lb + j where valid, 0 elsewhere.
//
// What bounds it on an H100: a point lookup (C = 1) reads about
// log2(n) keys per query along a chain of dependent loads (18 at
// n = 2^18) and writes 17 bytes, so it is latency-bound like the probe
// kernels.  A YCSB-E scan (C = 128) also writes a [Q, 128] window of
// 17 bytes a lane, 8.9 MB at Q = 4096: the window copy is the part that
// meets HBM bandwidth.  So each warp runs the search once (all lanes
// the same addresses, served as broadcasts) and then copies its window
// with its 32 lanes on consecutive entries, coalesced.
//
// Left for later: a 32-way search (each lane reads one pivot, a ballot
// picks the sub-range) would cut the dependent loads from log2(n) to
// log32(n).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 128;
constexpr int kWarpsPerBlock = kBlock / kWarp;

__global__ void __launch_bounds__(kBlock)
scan_window_kernel(const int64_t* __restrict__ queries,
                   const int32_t* __restrict__ counts,
                   const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ vals, int64_t n_queries,
                   int64_t n, int max_count, bool* __restrict__ valid,
                   int64_t* __restrict__ okeys, int64_t* __restrict__ ovals) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (i >= n_queries) return;
  const long long q = queries[i];
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (static_cast<long long>(keys[mid]) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int count = counts[i];
  const int64_t row = i * max_count;
  for (int j = lane; j < max_count; j += kWarp) {
    const long long pos = lo + j;
    const bool ok = j < count && pos < n;
    valid[row + j] = ok;
    okeys[row + j] = ok ? keys[pos] : 0;
    ovals[row + j] = ok ? vals[pos] : 0;
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int scan_window(const void* queries, const void* counts,
                           const void* keys, const void* vals,
                           long long n_queries, long long n, int max_count,
                           void* valid, void* okeys, void* ovals,
                           void* stream) {
  if (n_queries <= 0) return 0;
  if (max_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(
      (n_queries + kWarpsPerBlock - 1) / kWarpsPerBlock));
  scan_window_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(queries),
      static_cast<const int32_t*>(counts), static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(vals), n_queries, n, max_count,
      static_cast<bool*>(valid), static_cast<int64_t*>(okeys),
      static_cast<int64_t*>(ovals));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scan_window_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
