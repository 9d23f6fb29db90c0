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
// The search is 33-way: while the range [lo, hi) holds more than 32
// entries, lane j reads the pivot p_j = lo + (j + 1) * len / 33, and
// since the run is sorted, __ballot_sync(keys[p_j] < q) is a prefix
// mask whose popcount c picks the sub-range between two pivots:
// [p_{c-1} + 1, p_c), with lo for p_{-1} + 1 and hi for p_32.  Each
// sub-range holds at most floor(len / 33) entries.  The last <= 32
// entries are read in one round, one a lane, and the popcount of their
// ballot is the exact lower bound.  So a query makes ceil(log33(len +
// 1)) dependent rounds of loads (4 at n = 2^18), where a binary search
// makes ceil(log2(len + 1)) (19).
//
// The window: the warp's 32 lanes copy consecutive entries, a lane
// each, coalesced.  For a point lookup (C = 1) the last search round
// reads values beside keys, so the entry comes from a lane by shuffle
// and no load waits on the lower bound.  (Four entries a lane, their
// valid bytes stored as one 32-bit word and their keys and values as
// 16-byte pairs, was slower at C = 128 on an H100, and so were the
// first 32 entries of every window taken by shuffle:
// tools/search_variants.py.)
//
// What bounds it on an H100: a point lookup (C = 1) makes the search's
// dependent rounds and writes 17 bytes, so it is latency-bound; a
// YCSB-E scan (C = 128) also writes a [Q, 128] window of 17 bytes a
// lane, 8.9 MB at Q = 4096, the part that meets HBM bandwidth.
//
// The shard axis (scan_window_rows): the sharded mesh read path
// (distributed/mesh.py) stacks every shard's sorted run end to end in one
// array, each at its own length, and gives every query row the base
// offset and live length of its own shard's run.  Row i then searches
// keys[base[i], base[i] + length[i]) and its window stops at that run's
// end, so one launch answers all S shards.  It replaces the JAX package's
// vmapped lower bound in src/repro/distributed/mesh.py
// (_probe_one_shard), which pads every run to a common power of two.
// The single-run entry point (scan_window) is the same kernel with base
// 0 and length n for every row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWays = kWarp + 1;  // sub-ranges a round splits into
constexpr int kBlock = 128;
constexpr int kWarpsPerBlock = kBlock / kWarp;
constexpr unsigned kFull = 0xffffffffu;

// Narrows [lo, hi) by 33-way rounds until it holds 32 entries or fewer
// and still holds the first index whose key is >= q (or ends at it);
// every lane of the warp takes part and gets the same range.
__device__ __forceinline__ void narrow(const int64_t* __restrict__ keys,
                                       long long& lo, long long& hi,
                                       long long q, int lane) {
  while (hi - lo > kWarp) {
    // under 2^26 entries the pivot takes 32-bit arithmetic (faster by
    // 2-4% on an H100: tools/search_variants.py)
    const long long len = hi - lo;
    const long long p =
        lo + (len < (1ll << 26)
                  ? static_cast<long long>(static_cast<unsigned>(lane + 1) *
                                           static_cast<unsigned>(len) /
                                           static_cast<unsigned>(kWays))
                  : (lane + 1) * len / kWays);
    const int c = __popc(__ballot_sync(
        kFull, static_cast<long long>(__ldg(keys + p)) < q));
    const long long below = __shfl_sync(kFull, p, c > 0 ? c - 1 : 0);
    const long long above = __shfl_sync(kFull, p, c < kWarp ? c : 0);
    if (c > 0) lo = below + 1;
    if (c < kWarp) hi = above;
  }
}

// kRows: row i searches keys[base[i], base[i] + length[i]); otherwise
// every row searches keys[0, n).
template <bool kRows>
__global__ void __launch_bounds__(kBlock)
scan_window_kernel(const int64_t* __restrict__ queries,
                   const int32_t* __restrict__ counts,
                   const int64_t* __restrict__ base,
                   const int64_t* __restrict__ length,
                   const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ vals, int64_t n_queries,
                   int64_t n, int max_count, bool* __restrict__ valid,
                   int64_t* __restrict__ okeys, int64_t* __restrict__ ovals) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (i >= n_queries) return;
  const long long q = __ldg(queries + i);
  const int count = __ldg(counts + i);
  long long lo = kRows ? __ldg(base + i) : 0;
  const long long end = kRows ? lo + __ldg(length + i) : n;
  long long hi = end;
  narrow(keys, lo, hi, q, lane);
  // the last round: lane j reads entry lo + j wherever it lies in the
  // run, and the popcount of the ballot is the lower bound; a point
  // lookup (C = 1) reads the value beside the key
  const long long at = lo + lane;
  const bool in = at < end;
  const long long k = in ? static_cast<long long>(__ldg(keys + at)) : 0;
  const long long v =
      in && max_count == 1 ? static_cast<long long>(__ldg(vals + at)) : 0;
  const int below = __popc(__ballot_sync(kFull, lane < hi - lo && k < q));
  const long long lb = lo + below;
  const int64_t row = i * max_count;
  if (max_count == 1) {  // the entry comes from lane `below` by shuffle
    const long long k0 = __shfl_sync(kFull, k, below % kWarp);
    const long long v0 = __shfl_sync(kFull, v, below % kWarp);
    if (lane == 0) {
      const bool ok = count > 0 && lb < end;
      long long k1 = k0, v1 = v0;
      if (ok && below == kWarp) {  // entry lo + 32: no lane read it
        k1 = __ldg(keys + lb);
        v1 = __ldg(vals + lb);
      }
      valid[row] = ok;
      okeys[row] = ok ? k1 : 0;
      ovals[row] = ok ? v1 : 0;
    }
    return;
  }
  for (int j = lane; j < max_count; j += kWarp) {
    const long long pos = lb + j;
    const bool ok = j < count && pos < end;
    valid[row + j] = ok;
    okeys[row + j] = ok ? __ldg(keys + pos) : 0;
    ovals[row + j] = ok ? __ldg(vals + pos) : 0;
  }
}

unsigned grid_for(long long n_queries) {
  return static_cast<unsigned>((n_queries + kWarpsPerBlock - 1) /
                               kWarpsPerBlock);
}

}  // namespace

// C interface, loaded with ctypes.  valid, okeys and ovals are [Q, C].
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int scan_window(const void* queries, const void* counts,
                           const void* keys, const void* vals,
                           long long n_queries, long long n, int max_count,
                           void* valid, void* okeys, void* ovals,
                           void* stream) {
  if (n_queries <= 0) return 0;
  if (max_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  scan_window_kernel<false>
      <<<grid_for(n_queries), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int64_t*>(queries),
          static_cast<const int32_t*>(counts), nullptr, nullptr,
          static_cast<const int64_t*>(keys),
          static_cast<const int64_t*>(vals), n_queries, n, max_count,
          static_cast<bool*>(valid), static_cast<int64_t*>(okeys),
          static_cast<int64_t*>(ovals));
  return static_cast<int>(cudaGetLastError());
}

// The shard axis: row i searches keys[base[i], base[i] + length[i]),
// which must lie within the n entries of keys and vals.
extern "C" int scan_window_rows(const void* queries, const void* counts,
                                const void* base, const void* length,
                                const void* keys, const void* vals,
                                long long n_queries, long long n,
                                int max_count, void* valid, void* okeys,
                                void* ovals, void* stream) {
  if (n_queries <= 0) return 0;
  if (max_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  scan_window_kernel<true>
      <<<grid_for(n_queries), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int64_t*>(queries),
          static_cast<const int32_t*>(counts),
          static_cast<const int64_t*>(base),
          static_cast<const int64_t*>(length),
          static_cast<const int64_t*>(keys),
          static_cast<const int64_t*>(vals), n_queries, n, max_count,
          static_cast<bool*>(valid), static_cast<int64_t*>(okeys),
          static_cast<int64_t*>(ovals));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scan_window_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
