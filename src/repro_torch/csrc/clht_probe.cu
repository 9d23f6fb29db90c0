// The 32-bit tag probe, in two forms that share the compare and the
// first-hit rule: for each query, the first lane in chain order whose key
// equals the query, and that lane's value.
//
// Replaces, in the JAX package, src/repro/kernels/clht_probe/kernel.py
// clht_probe (_probe_kernel) and the XLA gather that feeds it in
// kernels/clht_probe/ops.py tag_lookup.  The TPU form gathers each
// query's window of WINDOW = 128 lanes (its bucket and up to 3 chained
// rows of 3 slots, 12 lanes, then 116 lanes of zeros), compares a tile of
// 256 queries against their [256, 128] windows on the VPU, takes the
// first hit with an argmax over the hit mask and a one-hot select, and
// asserts Q % 256 == 0.
//
// clht_probe, the window form (the TPU kernel's body): pre-gathered
// windows [Q, W], one warp a query; lane i compares columns i, i + 32,
// ... 32 at a time in order, and a ballot over each group of 32 is the
// hit mask whose lowest set bit is the first hit; the warp stops at the
// first group that hits.
//
// tag_probe, the whole lookup: one thread a query, from the table itself
// (keys and values [R, kSlots], the next row [R], -1 none).  The thread
// hashes its query in registers (z = uint32(q) * 0x9E3779B9,
// z ^= z >> 16, z % n_buckets) and walks at most kChainDepth rows from
// its bucket.  A row is one dependent round: its kSlots keys, kSlots
// values and next row issued together, the keys compared into a hit
// mask, and the walk stops at the first hit.  A dead row (next row -1)
// reads as kSlots lanes of key 0 and value 0, and so does every lane past
// the chain, up to WINDOW: a query that found nothing in the live rows is
// found with value 0 exactly when it is 0.  A tag stored twice returns
// the first value in chain order.  (One packed 32-byte line a row, two
// 16-byte loads a round, took 0.001917 ms at Q = 4096 on the tag path's
// 2^18 buckets on an H100 against 0.002316 ms here, but needs a second
// copy of the table kept in step with it: tools/route_tag_variants.py
// times it.)
//
// What bounds it on an H100: the bytes a query needs, its query, the rows
// it walks up to its hit (16 bytes a row: the keys and the next row), its
// value and its outputs (5 bytes), some 0.12 MB at Q = 4096, 0.04 us at
// 3.35 TB/s.  In practice a
// launch and one or two dependent rounds a query: the window form also
// needs the [Q, 128] windows built beforehand (two 2 MB tensors at
// Q = 4096, some 40 PyTorch operations), which tag_probe does not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // the window form: queries per block of 256
constexpr int kSlots = 3;
constexpr int kChainDepth = 4;  // the bucket and up to 3 chained rows
constexpr int kTagThreads = 128;  // tag_probe: queries per block
constexpr unsigned kHashMul = 0x9E3779B9u;
static_assert(kSlots == 3, "tag_probe selects among three values");

// The first hit of a hit mask (bit i: lane i's key equals the query), or
// -1: the TPU kernel's argmax over its hit mask.
__device__ __forceinline__ int first_hit(unsigned mask) {
  return mask ? __ffs(mask) - 1 : -1;
}

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
  for (int c0 = 0; c0 < width && hit < 0; c0 += 32) {
    const int c = c0 + lane;
    const int first =
        first_hit(__ballot_sync(0xffffffffu, c < width && row[c] == query));
    if (first >= 0) hit = c0 + first;
  }
  if (lane == 0) {
    found[q] = hit >= 0;
    values[q] = hit >= 0 ? vals[static_cast<size_t>(q) * width + hit] : 0;
  }
}

__global__ void __launch_bounds__(kTagThreads)
tag_probe_kernel(const int32_t* __restrict__ queries,
                 const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ vals,
                 const int32_t* __restrict__ nxt, int n_queries,
                 unsigned n_buckets, bool* __restrict__ found,
                 int32_t* __restrict__ values) {
  const int i = blockIdx.x * kTagThreads + threadIdx.x;
  if (i >= n_queries) return;
  const int32_t q = __ldg(queries + i);
  unsigned z = static_cast<unsigned>(q) * kHashMul;
  z ^= z >> 16;
  int row = static_cast<int>(z % n_buckets);
  for (int d = 0; d < kChainDepth && row >= 0; ++d) {
    const size_t at = static_cast<size_t>(row) * kSlots;
    int32_t k[kSlots], v[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      k[s] = __ldg(keys + at + s);
      v[s] = __ldg(vals + at + s);
    }
    const int next = __ldg(nxt + row);
    unsigned mask = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      mask |= static_cast<unsigned>(k[s] == q) << s;
    const int hit = first_hit(mask);
    if (hit >= 0) {
      found[i] = true;
      values[i] = hit == 0 ? v[0] : hit == 1 ? v[1] : v[2];
      return;
    }
    row = next;
  }
  found[i] = q == 0;  // a dead row's lanes, or the window's padding
  values[i] = 0;
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

// queries: [n_queries] int32; keys, vals: [rows, kSlots] int32; nxt:
// [rows] int32, each -1 or a row; 0 < n_buckets <= rows.  found:
// [n_queries] bool; values: [n_queries] int32.  All contiguous.
extern "C" int tag_probe(const void* queries, const void* keys,
                         const void* vals, const void* nxt, int n_queries,
                         unsigned n_buckets, void* found, void* values,
                         void* stream) {
  if (n_queries <= 0) return 0;
  if (n_buckets == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_queries + kTagThreads - 1) / kTagThreads;
  tag_probe_kernel<<<blocks, kTagThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(queries), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(nxt),
      n_queries, n_buckets, static_cast<bool*>(found),
      static_cast<int32_t*>(values));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* clht_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
