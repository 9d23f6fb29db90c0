// Chained 64-bit probe over a P-CLHT snapshot, one thread per query.
//
// Replaces, in the JAX package, src/repro/kernels/probe/kernel.py
// probe64_fp (fingerprints on) and probe64 (fingerprints off), together
// with the XLA chain-window gather that feeds them,
// src/repro/kernels/clht_probe/ops.py _gather_probe.  The TPU form
// materialises a [Q, depth*3] window per array as (lo, hi) int32 halves;
// here 64-bit words are native and each thread walks its bucket chain
// straight from the snapshot rows, so no window is ever written.
//
// Semantics, bit for bit those of the windowed form:
//   * hop h < depth reads row = bucket (h = 0), then nxt[row]; once the
//     chain has ended (row < 0) every lane reads key 0, value 0, fp 0;
//   * with fingerprints, a lane is a candidate when its fp byte equals
//     the query's, and a hit when it is a candidate and its key equals
//     the query; without, a hit is a key match;
//   * the first hit in hop-major, slot-minor order gives the value;
//   * nfp and nfalse count candidates and candidates that are not hits
//     over all depth*3 lanes, the lanes past the chain's end included.
//     Key 0 has fingerprint 0, so it matches empty slots and those
//     lanes, exactly as the reference does.
//
// What bounds it on an H100: at Q = 4096 queries it reads and writes
// well under 1 MB, so neither the 3.35 TB/s of HBM nor arithmetic is the
// limit.  Each thread makes `depth` dependent loads (nxt) with a few
// loads hanging off each, so a launch costs the latency of that chain
// of loads plus the launch overhead.  Key words are loaded only for
// fingerprint candidates and value words only for the first hit.
//
// Left for later: one thread per query gives 4096 threads in 32 blocks
// of 128, which fill about 32 of the 132 SMs; a warp per query (lanes
// over slots and hops) or many batches per launch would fill the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 3;
constexpr int kBlock = 128;

__device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// kernels/probe/fingerprint.py fp64: 0 for key 0, else the splitmix64
// top byte with 0 remapped to 1.
__device__ __forceinline__ uint8_t fp64(int64_t key) {
  if (key == 0) return 0;
  uint8_t fp = static_cast<uint8_t>(mix64(static_cast<uint64_t>(key)) >> 56);
  return fp == 0 ? 1 : fp;
}

template <bool kUseFp>
__global__ void __launch_bounds__(kBlock)
probe_chain_kernel(const int64_t* __restrict__ queries,
                   const int64_t* __restrict__ bucket,
                   const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ vals,
                   const uint8_t* __restrict__ fps,
                   const int64_t* __restrict__ nxt, int64_t n_queries,
                   int64_t n_rows, int depth, bool* __restrict__ found,
                   int64_t* __restrict__ values, int32_t* __restrict__ nfp,
                   int32_t* __restrict__ nfalse) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n_queries) return;
  const int64_t q = queries[i];
  const uint8_t qfp = kUseFp ? fp64(q) : 0;
  int64_t row = bucket[i];
  bool hit_any = false;
  int64_t value = 0;
  int32_t n_match = 0, n_false = 0;
  for (int h = 0; h < depth; ++h) {
    // a row outside the snapshot ends the chain (memory safety only:
    // the caller's export never produces one)
    const bool live = row >= 0 && row < n_rows;
    const int64_t base = live ? row * kSlots : 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      bool cand = true;
      if (kUseFp) cand = (live ? fps[base + s] : uint8_t(0)) == qfp;
      if (!cand) continue;
      const int64_t k = live ? keys[base + s] : 0;
      const bool hit = k == q;
      if (kUseFp) {
        ++n_match;
        n_false += !hit;
      }
      if (hit && !hit_any) {
        hit_any = true;
        value = live ? vals[base + s] : 0;
      }
    }
    row = live ? nxt[row] : -1;
  }
  found[i] = hit_any;
  values[i] = value;
  if (kUseFp) {
    nfp[i] = n_match;
    nfalse[i] = n_false;
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int probe_chain(const void* queries, const void* bucket,
                           const void* keys, const void* vals,
                           const void* fps, const void* nxt,
                           long long n_queries, long long n_rows, int depth,
                           int use_fp, void* found, void* values, void* nfp,
                           void* nfalse, void* stream) {
  if (n_queries <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n_queries + kBlock - 1) / kBlock));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int64_t*>(queries);
  const auto* b = static_cast<const int64_t*>(bucket);
  const auto* k = static_cast<const int64_t*>(keys);
  const auto* v = static_cast<const int64_t*>(vals);
  const auto* f = static_cast<const uint8_t*>(fps);
  const auto* n = static_cast<const int64_t*>(nxt);
  if (use_fp) {
    probe_chain_kernel<true><<<grid, kBlock, 0, s>>>(
        q, b, k, v, f, n, n_queries, n_rows, depth,
        static_cast<bool*>(found), static_cast<int64_t*>(values),
        static_cast<int32_t*>(nfp), static_cast<int32_t*>(nfalse));
  } else {
    probe_chain_kernel<false><<<grid, kBlock, 0, s>>>(
        q, b, k, v, f, n, n_queries, n_rows, depth,
        static_cast<bool*>(found), static_cast<int64_t*>(values), nullptr,
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
