// Chained 64-bit probe over a P-CLHT snapshot's line table, one thread
// per query.
//
// Replaces, in the JAX package, src/repro/kernels/probe/kernel.py
// probe64_fp (fingerprints on) and probe64 (fingerprints off), together
// with the XLA chain-window gather that feeds them,
// src/repro/kernels/clht_probe/ops.py _gather_probe.  The TPU form
// materialises a [Q, depth*3] window per array as (lo, hi) int32 halves
// before the kernel compares it in one pass.  Here the window is laid
// out once an epoch (kernels/probe/layout.py): one 64-byte line per row
// (w0-2 keys, w3-5 values, w6 the line where the rest of the row's chain
// starts, w7 the three fingerprint bytes and, from bit 32, the number of
// rows after it), and after the rows a region that holds each chain's
// rows after its head, copied in hop order.
//
// Semantics, bit for bit those of the windowed form:
//   * hop 0 reads the start line `bucket`, hop h >= 1 the h-th row after
//     it in its chain; once the chain has ended every lane reads key 0,
//     value 0, fp 0;
//   * with fingerprints, a lane is a candidate when its fp byte equals
//     the query's, and a hit when it is a candidate and its key equals
//     the query; without, a hit is a key match;
//   * the first hit in hop-major, slot-minor order gives the value;
//   * nfp and nfalse count candidates and candidates that are not hits
//     over all depth*3 lanes, the lanes past the chain's end included.
//     Key 0 has fingerprint 0, so it matches empty slots and those
//     lanes, exactly as the reference does; those lanes are counted
//     arithmetically, never loaded.
//
// What bounds it on an H100: at Q = 4096 queries it reads and writes
// well under 1 MB, so neither the 3.35 TB/s of HBM nor arithmetic is the
// limit: a launch costs its fixed cost (0.00085 ms for an empty kernel
// over 4096 threads) plus its dependent load rounds times the latency of
// a round (0.00019 ms for a line in the 50 MB L2, 0.0006 ms for one that
// is not; tools/index_variants.py, NVIDIA H100 80GB HBM3 at 700 W).  The
// design makes three rounds at any depth up to 1 + kGroup: the query and
// its bucket, the start line, and then the chain's remaining lines,
// whose addresses the start line gives, all loaded together (kGroup at a
// time, so a long chain stays in registers; one more round per kGroup
// lines beyond).  Keys, values and fingerprints share a line, so a hop
// is one round with or without the fingerprint filter (the walk over
// `nxt` made one round a hop, two with fingerprints: 9 rounds at depth
// 4).  That is a floor of 0.0014-0.0027 ms at depth 4; the kernel takes
// about 0.0026-0.0028.  Lines linked only by w6 (one round a hop) were
// 0.00026 ms slower at depth 4, kGroup = 8 0.00017 ms slower (78 to 134
// registers), and blocks of 32 or 128 threads within 2% of 64.  Lines
// are read as 16-byte non-coherent vectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // threads a block: 4096 queries on 64 SMs
constexpr int kSlots = 3;
constexpr int kGroup = 4;   // lines loaded together in one round
constexpr int kCountShift = 32;

struct Line {
  longlong2 k01, k2v0, v12, nx;  // w0 w1 | w2 w3 | w4 w5 | w6 w7
};

__device__ __forceinline__ Line load_line(const longlong2* __restrict__ t,
                                          int64_t line) {
  const longlong2* p = t + line * 4;
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}

__device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// kernels/probe/fingerprint.py fp64: 0 for key 0, else the splitmix64
// top byte with 0 remapped to 1.
__device__ __forceinline__ uint32_t fp64(int64_t key) {
  if (key == 0) return 0;
  const uint32_t fp =
      static_cast<uint32_t>(mix64(static_cast<uint64_t>(key)) >> 56);
  return fp == 0 ? 1 : fp;
}

struct Probe {
  bool hit_any = false;
  int64_t value = 0;
  int32_t n_match = 0, n_false = 0;
};

template <bool kUseFp>
__device__ __forceinline__ void visit(const Line& l, int64_t q, uint32_t qfp,
                                      Probe& p) {
  const int64_t key[kSlots] = {l.k01.x, l.k01.y, l.k2v0.x};
  const int64_t val[kSlots] = {l.k2v0.y, l.v12.x, l.v12.y};
  const uint64_t fps = static_cast<uint64_t>(l.nx.y);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (kUseFp && ((fps >> (8 * s)) & 0xFFu) != qfp) continue;
    const bool hit = key[s] == q;
    if (kUseFp) {
      ++p.n_match;
      p.n_false += !hit;
    }
    if (hit && !p.hit_any) {
      p.hit_any = true;
      p.value = val[s];
    }
  }
}

template <bool kUseFp>
__global__ void __launch_bounds__(kBlock)
probe_chain_kernel(const int64_t* __restrict__ queries,
                   const int64_t* __restrict__ bucket,
                   const longlong2* __restrict__ lines, int64_t n_queries,
                   int64_t n_lines, int depth, bool* __restrict__ found,
                   int64_t* __restrict__ values, int32_t* __restrict__ nfp,
                   int32_t* __restrict__ nfalse) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n_queries) return;
  const int64_t q = __ldg(queries + i);
  const int64_t start = __ldg(bucket + i);
  const uint32_t qfp = kUseFp ? fp64(q) : 0;
  Probe p;
  int live_hops = 0;
  // a start or a rest outside the table ends the chain (memory safety
  // only: pack_lines never produces one)
  if (start >= 0 && start < n_lines) {
    const Line first = load_line(lines, start);
    visit<kUseFp>(first, q, qfp, p);
    const int64_t next = first.nx.x;
    const int64_t count =
        static_cast<int64_t>(static_cast<uint64_t>(first.nx.y) >> kCountShift);
    int rest = count < depth - 1 ? static_cast<int>(count) : depth - 1;
    if (next < 0 || next + rest > n_lines) rest = 0;
    for (int g = 0; g < rest; g += kGroup) {
      Line ls[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (g + j < rest) ls[j] = load_line(lines, next + g + j);
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (g + j < rest) visit<kUseFp>(ls[j], q, qfp, p);
    }
    live_hops = 1 + rest;
  }
  // lanes past the chain's end: key 0, fp 0, a hit for query 0 only
  if (q == 0 && live_hops < depth) {
    if (kUseFp) p.n_match += kSlots * (depth - live_hops);
    if (!p.hit_any) {
      p.hit_any = true;
      p.value = 0;
    }
  }
  found[i] = p.hit_any;
  values[i] = p.value;
  if (kUseFp) {
    nfp[i] = p.n_match;
    nfalse[i] = p.n_false;
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a table that is not 64-byte aligned).
extern "C" int probe_chain(const void* queries, const void* bucket,
                           const void* lines, long long n_queries,
                           long long n_lines, int depth, int use_fp,
                           void* found, void* values, void* nfp,
                           void* nfalse, void* stream) {
  if (reinterpret_cast<uintptr_t>(lines) % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_queries <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int64_t*>(queries);
  const auto* b = static_cast<const int64_t*>(bucket);
  const auto* t = static_cast<const longlong2*>(lines);
  const dim3 grid(static_cast<unsigned>((n_queries + kBlock - 1) / kBlock));
  auto* f = static_cast<bool*>(found);
  auto* v = static_cast<int64_t*>(values);
  if (use_fp) {
    probe_chain_kernel<true><<<grid, kBlock, 0, s>>>(
        q, b, t, n_queries, n_lines, depth, f, v,
        static_cast<int32_t*>(nfp), static_cast<int32_t*>(nfalse));
  } else {
    probe_chain_kernel<false><<<grid, kBlock, 0, s>>>(
        q, b, t, n_queries, n_lines, depth, f, v, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
