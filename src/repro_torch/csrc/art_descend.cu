// Batched radix descent over P-ART / P-HOT node pages, one thread per
// query.
//
// Replaces, in the JAX package, src/repro/kernels/art_probe/kernel.py
// art_descend (_descend_kernel).  The TPU form walks a tile of queries in
// lockstep over int32 (lo, hi) halves of the leaf words, with the key
// units precomputed on the host as a [Q, U] array and the batch padded
// to whole blocks.  Here 64-bit words are native, each thread takes its
// key units from the query word with a logical shift, and exactly Q
// threads run.
//
// Semantics, bit for bit those of the TPU kernel (U = 64 / unit_bits):
//   * walk from node 0 for at most U + 1 steps;
//   * at a leaf: count it (nenc); if lfp[node] equals the query's
//     partial-key byte (low byte, 0 remapped to 1) count an fp match
//     (nfp); a full-key match with a value != 0 is the hit, any other fp
//     match counts as an fp false positive (nfalse); the walk stops;
//   * otherwise lvl = clamp(level[node], 0, U - 1), the unit is
//     (uint64(q) >> (unit_bits * (U - 1 - lvl))) & (2^unit_bits - 1),
//     and the walk hops to children[node * fan + unit], stopping on -1.
//     A child outside [0, n_nodes) also stops it (memory safety only:
//     the caller's export never produces one).
//
// What bounds it on an H100: a batch of Q = 4096 queries reads a few
// words per visited node (level, is_leaf, one child) and the leaf's
// fingerprint, key and value: well under 1 MB, so neither HBM bandwidth
// nor arithmetic is the limit.  Each step is a load that depends on the
// previous one, up to 9 (P-ART) or 17 (P-HOT) of them.  At 2^20 keys
// the P-ART child table is about 1.2 GB, far larger than the 50 MB L2:
// only the top levels stay cached, so most hops are HBM latency.  The
// launch costs the latency of that chain of loads plus launch overhead.
//
// Left for later: 4096 threads fill about 32 of the 132 SMs; issuing
// several batches per launch, or interleaving independent queries per
// thread, would hide more of the load latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

template <int kUnitBits>
__global__ void __launch_bounds__(kBlock)
art_descend_kernel(const int64_t* __restrict__ queries,
                   const int32_t* __restrict__ children,
                   const int32_t* __restrict__ level,
                   const uint8_t* __restrict__ is_leaf,
                   const uint8_t* __restrict__ lfp,
                   const int64_t* __restrict__ leaf_key,
                   const int64_t* __restrict__ leaf_val, int64_t n_queries,
                   int64_t n_nodes, bool* __restrict__ found,
                   int64_t* __restrict__ values, int32_t* __restrict__ nenc,
                   int32_t* __restrict__ nfp, int32_t* __restrict__ nfalse) {
  constexpr int kUnits = 64 / kUnitBits;
  constexpr int kFan = 1 << kUnitBits;
  constexpr uint64_t kMask = kFan - 1;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n_queries) return;
  const int64_t q = queries[i];
  const uint64_t uq = static_cast<uint64_t>(q);
  uint32_t qfp = static_cast<uint32_t>(uq & 0xFFull);
  if (qfp == 0) qfp = 1;
  int64_t node = 0;
  bool hit = false;
  int64_t value = 0;
  int32_t n_enc = 0, n_match = 0, n_false = 0;
  for (int step = 0; step <= kUnits; ++step) {
    if (is_leaf[node] != 0) {
      ++n_enc;
      if (lfp[node] == qfp) {
        ++n_match;
        const int64_t v = leaf_val[node];
        if (leaf_key[node] == q && v != 0) {
          hit = true;
          value = v;
        } else {
          ++n_false;
        }
      }
      break;
    }
    int lvl = level[node];
    lvl = lvl < 0 ? 0 : (lvl > kUnits - 1 ? kUnits - 1 : lvl);
    const uint64_t unit = (uq >> (kUnitBits * (kUnits - 1 - lvl))) & kMask;
    const int64_t child = children[node * kFan + static_cast<int64_t>(unit)];
    if (child < 0 || child >= n_nodes) break;
    node = child;
  }
  found[i] = hit;
  values[i] = value;
  nenc[i] = n_enc;
  nfp[i] = n_match;
  nfalse[i] = n_false;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a unit width other than 8 or 4).
extern "C" int art_descend(const void* queries, const void* children,
                           const void* level, const void* is_leaf,
                           const void* lfp, const void* leaf_key,
                           const void* leaf_val, long long n_queries,
                           long long n_nodes, int unit_bits, void* found,
                           void* values, void* nenc, void* nfp, void* nfalse,
                           void* stream) {
  if (n_queries <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n_queries + kBlock - 1) / kBlock));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int64_t*>(queries);
  const auto* c = static_cast<const int32_t*>(children);
  const auto* lv = static_cast<const int32_t*>(level);
  const auto* lf = static_cast<const uint8_t*>(is_leaf);
  const auto* fp = static_cast<const uint8_t*>(lfp);
  const auto* lk = static_cast<const int64_t*>(leaf_key);
  const auto* lval = static_cast<const int64_t*>(leaf_val);
  auto* f = static_cast<bool*>(found);
  auto* v = static_cast<int64_t*>(values);
  auto* ne = static_cast<int32_t*>(nenc);
  auto* nf = static_cast<int32_t*>(nfp);
  auto* nx = static_cast<int32_t*>(nfalse);
  if (unit_bits == 8) {
    art_descend_kernel<8><<<grid, kBlock, 0, s>>>(
        q, c, lv, lf, fp, lk, lval, n_queries, n_nodes, f, v, ne, nf, nx);
  } else if (unit_bits == 4) {
    art_descend_kernel<4><<<grid, kBlock, 0, s>>>(
        q, c, lv, lf, fp, lk, lval, n_queries, n_nodes, f, v, ne, nf, nx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* art_descend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
