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
// The child table is packed once an epoch (kernels/art_probe/ops.py
// pack_children): each entry that names a child in [0, n_nodes) carries
// the child's row in bits 0-25, its level clamped to [0, U - 1] in bits
// 26-29 and its leaf bit in bit 30; every other entry is -1.  The root's
// header (the same level and leaf bits, shifted down by 26) is an
// argument.
//
// Semantics, bit for bit those of the TPU kernel (U = 64 / unit_bits):
//   * walk from node 0 for at most U + 1 steps;
//   * at a leaf: count it (nenc); if lfp[node] equals the query's
//     partial-key byte (low byte, 0 remapped to 1) count an fp match
//     (nfp); a full-key match with a value != 0 is the hit, any other fp
//     match counts as an fp false positive (nfalse); the walk stops;
//   * otherwise, with lvl the node's clamped level, the unit is
//     (uint64(q) >> (unit_bits * (U - 1 - lvl))) & (2^unit_bits - 1),
//     and the walk hops to the entry children[node * fan + unit],
//     stopping on -1.  An entry whose row lies outside [0, n_nodes) also
//     stops it (memory safety only: pack_children never produces one).
//
// What bounds it on an H100: a batch of Q = 4096 queries reads one
// entry per inner node it visits and the leaf's fingerprint, key and
// value: well under 1 MB, so neither HBM bandwidth nor arithmetic is the
// limit.  A launch costs its fixed cost (0.00085 ms for an empty kernel)
// plus its dependent load rounds times the latency of a round: 0.00019
// ms in the 50 MB L2, where P-HOT's 23 MB child table and P-ART's top
// levels stay, 0.0006 ms over the rest of P-ART's 0.64 GB table
// (tools/index_variants.py, NVIDIA H100 80GB HBM3 at 700 W).  The design
// makes a step one load: the entry gives the next row and what to do
// there, so no level or leaf load sits between two entries (the walk
// over `is_leaf`, `level` and `children` made 2-3 rounds a step).  At a
// leaf the fingerprint byte, the key and the value load together.  The
// root's row is read like any other: every warp after an SM's first finds
// it in L1.  The slowest query of a batch makes 7 rounds on P-ART and 9
// on P-HOT (4.0 and 6.7 on average), against about 13 and 15 before, a
// floor of 0.0022-0.0051 and 0.0026-0.0063 ms; the kernel takes about
// 0.0030-0.0032 on both.  Staging the root's row in shared memory (1 KB
// for P-ART), so the first step makes no round of its own, was 0.0002 ms
// slower, and blocks of 32 or 128 threads were within 2% of 64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // threads a block: 4096 queries on 64 SMs
constexpr int kRowBits = 26;
constexpr int32_t kRowMask = (1 << kRowBits) - 1;
constexpr int32_t kLevelMask = 15;
constexpr int32_t kLeafBit = 16;  // in a header: the entry shifted by 26

// The unit a node at header `hdr` branches on.
template <int kUnitBits>
__device__ __forceinline__ uint64_t unit_at(uint64_t uq, int32_t hdr) {
  constexpr int kUnits = 64 / kUnitBits;
  int lvl = hdr & kLevelMask;
  lvl = lvl > kUnits - 1 ? kUnits - 1 : lvl;
  return (uq >> (kUnitBits * (kUnits - 1 - lvl))) & ((1ull << kUnitBits) - 1);
}

template <int kUnitBits>
__global__ void __launch_bounds__(kBlock)
art_descend_kernel(const int64_t* __restrict__ queries,
                   const int32_t* __restrict__ children, int root,
                   const uint8_t* __restrict__ lfp,
                   const int64_t* __restrict__ leaf_key,
                   const int64_t* __restrict__ leaf_val, int64_t n_queries,
                   int64_t n_nodes, bool* __restrict__ found,
                   int64_t* __restrict__ values, int32_t* __restrict__ nenc,
                   int32_t* __restrict__ nfp, int32_t* __restrict__ nfalse) {
  constexpr int kUnits = 64 / kUnitBits;
  constexpr int kFan = 1 << kUnitBits;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n_queries) return;
  const int64_t q = __ldg(queries + i);
  const uint64_t uq = static_cast<uint64_t>(q);
  uint32_t qfp = static_cast<uint32_t>(uq & 0xFFull);
  if (qfp == 0) qfp = 1;
  int64_t node = 0;
  int32_t hdr = root;
  bool hit = false;
  int64_t value = 0;
  int32_t n_enc = 0, n_match = 0, n_false = 0;
  for (int step = 0; step <= kUnits; ++step) {
    if (hdr & kLeafBit) {
      const uint32_t fp = __ldg(lfp + node);
      const int64_t key = __ldg(leaf_key + node);
      const int64_t v = __ldg(leaf_val + node);
      ++n_enc;
      if (fp == qfp) {
        ++n_match;
        if (key == q && v != 0) {
          hit = true;
          value = v;
        } else {
          ++n_false;
        }
      }
      break;
    }
    const int32_t e = __ldg(children + node * kFan +
                            static_cast<int64_t>(unit_at<kUnitBits>(uq, hdr)));
    if (e < 0 || (e & kRowMask) >= n_nodes) break;
    node = e & kRowMask;
    hdr = e >> kRowBits;
  }
  found[i] = hit;
  values[i] = value;
  nenc[i] = n_enc;
  nfp[i] = n_match;
  nfalse[i] = n_false;
}

// Per epoch, in place: each entry naming a row in [0, n_nodes) gains that
// row's header (clamped level | leaf << 4) in bits 26-30; every other
// entry becomes -1.  One pass over the table (kernels/art_probe/ops.py
// pack_children; its plain version is ref.pack_entries_plain).
__global__ void pack_entries_kernel(int32_t* __restrict__ children,
                                    const int32_t* __restrict__ hdr,
                                    int64_t n_entries, int64_t n_nodes) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_entries; i += stride) {
    const int32_t c = children[i];
    children[i] = c >= 0 && c < n_nodes ? c | (__ldg(hdr + c) << kRowBits)
                                        : -1;
  }
}

template <int kUnitBits>
void launch(const int64_t* q, const int32_t* c, int root, const uint8_t* fp,
            const int64_t* lk, const int64_t* lval, long long n_queries,
            long long n_nodes, void* const* out, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n_queries + kBlock - 1) / kBlock));
  art_descend_kernel<kUnitBits><<<grid, kBlock, 0, s>>>(
      q, c, root, fp, lk, lval, n_queries, n_nodes,
      static_cast<bool*>(out[0]), static_cast<int64_t*>(out[1]),
      static_cast<int32_t*>(out[2]), static_cast<int32_t*>(out[3]),
      static_cast<int32_t*>(out[4]));
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a unit width other than 8 or 4).
extern "C" int art_descend(const void* queries, const void* children,
                           int root, const void* lfp, const void* leaf_key,
                           const void* leaf_val, long long n_queries,
                           long long n_nodes, int unit_bits, void* found,
                           void* values, void* nenc, void* nfp, void* nfalse,
                           void* stream) {
  if (n_queries <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int64_t*>(queries);
  const auto* c = static_cast<const int32_t*>(children);
  const auto* fp = static_cast<const uint8_t*>(lfp);
  const auto* lk = static_cast<const int64_t*>(leaf_key);
  const auto* lval = static_cast<const int64_t*>(leaf_val);
  void* const out[5] = {found, values, nenc, nfp, nfalse};
  if (unit_bits == 8) {
    launch<8>(q, c, root, fp, lk, lval, n_queries, n_nodes, out, s);
  } else if (unit_bits == 4) {
    launch<4>(q, c, root, fp, lk, lval, n_queries, n_nodes, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Packs `children` ([n_entries] int32, rewritten in place) with the
// headers `hdr` ([n_nodes] int32) on `stream`; returns cudaGetLastError().
extern "C" int art_pack_entries(void* children, const void* hdr,
                                long long n_entries, long long n_nodes,
                                void* stream) {
  if (n_entries <= 0) return 0;
  constexpr int kThreads = 256;
  const long long blocks = (n_entries + kThreads - 1) / kThreads;
  pack_entries_kernel<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(children), static_cast<const int32_t*>(hdr),
      n_entries, n_nodes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* art_descend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
