// Plan-conflict admission: for every candidate op of a set A, does it
// conflict with ANY op of a reference set B.
//
// Replaces, in the JAX package, src/repro/kernels/conflict/kernel.py
// conflict_any_kernel (_conflict_any_kernel).  The TPU form lays a block
// of 512 candidates down the sublanes and the whole of B along the lanes
// and tests every (a, b) pair on [512, B] int32 key halves.  Here the
// relation is reduced over B first, so a candidate costs one set lookup
// at most, whatever the size of B.
//
// The pairwise rule (kernels/conflict/ref.py conflict_matrix_ref), with
// W = PUT | UPDATE | DELETE:
//   same key and (GET a, W b  or  W a, GET b);
//   SCAN a, W b and key_b >= key_a   (b's write lands in a's window);
//   W a, SCAN b and key_a >= key_b;
//   with writes_conflict, same key and W a, W b.
// Reduced over B, a candidate conflicts iff
//   GET:  its key is among B's write keys;
//   W:    its key is among B's GET keys, or B has a SCAN and its key is
//         >= B's least SCAN key, or (writes_conflict) its key is among
//         B's write keys;
//   SCAN: B has a write and its key is <= B's greatest write key;
//   any other kind (the TPU kernel's padding kind 5): never.
// The order is SIGNED 64-bit, the order of numpy's int64 >= in the
// oracle: a key of 2^63 or above (negative as int64) is below every
// other key.  The two scalars are kept as unsigned words in that order
// (ord(k) = k ^ 2^63), the least SCAN key as the greatest ~ord(k), and
// whether B has a SCAN or a write is a flag of its own, so no key value
// stands for "none".
//
// The set: a power-of-two table of slots in buckets of 8, a key's home
// bucket the top bits of key * 2^64 / phi.  Each of B's GETs and writes
// takes a slot of its own, duplicates too: atomicAdd on its bucket's
// count gives it slot c, and c < 8 keeps it there (its key and its class,
// a write or a GET, are stored plainly: no other op owns the slot);
// otherwise it goes on to the next bucket.  So no slot is claimed by
// compare-and-swap and no key value marks an empty slot: a bucket's
// count says which slots are filled, and a count above 8 says some op
// went past the bucket.  A lookup reads its home bucket's count, keys and
// classes in one round (8 lanes, a slot each), ORs the classes of the
// slots holding its key, and goes on to the next bucket only while the
// count is above 8.  The table holds more slots than B has ops, so every
// probe sequence ends.
// (A key-claiming table, 64-bit atomicCAS on the slots and the flags
// ORed in, took 13 us at B = 12288 in global scratch and 50 us in shared
// memory on an H100: tools/search_variants.py.)
//
// Three device operations on the wrapper's scratch in global memory (it
// stays in L2), a table at load 0.375: its counts and the scalars are
// cleared, a first kernel inserts B's ops, one a thread, a second makes
// each candidate's lookup, 8 lanes a candidate.  The stream driver admits
// against every plan already admitted in a tick, so B grows with the
// number of streams; the table grows with it.  A table in shared memory
// lost to it, in both forms tried (tools/search_variants.py): each
// block building the whole table in its own shared memory (one launch;
// every block makes all of B's atomics) took 19.4 us at A = 4096, B =
// 12288, and a cluster of 8 blocks holding it in distributed shared
// memory (one launch) 17.3 us, against 7.1 us here.
//
// What bounds it on an H100: the bytes, (A + B) * 12 in and A out, some
// 200 KB at A = 4096, B = 12288; in practice the fixed cost of three
// device operations and the dependent rounds each thread waits on (its
// op's loads and atomicAdd; its candidate's loads and one lookup).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGet = 0, kPut = 1, kUpdate = 2, kDelete = 3, kScan = 4;
constexpr int kBucketLog = 3;       // a bucket: 8 slots
constexpr int kBucket = 1 << kBucketLog;
constexpr int kMinLog = 5;          // at least 32 slots (4 buckets)
// slots >= B * 8 / 3: load 0.375 at most, so a lookup seldom reads a
// second bucket
constexpr int kLoadNum = 3, kLoadDen = 8;
constexpr int kThreads = 128;      // threads of a block, both kernels
constexpr unsigned kWriteBit = 1, kGetBit = 2;  // a slot's class
constexpr unsigned kScanClass = 3;  // an op's class: 0, a slot's, or this
constexpr unsigned kHasScan = 4, kHasWrite = 8;  // in the header word
constexpr unsigned long long kSign = 1ull << 63;
constexpr unsigned long long kPhi = 0x9E3779B97F4A7C15ull;
constexpr unsigned kFull = 0xffffffffu;

// A table of 2^lg slots: per bucket a count and 8 slots of a key and a
// class byte.
struct Table {
  unsigned* counts;
  unsigned long long* keys;
  unsigned char* cls;
  int log_slots;
};

// The scalars: max_w, the greatest ord(key) of B's writes; max_ns, the
// greatest ~ord(key) of its SCANs; has, kHasScan and kHasWrite.
struct Scalars {
  unsigned long long max_w, max_ns;
  unsigned has;
};

// log2 of the table's slots for n_b reference ops
int log_slots_for(long long n_b) {
  const long long want = (n_b * kLoadDen + kLoadNum - 1) / kLoadNum;
  int lg = kMinLog;
  while ((1ll << lg) < want) ++lg;
  return lg;
}

// Bytes of a table of 2^lg slots' counts, at least 16 so that the keys
// after them start 16-byte aligned.
long long counts_bytes(int lg) {
  const long long n = (1ll << (lg - kBucketLog)) * 4;
  return n < 16 ? 16 : n;
}

// Bytes of a table of 2^lg slots: the counts, the keys, the classes.
long long table_bytes(int lg) {
  return counts_bytes(lg) + (1ll << lg) * 9;
}

Table table_at(void* base, int lg) {
  auto* bytes = static_cast<unsigned char*>(base);
  auto* keys =
      reinterpret_cast<unsigned long long*>(bytes + counts_bytes(lg));
  return Table{reinterpret_cast<unsigned*>(bytes), keys,
               reinterpret_cast<unsigned char*>(keys + (1ll << lg)), lg};
}

// 0 for a kind that conflicts with nothing, else kWriteBit, kGetBit or
// kScanClass
__device__ __forceinline__ unsigned op_class(int kind) {
  return kind == kPut || kind == kUpdate || kind == kDelete ? kWriteBit
         : kind == kGet                                     ? kGetBit
         : kind == kScan                                    ? kScanClass
                                                            : 0u;
}

__device__ __forceinline__ unsigned home_bucket(unsigned long long key,
                                                int log_slots) {
  return static_cast<unsigned>((key * kPhi) >>
                               (64 - (log_slots - kBucketLog)));
}

// Enter one of B's ops (its class c): a slot of its own for a GET or a
// write, and its part of the scalars in s, which the caller reduces.
__device__ __forceinline__ void insert(const Table& t, unsigned c,
                                       long long key, Scalars& s) {
  const unsigned long long k = static_cast<unsigned long long>(key);
  const unsigned long long ord = k ^ kSign;
  if (c == kScanClass) {
    s.has |= kHasScan;
    s.max_ns = max(s.max_ns, ~ord);
    return;
  }
  if (!c) return;
  if (c == kWriteBit) {
    s.has |= kHasWrite;
    s.max_w = max(s.max_w, ord);
  }
  const unsigned mask = (1u << (t.log_slots - kBucketLog)) - 1;
  unsigned g = home_bucket(k, t.log_slots);
  unsigned at;
  while ((at = atomicAdd(t.counts + g, 1u)) >= kBucket) g = (g + 1) & mask;
  const unsigned slot = (g << kBucketLog) + at;
  t.keys[slot] = k;
  t.cls[slot] = static_cast<unsigned char>(c);
}

__device__ __forceinline__ Scalars warp_merge(Scalars s) {
  for (int d = 16; d > 0; d >>= 1) {
    s.max_w = max(s.max_w, __shfl_xor_sync(kFull, s.max_w, d));
    s.max_ns = max(s.max_ns, __shfl_xor_sync(kFull, s.max_ns, d));
    s.has |= __shfl_xor_sync(kFull, s.has, d);
  }
  return s;
}

// The block's scalars merged: the warps merge by shuffles and leave
// their partials in shared memory, and warp 0 merges those.  Every
// thread of the block calls it; warp 0's lane 0 holds the result.
__device__ __forceinline__ Scalars block_merge(Scalars s) {
  constexpr int kWarps = kThreads / 32;
  __shared__ Scalars part[kWarps];
  s = warp_merge(s);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) s = warp_merge(lane < kWarps ? part[lane] : Scalars{});
  return s;
}

// B into the table, one op a thread ...
__global__ void __launch_bounds__(kThreads)
conflict_insert_kernel(const int32_t* __restrict__ b_kinds,
                       const int64_t* __restrict__ b_keys, int64_t n_b,
                       Scalars* scalars, Table t) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  Scalars s{};
  if (j < n_b) insert(t, op_class(__ldg(b_kinds + j)), __ldg(b_keys + j), s);
  s = block_merge(s);
  if (threadIdx.x == 0 && s.has) {
    atomicOr(&scalars->has, s.has);
    if (s.has & kHasWrite) atomicMax(&scalars->max_w, s.max_w);
    if (s.has & kHasScan) atomicMax(&scalars->max_ns, s.max_ns);
  }
}

// ... then every candidate against it: 8 lanes a candidate, lane j
// reading slot j of each bucket, the classes of the slots holding its
// key ORed across the 8 by shuffles.
__global__ void __launch_bounds__(kThreads)
conflict_probe_kernel(const int32_t* __restrict__ a_kinds,
                      const int64_t* __restrict__ a_keys, int64_t n_a,
                      const Scalars* scalars, Table t, bool writes_conflict,
                      bool* __restrict__ out) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kBucket;
  const int lane = threadIdx.x % kBucket;
  const unsigned group = 0xffu << (threadIdx.x % 32 / kBucket * kBucket);
  if (i >= n_a) return;
  const unsigned c = op_class(__ldg(a_kinds + i));
  const unsigned long long k = static_cast<unsigned long long>(
      __ldg(a_keys + i));
  const unsigned long long ord = k ^ kSign;
  const Scalars s = *scalars;
  bool conf;
  if (c == kScanClass) {
    conf = (s.has & kHasWrite) && ord <= s.max_w;
  } else if (c == kWriteBit && (s.has & kHasScan) && ord >= ~s.max_ns) {
    conf = true;
  } else if (c) {  // a GET or a write: its key's slots in B
    const unsigned mask = (1u << (t.log_slots - kBucketLog)) - 1;
    unsigned g = home_bucket(k, t.log_slots);
    unsigned found = 0;
    for (;;) {  // a bucket a round, on while some op went past it
      const size_t at = (static_cast<size_t>(g) << kBucketLog) + lane;
      const unsigned n = __ldg(t.counts + g);
      const unsigned long long got = __ldg(t.keys + at);
      const unsigned cls = __ldg(t.cls + at);
      found |= lane < n && got == k ? cls : 0u;
      if (n <= kBucket) break;
      g = (g + 1) & mask;
    }
    for (int d = kBucket / 2; d > 0; d >>= 1)
      found |= __shfl_xor_sync(group, found, d);
    conf = c == kGetBit ? (found & kWriteBit) != 0
                        : (found & kGetBit) ||
                              (writes_conflict && (found & kWriteBit));
  } else {
    conf = false;
  }
  if (lane == 0) out[i] = conf;
}

unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Bytes of scratch a call with n_b reference ops needs: the scalars (32
// bytes), then the table.
extern "C" long long conflict_any_scratch_bytes(long long n_b) {
  return 32 + table_bytes(log_slots_for(n_b));
}

// C interface, loaded with ctypes.  `out`: n_a bytes, every one written
// (1 where the candidate conflicts).  `scratch`: the bytes
// conflict_any_scratch_bytes(n_b) names, on the device, 16-byte aligned;
// its scalars and counts are cleared here.  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() after the launches.
extern "C" int conflict_any(const void* a_kinds, const void* a_keys,
                            long long n_a, const void* b_kinds,
                            const void* b_keys, long long n_b,
                            int writes_conflict, void* out, void* scratch,
                            void* stream) {
  if (n_a <= 0 || n_b <= 0) return 0;
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int lg = log_slots_for(n_b);
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(32 + counts_bytes(lg)), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* scalars = static_cast<Scalars*>(scratch);
  const Table t = table_at(static_cast<unsigned char*>(scratch) + 32, lg);
  conflict_insert_kernel<<<blocks(n_b), kThreads, 0, s>>>(
      static_cast<const int32_t*>(b_kinds),
      static_cast<const int64_t*>(b_keys), n_b, scalars, t);
  conflict_probe_kernel<<<blocks(kBucket * n_a), kThreads, 0, s>>>(
      static_cast<const int32_t*>(a_kinds),
      static_cast<const int64_t*>(a_keys), n_a, scalars, t,
      writes_conflict != 0, static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conflict_any_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
