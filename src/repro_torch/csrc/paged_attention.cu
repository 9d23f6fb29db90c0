// Single-token decode attention over KV pages addressed by a block
// table, split over the keys: one block per (sequence, kv head, split of
// the keys), the splits of a (sequence, kv head) forming one thread-block
// cluster that merges them on chip.
//
// Replaces, in the JAX package, src/repro/kernels/paged_attention/kernel.py
// paged_attention (_paged_kernel).  The TPU form walks a (B*H, MAXP)
// grid whose page axis is sequential, resolves the page indirection in
// the DMA engine from a prefetched block table, keeps (m, l, acc) in
// VMEM scratch, and needs the kv heads repeated to H by its caller
// (paged_mqa).  Here query head h reads kv head h / (H / Hk), so GQA
// makes no copy, and the page axis is cut into splits that run in
// parallel.
//
// Semantics, those of the TPU kernel:
//   * keys j < min(len, MAXP * PS) are live (pages pi * PS < len); key j
//     is slot j % PS of page max(table[b, j / PS], 0);
//   * with a sliding window w > 0 (the JAX package masks it outside its
//     kernel, in models/attention.py attn_decode), only keys j >= len - w
//     of those are live;
//   * q and the pages are upcast to fp32; s = (q . k) * scale; softmax
//     and the P.V product in fp32; out = acc / max(l, 1e-30) in q's
//     dtype, so len = 0 gives zeros;
//   * on request (lse not null) the log-sum-exp of each (sequence, query
//     head)'s live scores, M + log(L) in fp32, -inf where no key is live:
//     what flash decoding needs to merge attention over slot shards
//     (models/attention.py _seq_sharded_decode); the output is the same
//     with or without it;
//   * the pages hold q's dtype, or int8 (the kv_int8 cache of the JAX
//     package's src/repro/models/attention.py attn_decode, quantized as
//     clip(round(x * 32), -127, 127)): each int8 key and value is
//     converted to fp32 and multiplied by kv_scale (1/32) in registers as
//     it is loaded from shared memory, so no dequantized copy of the cache
//     is ever written (the JAX package's "dequant fuses into the attention
//     dot"); int8 / 32 is exact in bf16 and fp32, so the kernel sees the
//     JAX package's values k.astype(bf16) * (1/32).
//
// What bounds it on an H100: a decode step reads each live key and value
// once, 2 * len * Hk * dh * 2 bytes in bf16 (0.27 MB per layer at len =
// 529, Hk = 2, dh = 64, about 0.08 us at HBM bandwidth), and does about
// 4 * len * H * dh FLOPs (2 MFLOP), far below the tensor cores' crossover:
// the products stay on the fp32 CUDA cores.  What bounds it is latency:
// the chain of dependent steps from launch to the last store.  One block
// per (sequence, query head) ran 14 blocks on 132 SMs at one sequence of
// Qwen2-0.5B, each walking all 529 keys alone, and the 7 query heads of a
// kv head read its rows 7 times.
//
// The design:
//   * Grid (splits, B * Hk * head groups), clusters of all the splits.
//     A block computes every query head that shares its kv head (4, 8 or
//     32 heads a block, as the host asks; more form further head groups),
//     so each key and value row is read once.  A split is split_pages
//     whole pages; the host chooses 1, 2, 4 or 8 splits from MAXP, B and
//     Hk alone (never from seq_lens, which stay on the device), as many
//     as fill half the SMs: at Qwen2's shape 8 splits of 5 pages, 16
//     blocks, the last split past the table.  A split past len does no
//     work and leaves m = -1e30, l = 0.
//   * A block is 4 teams of 4 warps, each team a chunk of 32 keys at a
//     time, so a split of up to 128 keys takes one round.  A chunk is a
//     chain of some 900 dependent instructions a warp, which one warp a
//     scheduler cannot hide: four teams run four chains at once.
//   * Latency: the length and q are requested at once, and the first
//     rounds of chunks are staged with cp.async (16 bytes a thread) at
//     once too, whatever the length (rows past it are never read), two
//     rounds deep where a chunk is small, so the next round's rows are in
//     flight while the teams score this one.  A thread reads its row's
//     table entry from device memory (cached) just before its copy: the
//     table is never staged in shared memory, so MAXP has no limit.
//   * Scores: a warp scores its team's chunk for its heads with one key a
//     lane, reading its key row from shared memory in 16-byte pieces,
//     swizzled (piece ^ row) so the lanes hit distinct banks, and q by
//     broadcast; the heads' softmax steps (max and sum by warp shuffles)
//     interleave.  P.V: a lane owns kDh / 32 adjacent columns, the
//     weights by shuffle.
//   * Merge: the teams' partials (m, l, acc[dh]) per head are merged in
//     shared memory into the block's, which go straight into the shared
//     memory of the block that merges that head (split g % splits) by
//     remote stores (distributed shared memory); after one cluster
//     barrier each block merges its heads from its own shared memory,
//     out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)
//     with M the largest m_s.  (Stores need no round trip and one
//     barrier; reading the partials back by remote loads took a second
//     barrier to keep them alive, and was slower on an H100.)  Nothing
//     goes through device memory but the inputs and the output, and the
//     kernel needs no scratch.
//   * Window: each block computes its sequence's first live key,
//     max(0, len - w), from the length it reads (unclamped: a slot
//     shard's length may pass its table, and its window still starts at
//     len - w), and starts its split's key loop there (its chunks count
//     from that key, not from the split's first), so no key before the
//     window is read, and no page wholly before it.  A split that lies
//     wholly before the window has no chunk and leaves the empty partial,
//     as a split past len does.  The split
//     plan stays a function of the table's shape: a windowed call has the
//     same grid, and its early splits do no work.  Its first rounds wait
//     for the length; without a window they go out before it, as above.
//
// int8 pages: a 16-byte piece is 16 elements, so a row of dh = 64 is 4
// pieces (a bf16 row's 8) and a chunk's stage is half the bf16 one's; the
// teams' partials, which the bf16 and fp32 forms keep in the freed stages,
// may then be larger than the stages, and the region takes the larger of
// the two.  A decode step at B = 128 over 32,768 slots moves 1.07 GB of
// int8 cache a layer (2.15 GB in bf16), but at that shape the bytes do not
// bound the kernel: B * Hk = 256 blocks fill the SMs, so each sequence's
// keys take one split, and a block walks its 32,768 keys in 256 rounds of
// dependent steps (1.76 ms a launch with int8 pages, 1.90 with bf16, on an
// H100 at 700 W: 5.5x and 3.0x the bytes' time).  Converting the int8
// values without I2F (PRMT and FADD) read the same, so the plain cast
// stays.  More splits or more heads a block at a large batch are left for
// later, below.
//
// Left for later: the same work in one block per SM at a large batch
// (more heads a block), and folding the decode step into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTeams = 4;        // teams of a block, a chunk each
constexpr int kTeamWarps = 4;    // warps of a team
constexpr int kThreads = 32 * kTeamWarps * kTeams;
constexpr int kChunk = 32;       // keys a team scores at a time, one a lane
constexpr int kMaxSplits = 8;    // the portable cluster size
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 16 bytes at p as fp32: 4 floats, 8 bf16 or 16 int8 (times s; the
// float forms ignore s)
__device__ __forceinline__ void unpack16(const float* p, float* out, float) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* out,
                                         float) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack16(const int8_t* p, float* out,
                                         float s) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(b[i]) * s;
}
// one page element as fp32 (an int8 one times s)
__device__ __forceinline__ float deq(float x, float) { return x; }
__device__ __forceinline__ float deq(__nv_bfloat16 x, float) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float deq(int8_t x, float s) {
  return static_cast<float>(x) * s;
}

// 16 bytes from global src to shared dst, or 16 zero bytes when !live
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// every block of the cluster has started: arrive early, wait before the
// first access to another block's shared memory
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}
// v into the float at the same shared-memory offset as p in block
// `rank` of the cluster
__device__ __forceinline__ void st_cluster(float* p, int rank, float v) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

template <typename T, int kDh>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);     // elements in 16 bytes
  static constexpr int kPieces = kDh / kVec;      // 16-byte pieces a row
  static constexpr int kChunkBytes = 2 * kChunk * kDh * sizeof(T);
  // rounds of kTeams chunks in flight: two where a chunk is small
  static constexpr int kDepth = kChunkBytes <= 16384 ? 2 : 1;
  static constexpr int kStages = kTeams * kDepth;
  // the physical piece of logical piece p of row j: rows of 128 bytes or
  // more XOR the low 3 bits with j, rows of 64 bytes (two to a 128-byte
  // line) with j / 2, so 8 lanes reading 8 rows' piece p hit 8 distinct
  // 16-byte bank groups
  __device__ static __forceinline__ int swizzle(int p, int j) {
    return kPieces >= 8 ? p ^ (j & 7) : p ^ ((j >> 1) & (kPieces - 1));
  }
  // the stages, which hold the teams' partials once the keys are done:
  // the larger of the two (the partials are larger only for int8 pages)
  __host__ __device__ static constexpr int region(int block_heads) {
    return kStages * kChunkBytes > kTeams * block_heads * (kDh + 2) * 4
               ? kStages * kChunkBytes
               : kTeams * block_heads * (kDh + 2) * 4;
  }
  // bytes of shared memory for a block of block_heads heads: the stages'
  // region, q and the inbox of partials to merge
  static constexpr int bytes(int block_heads) {
    return region(block_heads) + block_heads * kDh * 4 +
           (block_heads + kMaxSplits) * (kDh + 2) * 4;
  }
};

// kHeads query heads per warp of a team, so up to 4 kHeads heads a block;
// q and out of type T, the pages of type KV (T, or int8 read times
// kv_scale)
template <typename T, typename KV, int kDh, int kHeads>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,
                       const KV* __restrict__ pages_k,
                       const KV* __restrict__ pages_v,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ lens, T* __restrict__ out,
                       float* __restrict__ lse, int heads, int kv_heads,
                       int page_size, int max_pages, int split_pages,
                       int window, float scale, float kv_scale) {
  using L = Layout<KV, kDh>;
  constexpr int kVec = L::kVec;
  constexpr int kPieces = L::kPieces;
  constexpr int kDepth = L::kDepth;
  constexpr int kStages = L::kStages;
  constexpr int kCols = kDh / 32;  // adjacent output columns a lane owns
  constexpr int kBlockHeads = kTeamWarps * kHeads;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage + ((2 st + kv) * kChunk + j) * kDh: row j of stage st, kv 0
  // for keys, 1 for values, its pieces swizzled
  KV* stage = reinterpret_cast<KV*>(smem);
  float* qs = reinterpret_cast<float*>(smem + L::region(kBlockHeads));
  // the partials this block merges: [split][slot][kDh + 2], a head's
  // acc, then its m and l
  float* inbox = qs + kBlockHeads * kDh;

  const int split = blockIdx.x;  // the block's rank in its cluster
  const int n_splits = gridDim.x;
  const int group_size = heads / kv_heads;
  const int groups = (group_size + kBlockHeads - 1) / kBlockHeads;
  const int hg = blockIdx.y % groups;
  const int hk = (blockIdx.y / groups) % kv_heads;
  const int b = blockIdx.y / (groups * kv_heads);
  const int g0 = hg * kBlockHeads;
  const int n_heads = min(kBlockHeads, group_size - g0);
  const int h0 = hk * group_size + g0;  // first query head of the block
  const int team = threadIdx.x / (32 * kTeamWarps);
  const int warp = threadIdx.x / 32 % kTeamWarps;  // within the team
  const int lane = threadIdx.x % 32;

  // the split's keys: [lo, split_hi) in the table, [lo, hi) of them live
  const int lo = split * split_pages * page_size;
  const int split_hi =
      min(lo + split_pages * page_size, max_pages * page_size);
  const int32_t* pages = table + static_cast<int64_t>(b) * max_pages +
                         split * split_pages;
  const int64_t key_row = static_cast<int64_t>(kv_heads) * kDh;
  const T* q_row = q + static_cast<int64_t>(b * heads + h0) * kDh;

  cluster_arrive_relaxed();  // waited for before the first remote store

  // the length and q, requested at once (the first round's barrier
  // publishes q)
  const int len_raw = lens[b];
  for (int i = threadIdx.x; i < n_heads * kDh; i += kThreads)
    qs[i] = to_f32(q_row[i]);

  // round r: chunks r kTeams .. r kTeams + kTeams - 1 of the split's keys
  // from `from` on, keys of k and v into their stages; rows past the
  // split or the table are zero-filled
  auto stage_round = [&](int from, int r) {
    constexpr int kRowPieces = 2 * kChunk * kPieces;  // one chunk
    for (int i = threadIdx.x; i < kTeams * kRowPieces; i += kThreads) {
      const int ci = r * kTeams + i / kRowPieces;
      const int kv = i / (kChunk * kPieces) % 2;
      const int j = (i / kPieces) % kChunk;
      const int piece = i % kPieces;
      const int key = from + ci * kChunk + j;
      const bool live = key < split_hi;
      const char* src = reinterpret_cast<const char*>(kv ? pages_v : pages_k);
      if (live) {
        const int64_t page = max(__ldg(pages + (key - lo) / page_size), 0);
        src += ((page * page_size + key % page_size) * key_row +
                static_cast<int64_t>(hk) * kDh) * sizeof(KV) + piece * 16;
      }
      cp_async16(stage + ((2 * (ci % kStages) + kv) * kChunk + j) * kDh +
                     L::swizzle(piece, j) * kVec,
                 src, live);
    }
  };

  auto stage_first = [&](int from) {
#pragma unroll
    for (int r = 0; r < kDepth; ++r) {
      if (from + r * kTeams * kChunk < split_hi) stage_round(from, r);
      cp_async_commit();
    }
  };
  // without a window the first rounds go out before the length is known
  if (window == 0) stage_first(lo);
  const int len = max(0, min(len_raw, max_pages * page_size));
  // the split's keys are read from `base` on: its first key, or the
  // sequence's first live key where a window starts inside the split
  // (split_hi where it starts past it, so no chunk is read)
  const int first = window > 0 && len_raw > window ? len_raw - window : 0;
  const int base = max(lo, min(split_hi, first));
  if (window > 0) stage_first(base);
  const int hi = min(split_hi, len);
  const int n_chunks = hi > base ? (hi - base + kChunk - 1) / kChunk : 0;
  const int n_rounds = (n_chunks + kTeams - 1) / kTeams;

  // head slot i of this warp is head warp + kTeamWarps i; slots past the
  // block's heads repeat its last head and are never stored
  int gi[kHeads];
  float m[kHeads], l[kHeads], acc[kHeads][kCols];
#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
    gi[i] = min(warp + kTeamWarps * i, n_heads - 1);
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int r = 0; r < n_rounds; ++r) {
    cp_async_wait<kDepth - 1>();
    __syncthreads();  // round r is in
    const int ci = r * kTeams + team;  // this team's chunk
    const int c0 = base + ci * kChunk;
    // keys c0 + n and on are dead: their rows may hold anything (a slot
    // not yet written), so they are masked and never read for P.V
    const int n = min(kChunk, hi - c0);
    if (n > 0) {
      const KV* ks = stage + (2 * (ci % kStages)) * kChunk * kDh;
      const KV* vs = ks + kChunk * kDh;

      // lane j scores key c0 + j against each of the warp's heads
      float d[kHeads][2];
#pragma unroll
      for (int i = 0; i < kHeads; ++i) d[i][0] = d[i][1] = 0.f;
      const KV* kr = ks + lane * kDh;
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        float kf[kVec];
        unpack16(kr + L::swizzle(p, lane) * kVec, kf, kv_scale);
#pragma unroll
        for (int i = 0; i < kHeads; ++i) {
          const float* qg = qs + gi[i] * kDh + p * kVec;
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qg + e);
            d[i][(e / 4) & 1] += qq.x * kf[e] + qq.y * kf[e + 1] +
                                 qq.z * kf[e + 2] + qq.w * kf[e + 3];
          }
        }
      }
      float s[kHeads], mx[kHeads], p[kHeads], ps[kHeads], alpha[kHeads];
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
        s[i] = lane < n ? (d[i][0] + d[i][1]) * scale : -INFINITY;
        mx[i] = s[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kHeads; ++i)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
        const float m_new = fmaxf(m[i], mx[i]);
        p[i] = expf(s[i] - m_new);  // a dead key gives 0
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
        ps[i] = p[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kHeads; ++i)
          ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], o);
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
        l[i] = l[i] * alpha[i] + ps[i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha[i];
      }

      // P.V over the live keys: lane owns columns kCols lane .. + kCols - 1
      const int col = kCols * lane;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const KV* vr = vs + j * kDh +
                       L::swizzle(col / kVec, j) * kVec + col % kVec;
        float v[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[c] = deq(vr[c], kv_scale);
#pragma unroll
        for (int i = 0; i < kHeads; ++i) {
          const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] += pj * v[c];
        }
      }
    }
    if (r + kDepth < n_rounds) {
      __syncthreads();  // round r's stages are free
      stage_round(base, r + kDepth);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();  // rounds staged past the length
  __syncthreads();     // the stages are free for the teams' partials

  // the teams' partials, then the block's: one partial per head
  float* team_m = reinterpret_cast<float*>(stage);  // [kTeams][kBlockHeads]
  float* team_l = team_m + kTeams * kBlockHeads;
  float* team_acc = team_l + kTeams * kBlockHeads;  // [..][..][kDh]
#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
    const int g = warp + kTeamWarps * i;
    if (g >= n_heads) continue;
    const int at = team * kBlockHeads + g;
    if (lane == 0) {
      team_m[at] = m[i];
      team_l[at] = l[i];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      team_acc[at * kDh + kCols * lane + c] = acc[i][c];
  }
  __syncthreads();

  // the block's partial of head g goes straight into the inbox of the
  // block that merges g (split g % n_splits), at this split's slot
  const int slots = (kBlockHeads + n_splits - 1) / n_splits;
  cluster_wait();  // every block of the cluster is running
  for (int it = threadIdx.x; it < n_heads * kDh; it += kThreads) {
    const int g = it / kDh;
    const int c = it % kDh;
    float mm = kNegBig;
#pragma unroll
    for (int t = 0; t < kTeams; ++t)
      mm = fmaxf(mm, team_m[t * kBlockHeads + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int t = 0; t < kTeams; ++t) {
      const int at = t * kBlockHeads + g;
      const float w = expf(team_m[at] - mm);
      num += w * team_acc[at * kDh + c];
      den += w * team_l[at];
    }
    float* to = inbox + (split * slots + g / n_splits) * (kDh + 2);
    const int rank = g % n_splits;
    st_cluster(to + c, rank, num);
    if (c == 0) {
      st_cluster(to + kDh, rank, mm);
      st_cluster(to + kDh + 1, rank, den);
    }
  }
  cluster_sync();  // every split's partials are in their inboxes

  // the block of split r merges heads r, r + n_splits, ...
  const int mine =
      n_heads > split ? (n_heads - split + n_splits - 1) / n_splits : 0;
  for (int it = threadIdx.x; it < mine * kDh; it += kThreads) {
    const int gl = it / kDh;
    const int c = it % kDh;
    float mm = kNegBig;
    for (int r = 0; r < n_splits; ++r)
      mm = fmaxf(mm, inbox[(r * slots + gl) * (kDh + 2) + kDh]);
    float num = 0.f, den = 0.f;
    for (int r = 0; r < n_splits; ++r) {
      const float* from = inbox + (r * slots + gl) * (kDh + 2);
      const float w = expf(from[kDh] - mm);
      num += w * from[c];
      den += w * from[kDh + 1];
    }
    const int g = split + gl * n_splits;
    out[static_cast<int64_t>(b * heads + h0 + g) * kDh + c] =
        from_f32<T>(num / fmaxf(den, 1e-30f));
    // M + log(L): -1e30 + log(0) = -inf where no key is live
    if (lse != nullptr && c == 0) lse[b * heads + h0 + g] = mm + logf(den);
  }
}

template <typename T, typename KV, int kDh, int kHeads>
int launch_heads(const void* q, const void* pages_k, const void* pages_v,
                 const void* table, const void* lens, void* out, void* lse,
                 int batch, int heads, int kv_heads, int page_size,
                 int max_pages, int split_pages, int n_splits, int window,
                 float scale, float kv_scale, cudaStream_t stream) {
  constexpr int kBlockHeads = kTeamWarps * kHeads;
  const int groups = (heads / kv_heads + kBlockHeads - 1) / kBlockHeads;
  const int smem = Layout<KV, kDh>::bytes(kBlockHeads);
  auto* kernel = paged_attention_kernel<T, KV, kDh, kHeads>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = n_splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_splits, batch * kv_heads * groups);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(q),
      static_cast<const KV*>(pages_k), static_cast<const KV*>(pages_v),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens),
      static_cast<T*>(out), static_cast<float*>(lse), heads, kv_heads,
      page_size, max_pages, split_pages, window, scale, kv_scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// block_heads is the host's choice of query heads a block computes (see
// heads_per_block in kernels/paged_attention/kernel.py): kHeads a warp of
// a team, any other count rejected
template <typename T, typename KV, int kDh>
int launch(const void* q, const void* pages_k, const void* pages_v,
           const void* table, const void* lens, void* out, void* lse,
           int batch, int heads, int kv_heads, int page_size, int max_pages,
           int split_pages, int n_splits, int block_heads, int window,
           float scale, float kv_scale, cudaStream_t stream) {
  switch (block_heads) {
    case kTeamWarps:
      return launch_heads<T, KV, kDh, 1>(
          q, pages_k, pages_v, table, lens, out, lse, batch, heads,
          kv_heads, page_size, max_pages, split_pages, n_splits, window,
          scale, kv_scale, stream);
    case 2 * kTeamWarps:
      return launch_heads<T, KV, kDh, 2>(
          q, pages_k, pages_v, table, lens, out, lse, batch, heads,
          kv_heads, page_size, max_pages, split_pages, n_splits, window,
          scale, kv_scale, stream);
    case 8 * kTeamWarps:
      return launch_heads<T, KV, kDh, 8>(
          q, pages_k, pages_v, table, lens, out, lse, batch, heads,
          kv_heads, page_size, max_pages, split_pages, n_splits, window,
          scale, kv_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename KV>
int launch_dtype(const void* q, const void* pages_k, const void* pages_v,
                 const void* table, const void* lens, void* out, void* lse,
                 int batch, int heads, int kv_heads, int head_dim,
                 int page_size, int max_pages, int split_pages,
                 int n_splits, int block_heads, int window, float scale,
                 float kv_scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, KV, 32>(q, pages_k, pages_v, table, lens, out, lse,
                               batch, heads, kv_heads, page_size, max_pages,
                               split_pages, n_splits, block_heads, window,
                               scale, kv_scale, stream);
    case 64:
      return launch<T, KV, 64>(q, pages_k, pages_v, table, lens, out, lse,
                               batch, heads, kv_heads, page_size, max_pages,
                               split_pages, n_splits, block_heads, window,
                               scale, kv_scale, stream);
    case 128:
      return launch<T, KV, 128>(q, pages_k, pages_v, table, lens, out, lse,
                                batch, heads, kv_heads, page_size, max_pages,
                                split_pages, n_splits, block_heads, window,
                                scale, kv_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes.  q: [batch, heads, head_dim]; pages_k,
// pages_v: [n_pages, page_size, kv_heads, head_dim]; table: [batch,
// max_pages] int32 (entries below 0 read page 0); lens: [batch] int32;
// out like q; lse null, or [batch, heads] float32 for each query head's
// log-sum-exp of its live scores (-inf where none is live); all
// contiguous, q of `dtype` (0 float32, 1 bfloat16), the pages of
// `kv_dtype` (q's, or 2 int8, each element read times kv_scale), 16-byte
// aligned.  The keys are cut into n_splits (1, 2, 4 or 8) splits of
// split_pages pages, n_splits * split_pages >= max_pages; a block computes
// block_heads (4, 8 or 32) query heads of a kv head; window > 0 keeps only
// the last `window` of a sequence's keys live (from len - window, len
// unclamped), 0 keeps all; a len <= 0 reads nothing.  Launches on
// `stream`, does not synchronise, and returns the launch's error or
// cudaGetLastError() after it (cudaErrorInvalidValue for a head dim other
// than 32, 64 or 128, another dtype or kv_dtype, heads not a multiple of
// kv_heads, another block_heads, a negative window, or a split plan that
// does not cover max_pages).
extern "C" int paged_attention(const void* q, const void* pages_k,
                               const void* pages_v, const void* table,
                               const void* lens, void* out, void* lse,
                               int batch, int heads, int kv_heads,
                               int head_dim,
                               int page_size, int max_pages, int split_pages,
                               int n_splits, int block_heads, int window,
                               int dtype, int kv_dtype, float scale,
                               float kv_scale, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || page_size <= 0 ||
      max_pages < 0 || split_pages <= 0 || n_splits <= 0 ||
      n_splits > kMaxSplits || (n_splits & (n_splits - 1)) != 0 ||
      window < 0 ||
      static_cast<int64_t>(n_splits) * split_pages < max_pages)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && kv_dtype == 0)
    return launch_dtype<float, float>(
        q, pages_k, pages_v, table, lens, out, lse, batch, heads, kv_heads,
        head_dim, page_size, max_pages, split_pages, n_splits, block_heads,
        window, scale, kv_scale, s);
  if (dtype == 1 && kv_dtype == 1)
    return launch_dtype<__nv_bfloat16, __nv_bfloat16>(
        q, pages_k, pages_v, table, lens, out, lse, batch, heads, kv_heads,
        head_dim, page_size, max_pages, split_pages, n_splits, block_heads,
        window, scale, kv_scale, s);
  if (dtype == 0 && kv_dtype == 2)
    return launch_dtype<float, int8_t>(
        q, pages_k, pages_v, table, lens, out, lse, batch, heads, kv_heads,
        head_dim, page_size, max_pages, split_pages, n_splits, block_heads,
        window, scale, kv_scale, s);
  if (dtype == 1 && kv_dtype == 2)
    return launch_dtype<__nv_bfloat16, int8_t>(
        q, pages_k, pages_v, table, lens, out, lse, batch, heads, kv_heads,
        head_dim, page_size, max_pages, split_pages, n_splits, block_heads,
        window, scale, kv_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
