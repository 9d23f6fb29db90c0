// Causal / sliding-window attention forward (prefill), online softmax
// over tiles of keys.
//
// Replaces, in the JAX package, src/repro/kernels/flash_attention/kernel.py
// flash_attention (_flash_kernel).  The TPU form takes [B*H, T, dh] with
// the kv heads repeated by the caller, walks a (q block, kv block) grid
// whose kv axis is sequential with (m, l, acc) in VMEM scratch, and
// asserts T % q_block == 0.  Here q is read as [B, T, H, dh] and k, v as
// [B, S, Hk, dh], the layouts the model produces: query head h reads kv
// head h / (H / Hk), so GQA makes no copy; the key loop runs inside the
// block; the ragged last tile of query rows and of keys is masked here,
// so T and S take any value.
//
// Semantics, those of the TPU kernel:
//   * q, k, v are read exactly; scores s = (q . k) * scale in fp32;
//     softmax and the P.V product in fp32; the output is stored in q's
//     dtype;
//   * causal: query row i sits at position i + S - T (right-aligned) and
//     sees key j iff j <= pos, and with a window w also j > pos - w; the
//     window applies only with causal, as in the TPU kernel;
//   * out = acc / max(l, 1e-30): a row that sees no key (T > S) is 0.
//   Tiles of keys that lie wholly above the diagonal or before the window
//   of every row of the block are never loaded.
//
// LSE for the backward: where the C interface gets a non-null lse
// pointer, both kernels write each live row's log-sum-exp of its scaled
// scores, fp32 [B, H, T], in natural-log units: m + log l, from the
// running max and sum the softmax already holds (the bf16 kernel keeps
// them in log2 units and stores (m2 + log2 l2) * ln 2).  A row that sees
// no key gets +inf, so the backward's P = exp(s - LSE) is 0 there, never
// NaN.  csrc/flash_attention_bwd.cu reads it in place of recomputing the
// softmax; the TPU kernel keeps the same m and l in its m_ref / l_ref
// scratch.  With a null pointer nothing more is stored.
//
// What bounds it on an H100: at the prefill shapes of Qwen2-0.5B (H = 14,
// Hk = 2, dh = 64, T = S = 256-512) a layer's attention is
// 2 * 2 * T^2 * dh * H / 2 FLOPs, 0.47 GFLOP at T = 512 (0.47 us at the
// bf16 tensor-core rate), against 2.1 MB of q, k, v and output in bf16
// (0.63 us at HBM bandwidth).  Only the tensor cores reach that FLOP
// rate, so the bf16 kernel does both products there; fp32 inputs take
// the CUDA cores (see below).
//
// Two kernels, chosen by the dtype argument of the C interface:
//
// bfloat16 (the model's path): warpgroup MMA fed by TMA.  A block owns 64
// query rows of one (batch, head); 128 threads (one warpgroup) compute,
// and one more warp loads.  The producer warp's first lane loads the q
// tile once and then each 64-key tile of k and v by TMA (3-D tensor maps
// [B, T, H*dh] and [B, S, Hk*dh], box (1, 64, dh), so rows past T or S
// are zero-filled and never the next batch's) into a ring of kStages
// stages, each guarded by a "full" mbarrier (transaction bytes) and an
// "empty" one (the 128 consumers arrive when done with it).  Tiles are
// 128-byte swizzled (64-byte at dh = 32; dh = 128 is two 64-column
// blocks), the layout the wgmma descriptors name.  For each key tile the
// warpgroup issues S = Q.K^T as wgmma m64n64k16 with both operands in
// shared memory (K rows are dh-contiguous: K-major B), then runs the
// online softmax in the accumulator's register layout (each thread holds
// two rows; row max and row sum take two quad shuffles; exp2 of scores
// pre-scaled by log2 e), and issues O += P.V as wgmma m64n{dh}k16 with P
// from registers and V read transposed from shared memory.  P stays at
// fp32 precision: it goes in as P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// two products into the same fp32 accumulator (about 16 bits of P, one
// more product per tile); a P rounded once to bf16 would be a different
// function from the TPU kernel's fp32 P.V.  Row max starts at -1e30, not
// -inf, so a row that sees no key gives 0, not NaN.  Only live rows are
// stored.
//
// float32: the CUDA cores, 128 threads per 32 query rows, 4 threads per
// row.  Thread r of a row owns the columns c = r + 4 i of q and of the
// accumulator; a tile of 64 keys (32 when dh = 128) is staged in shared
// memory; each row's four threads form each score with two shuffles.
// TF32 tensor cores would keep about three digits, and fp32 callers
// (the card tests, the fp32 card-vs-CPU checks) hold the kernel to
// 1e-5, so fp32 stays exact fp32.
//
// What bounds it now: at T = 512 the longest block (the last 64 rows)
// walks 8 key tiles one after another, each a Q.K^T, a softmax and a
// P.V that wait on one another; the grid is 112 blocks on 132 SMs.
// Issuing the next tile's Q.K^T before this tile's softmax (two score
// buffers) gained nothing at T = 512 on an H100 and lost at T = 2048,
// so the loop stays serial.  Left for later: a second consumer
// warpgroup (two 64-row tiles taking turns on the tensor cores), and a
// persistent grid that balances the causal triangle's long and short
// rows.

#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- float32: CUDA cores ------------------------------------------------

constexpr int kRows = 32;    // query rows per block
constexpr int kLanes = 4;    // threads per query row
constexpr int kSimtThreads = kRows * kLanes;

template <int kDh>
__global__ void __launch_bounds__(kSimtThreads)
simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out,
            float* __restrict__ lse, int t_len, int s_len, int heads,
            int kv_heads, int causal, int window, float scale) {
  constexpr int kCols = kDh / kLanes;          // columns a thread owns
  constexpr int kKeys = kDh <= 64 ? 64 : 32;   // keys per staged tile
  __shared__ float ks[kKeys][kDh];
  __shared__ float vs[kKeys][kDh];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int q0 = blockIdx.x * kRows;
  const int qi = q0 + row;
  const bool live = qi < t_len;
  const int off = s_len - t_len;
  const int qpos = qi + off;

  float qr[kCols], acc[kCols];
  const int64_t qbase =
      (static_cast<int64_t>(b) * t_len + qi) * heads * kDh +
      static_cast<int64_t>(h) * kDh;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    qr[c] = live ? q[qbase + lane + kLanes * c] : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegBig, l = 0.f;

  // keys any row of this block can see
  int kv_lo = 0, kv_hi = s_len;
  if (causal) {
    const int last_row = min(q0 + kRows, t_len) - 1;
    kv_hi = min(s_len, last_row + off + 1);
    if (window > 0) kv_lo = max(0, q0 + off - window + 1);
  }
  const int64_t kv_row = static_cast<int64_t>(kv_heads) * kDh;
  const int64_t kv_base =
      static_cast<int64_t>(b) * s_len * kv_row + static_cast<int64_t>(hk) * kDh;

  for (int t0 = (kv_lo / kKeys) * kKeys; t0 < kv_hi; t0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kKeys * kDh; i += kSimtThreads) {
      const int j = i / kDh;
      const int c = i - j * kDh;
      const int s = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < s_len) {
        const int64_t o = kv_base + s * kv_row + c;
        kv = k[o];
        vv = v[o];
      }
      ks[j][c] = kv;
      vs[j][c] = vv;
    }
    __syncthreads();

    float sc[kKeys];
    float tmax = kNegBig;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) part += qr[c] * ks[j][lane + kLanes * c];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = t0 + j;
      bool ok = live && kpos < s_len;
      if (causal) {
        ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
      }
      sc[j] = ok ? part * scale : -INFINITY;
      tmax = fmaxf(tmax, sc[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = expf(sc[j] - m_new);  // a masked key gives 0
      psum += p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] += p * vs[j][lane + kLanes * c];
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      out[qbase + lane + kLanes * c] = acc[c] * inv;
    // the row's four lanes hold the same m and l
    if (lse != nullptr && lane == 0)
      lse[static_cast<int64_t>(bh) * t_len + qi] =
          l > 0.f ? m + logf(l) : INFINITY;
  }
}

template <int kDh>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                float* lse, int batch, int t_len, int s_len, int heads,
                int kv_heads, int causal, int window, float scale,
                cudaStream_t stream) {
  const dim3 grid((t_len + kRows - 1) / kRows, batch * heads);
  simt_kernel<kDh><<<grid, kSimtThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, t_len,
      s_len, heads, kv_heads, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16: wgmma fed by TMA -----------------------------------------

constexpr int kStages = 3;      // ring of k/v stages
constexpr int kConsumers = 128;  // one warpgroup computes
constexpr int kTcThreads = kConsumers + 32;  // and one warp loads

// q, kStages k and v tiles, 1024-byte aligned; the barriers; and the
// slack to align the dynamic shared memory's base
template <int kDh>
constexpr int tc_smem_bytes() {
  return (1 + 2 * kStages) * Tile<kDh>::kBytes + (2 * kStages + 1) * 8 +
         1024;
}

template <int kDh>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
          int t_len, int s_len, int heads, int kv_heads, int causal,
          int window, float scale_log2) {
  using L = Tile<kDh>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kBytes;  // k stages, then v stages
  const uint32_t bars = base + (1 + 2 * kStages) * L::kBytes;
  const uint32_t qbar = bars + 16 * kStages;
  // full[st] at bars + 8 st, empty[st] at bars + 8 (kStages + st)

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int off = s_len - t_len;

  // keys any row of this block can see, in whole tiles
  int kv_lo = 0, kv_hi = s_len;
  if (causal) {
    const int last_row = min(q0 + kTile, t_len) - 1;
    kv_hi = min(s_len, last_row + off + 1);
    if (window > 0) kv_lo = max(0, q0 + off - window + 1);
  }
  const int t_first = (kv_lo / kTile) * kTile;
  const int n_tiles = kv_hi > t_first ? (kv_hi - t_first + kTile - 1) / kTile
                                      : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer: one lane keeps the ring of stages full
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(qbar, L::kBytes);
#pragma unroll
      for (int a = 0; a < L::kAtoms; ++a)
        tma_load(q_s + a * L::kBlockBytes, &qmap, qbar,
                 h * kDh + a * L::kCols, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(bars + 8 * (kStages + st),
                                    (i / kStages - 1) & 1);
        const uint32_t full = bars + 8 * st;
        mbar_expect_tx(full, 2 * L::kBytes);
        const int t0 = t_first + i * kTile;
        const uint32_t ks = kv_s + st * L::kBytes;
        const uint32_t vs = kv_s + (kStages + st) * L::kBytes;
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(ks + a * L::kBlockBytes, &kmap, full,
                   hk * kDh + a * L::kCols, t0, b);
          tma_load(vs + a * L::kBlockBytes, &vmap, full,
                   hk * kDh + a * L::kCols, t0, b);
        }
      }
    }
    return;
  }

  // the consumers: thread t holds rows r0 = 16 (t / 32) + (t % 32) / 4
  // and r1 = r0 + 8 of the tile, columns 8 j + cq and 8 j + cq + 1
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int pos0 = q0 + r0 + off;
  const int pos1 = pos0 + 8;
  float o[kDh / 2];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) o[i] = 0.f;
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int t0 = t_first + i * kTile;
    const uint32_t ks = kv_s + st * L::kBytes;
    const uint32_t vs = kv_s + (kStages + st) * L::kBytes;
    mbar_wait(bars + 8 * st, (i / kStages) & 1);

    // S = Q . K^T
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<kDh>(q_s, kk), kmajor_desc<kDh>(ks, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(s);

    // scores in log2 units, masked where some row of the tile may not
    // see some key of it
    const bool whole =
        t0 + kTile <= s_len &&
        (!causal || (t0 + kTile - 1 <= q0 + off &&
                     (window <= 0 || t0 > q0 + kTile - 1 + off - window)));
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * j + e] * scale_log2;
        float x1 = s[4 * j + 2 + e] * scale_log2;
        if (!whole) {
          const int kpos = t0 + 8 * j + cq + e;
          if (!visible(kpos, pos0, s_len, causal, window)) x0 = -INFINITY;
          if (!visible(kpos, pos1, s_len, causal, window)) x1 = -INFINITY;
        }
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0);
    const float a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp2(S - m) as hi and lo bf16 A fragments: register 4 kk + q
    // of each holds the pair the A layout wants for keys 16 kk .. + 15
    uint32_t hi[16], lo[16];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = exp2f(s[4 * j] - mn0);  // a masked key gives 0
      const float p01 = exp2f(s[4 * j + 1] - mn0);
      const float p10 = exp2f(s[4 * j + 2] - mn1);
      const float p11 = exp2f(s[4 * j + 3] - mn1);
      ps0 += p00 + p01;
      ps1 += p10 + p11;
      split_bf16(p00, p01, hi[2 * j], lo[2 * j]);
      split_bf16(p10, p11, hi[2 * j + 1], lo[2 * j + 1]);
    }
    l0 = l0 * a0 + ps0;  // this thread's columns; summed over the quad
    l1 = l1 * a1 + ps1;  // at the end
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P_hi . V + P_lo . V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t vd = mnmajor_desc<kDh>(vs, kk);
      wgmma_rs<kDh>(o, &hi[4 * kk], vd);
      wgmma_rs<kDh>(o, &lo[4 * kk], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kDh / 2>(o);
    mbar_arrive(bars + 8 * (kStages + st));  // the stage may be refilled
  }

#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  const int64_t stride = static_cast<int64_t>(heads) * kDh;
  __nv_bfloat16* base0 = out + (static_cast<int64_t>(b) * t_len + row0) *
                                   stride + static_cast<int64_t>(h) * kDh;
  __nv_bfloat16* base1 = base0 + 8 * stride;
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    if (row0 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(base0 + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row1 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(base1 + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  // the log-sum-exp of each live row's scaled scores, in natural-log
  // units (m and l are in log2 units): +inf where the row sees no key
  if (lse != nullptr && (lane & 3) == 0) {
    float* lrow = lse + static_cast<int64_t>(bh) * t_len;
    if (row0 < t_len)
      lrow[row0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : INFINITY;
    if (row1 < t_len)
      lrow[row1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : INFINITY;
  }
}

template <int kDh>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int batch, int t_len, int s_len, int heads,
              int kv_heads, int causal, int window, float scale,
              cudaStream_t stream) {
  using L = Tile<kDh>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const CUtensorMapSwizzle swizzle = tile_swizzle<kDh>();
  // with no keys no k/v tile is loaded: the maps then describe a part
  // of q, so that they are valid
  const int rows = s_len > 0 ? s_len : 1;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(encode, &qmap, q, heads * kDh, t_len, batch, L::kCols,
                swizzle) ||
      !make_map(encode, &kmap, s_len > 0 ? k : q, kv_heads * kDh, rows,
                batch, L::kCols, swizzle) ||
      !make_map(encode, &vmap, s_len > 0 ? v : q, kv_heads * kDh, rows,
                batch, L::kCols, swizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      tc_kernel<kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_smem_bytes<kDh>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((t_len + kTile - 1) / kTile, batch * heads);
  tc_kernel<kDh><<<grid, kTcThreads, tc_smem_bytes<kDh>(), stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), lse, t_len, s_len,
      heads, kv_heads, causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int batch, int t_len, int s_len, int heads, int kv_heads,
           int causal, int window, int dtype, float scale,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_simt<kDh>(q, k, v, out, lse, batch, t_len, s_len, heads,
                            kv_heads, causal, window, scale, stream);
  if (dtype == 1)
    return launch_tc<kDh>(q, k, v, out, lse, batch, t_len, s_len, heads,
                          kv_heads, causal, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, loaded with ctypes.  q: [batch, t_len, heads, head_dim];
// k, v: [batch, s_len, kv_heads, head_dim]; out like q; all contiguous,
// of one dtype (0 float32: the CUDA-core kernel; 1 bfloat16: the wgmma
// kernel, whose q, k and v must be 16-byte aligned for TMA).  lse, where
// not null, is fp32 [batch, heads, t_len]: each row's log-sum-exp of its
// scaled scores in natural-log units (+inf for a row that sees no key),
// the input csrc/flash_attention_bwd.cu reads.  window <= 0 means none.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// dim other than 32, 64 or 128, another dtype, heads not a multiple of
// kv_heads, or a tensor map the CUDA driver refuses).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int batch, int t_len,
                               int s_len, int heads, int kv_heads,
                               int head_dim, int causal, int window,
                               int dtype, float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || batch * heads > 65535 ||
      s_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, out, l, batch, t_len, s_len, heads,
                        kv_heads, causal, window, dtype, scale, s);
    case 64:
      return launch<64>(q, k, v, out, l, batch, t_len, s_len, heads,
                        kv_heads, causal, window, dtype, scale, s);
    case 128:
      return launch<128>(q, k, v, out, l, batch, t_len, s_len, heads,
                         kv_heads, causal, window, dtype, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
