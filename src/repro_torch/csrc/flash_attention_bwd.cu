// Causal / sliding-window attention backward: dq, dk, dv of the function
// csrc/flash_attention.cu computes.
//
// Replaces no TPU kernel.  The JAX package trains through XLA's autodiff
// of its jnp attention (jax.value_and_grad at src/repro/launch/steps.py:34,
// through _sdpa in src/repro/models/attention.py); its Pallas
// flash_attention kernel has no backward.  The port's forward runs on the
// CUDA kernel of csrc/flash_attention.cu, launched through ctypes, so
// autograd cannot differentiate it: this is the gradient that
// repro_torch.kernels.flash_attention.ops.mha's backward launches.
//
// Semantics, those of the forward:
//   * q [B, T, H, dh], k, v [B, S, Hk, dh]; query head h reads kv head
//     h / (H / Hk);
//   * causal: query row i sits at position i + S - T and sees key j iff
//     j <= pos, and with a window w also j > pos - w (the window applies
//     only with causal);
//   * scores s = (q . k) * scale, P = softmax(s) in fp32;
//   * D = rowsum(dO * O) with O the forward's output as stored (bf16 when
//     the forward ran in bf16), dP = dO . V^T, dS = P * (dP - D),
//     dq = scale * dS . K, dk = scale * dS^T . Q, dv = P^T . dO, all in
//     fp32, stored once in q's dtype;
//   * a row that sees no key has P = 0: it adds nothing, and its dq is 0.
//
// P comes from the forward's log-sum-exp (the lse input, fp32 [B, H, T],
// natural-log units, +inf where a row sees no key: see
// csrc/flash_attention.cu): P = exp(s - LSE), so no kernel here forms a
// softmax of its own.  No atomics anywhere: every output element has one
// writer, so two calls on the same inputs give the same bits.
//
// bfloat16 (the training path): warpgroup MMA fed by TMA, the forward's
// template (the tile layout, mbarrier ring and wgmma descriptors of
// csrc/hopper_tc.cuh).  Three kernels:
//
// A (dq): one block per (64 query rows, query head, batch); one producer
//   warp loads the q and dO tiles once and each 64-key tile of k and v
//   the rows can see into a ring of kBwdStages stages; one consumer
//   warpgroup first forms D for its rows from O and dO (each quad of
//   threads one row pair, dh / 4 columns a thread, 16-byte loads) and
//   writes D and LSE * log2 e to fp32 scratch [B, H, T rounded up to 64]
//   (rows past T: 0 and +inf) for kernel B; then, key tile by key tile,
//   S = Q.K^T and dP = dO.V^T (wgmma m64n64k16, both operands in shared
//   memory), P = exp2(S * scale * log2 e - LSE2) and dS = P * (dP - D) in
//   the accumulator's registers, and dq += dS . K (wgmma m64n{dh}k16, dS
//   from registers, K read transposed from shared memory, as the forward
//   reads V).
// B (dk, dv): one block per (64 keys, query head, batch), so the grid
//   runs over query heads, not kv heads (112 blocks at Qwen2-0.5B's T =
//   512, 864 at StarCoder2-15B's heads over T = 1100).  K and V tiles
//   stay in shared memory; the producer brings each query tile that sees
//   the block's keys (q, dO, and the 64 LSE2 and D values by bulk copy)
//   through the ring.  Per tile: S^T = K.Q^T and dP^T = V.dO^T, P^T and
//   dS^T = P^T * (dP^T - D) in registers (rows are keys, columns queries),
//   dv += P^T . dO, dk += dS^T . Q.  At dh = 128 two consumer warpgroups
//   each compute S^T and dP^T and own 64 of dk's and dv's columns (one
//   warpgroup would hold 2 x 64 accumulator registers a thread before S
//   and dP); below that one warpgroup owns all dh.  Where H = Hk a block
//   stores dk and dv in the output dtype; where a group holds several
//   query heads it stores fp32 partials to scratch [B, S, H, dh] (dk and
//   dv: 2 x B S H dh x 4 bytes, 1.8 MB at Qwen2's T = 512, 54 MB at
//   StarCoder2's shape) and
// C (the group's sum): sums each kv head's group in fixed head order,
//   h = hk G, ..., hk G + G - 1, and narrows to bf16, four columns a
//   thread.
//
// Precision: P and dS enter wgmma as bf16 register operands, each split
// as hi = bf16(x) and lo = bf16(x - hi), two products into one fp32
// accumulator (about 16 bits of the operand), as the forward does for P.
// The CPU design test (tests/test_torch_attention_bwd_design.py) shows
// that rounding any of the three operands once -- P in dv, dS in dq, dS
// in dk -- breaks chip_smoke.py's ATTN_STEPS limit at MiniCPM-2B's and
// Qwen2-0.5B's shapes (8-18 times the limit), and that the split design
// stays within half of it.  So each tile costs S, dP and two products
// for each of dq (kernel A), dv and dk (kernel B).
//
// Masks: kernel A walks the key tiles its rows can see, kernel B the
// query tiles that see its keys (the tile-skipping bounds of the first
// design); inside a tile masked lanes give P = 0 and so dS = 0, and rows
// past T read LSE2 = +inf.  Rows past T or keys past S of a tile are
// zero-filled by TMA, so T and S take any value.
//
// Registers a thread (nvcc -Xptxas -v for sm_90a, the toolkit of the
// machine with the card; chip_smoke.py prints the build's lines): kernel A
// holds dh / 2 accumulator registers, 32 for S, 32 for dP and 32 for
// the dS fragments, and takes 108 / 127 / 159 at dh = 32 / 64 / 128;
// kernel B holds 2 x kN / 2 (kN = the columns a warpgroup owns), the
// same 32 + 32 + 32, and takes 138 / 173 / 167 (one warpgroup of 64
// columns would need 2 x 64 accumulators before S and dP at dh = 128,
// hence two there); kernel C 40; the fp32 kernels 96-155.  No build
// spills.
//
// float32: the CUDA cores in exact fp32 (fp32 callers hold the kernel to
// 1e-5 of the largest gradient, which TF32 would not keep), the first
// design without its LSE pass: 64-row fp32 tiles in shared memory, rows
// padded to dh + 1 words.  A (dq): one block per (64 query rows, head,
// batch); D from O, then one pass over the key tiles: P = exp(s - LSE),
// dS, dq += dS . K; D to fp32 scratch [B, H, T].  B (dk, dv): one block
// per (64 keys, kv head, batch), walking the group's query heads.
//
// What bounds the function on an H100: the five products are 2 * 5 * dh
// FLOPs for each (query, key) pair the mask leaves, for each query head;
// at MiniCPM-2B's training shape (B = 8, T = 64, H = Hk = 36, dh = 64)
// that is 0.38 GFLOP (0.39 us at the bf16 tensor-core rate) against
// 18.9 MB of q, k, v, out, dout, dq, dk, dv in bf16 (5.6 us at HBM
// bandwidth): bytes bound it there; at StarCoder2's heads (H = 48, dh =
// 128, W = 512, T = 1100) the products do.

#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---- float32: CUDA cores ------------------------------------------------

constexpr int kBQ = 64;      // query rows a tile
constexpr int kBK = 64;      // keys a tile
constexpr int kThreads = 256;

// Loads rows [row0, row0 + 64) of one head of x ([B, L, heads, DH]) into
// a padded fp32 tile; rows at or past L are zero.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* x, int b,
                                          int row0, int len, int heads,
                                          int head) {
  constexpr int LD = DH + 1;
  for (int i = threadIdx.x; i < 64 * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, row = row0 + r;
    float val = 0.f;
    if (row < len)
      val = x[((static_cast<size_t>(b) * len + row) * heads + head) * DH + d];
    dst[r * LD + d] = val;
  }
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (DH + 1) + kBQ * (kBK + 1) + 2 * kBQ);
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (DH + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ dq,
                   float* __restrict__ dsum_out, int t_len, int s_len,
                   int heads, int kv_heads, int causal, int window,
                   float scale) {
  constexpr int LD = DH + 1;
  constexpr int SLD = kBK + 1;
  constexpr int ROWS = kBQ * DH / kThreads;  // dq rows a thread
  constexpr int RSTEP = kThreads / DH;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sS = sV + kBK * LD;
  float* sLse = sS + kBQ * SLD;
  float* sD = sLse + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x;

  load_tile<DH>(sQ, q, b, q0, t_len, heads, h);
  load_tile<DH>(sdO, dout, b, q0, t_len, heads, h);
  load_tile<DH>(sV, o, b, q0, t_len, heads, h);  // O, for D only
  __syncthreads();
  if (tid < kBQ) {
    float acc = 0.f;
    for (int d = 0; d < DH; ++d) acc += sdO[tid * LD + d] * sV[tid * LD + d];
    sD[tid] = acc;
    const int t = q0 + tid;
    sLse[tid] = t < t_len
                    ? lse[(static_cast<size_t>(b) * heads + h) * t_len + t]
                    : INFINITY;
  }

  // the keys some row of the tile sees
  int k_lo = 0, k_hi = s_len;
  if (causal) {
    const int off = s_len - t_len;
    k_hi = min(s_len, min(q0 + kBQ, t_len) + off);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }
  const int k_first = (k_lo / kBK) * kBK;

  const int c = tid % kBK;   // this thread's key column of a tile
  const int rb = tid / kBK;  // and its first row (rows rb + 4 i)

  // dS tile by tile, dq += dS . K
  const int dcol = tid % DH, rfirst = tid / DH;
  float dq_acc[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) dq_acc[j] = 0.f;
  for (int kt = k_first; kt < k_hi; kt += kBK) {
    __syncthreads();
    load_tile<DH>(sK, k, b, kt, s_len, kv_heads, hk);
    load_tile<DH>(sV, v, b, kt, s_len, kv_heads, hk);
    __syncthreads();
    float s_acc[16], dp_acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s_acc[i] = dp_acc[i] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float kv = sK[c * LD + d], vv = sV[c * LD + d];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = rb + 4 * i;
        s_acc[i] += sQ[r * LD + d] * kv;
        dp_acc[i] += sdO[r * LD + d] * vv;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = rb + 4 * i;
      float ds = 0.f;
      if (q0 + r < t_len &&
          visible(kt + c, q0 + r + s_len - t_len, s_len, causal, window)) {
        const float p = expf(s_acc[i] * scale - sLse[r]);
        ds = p * (dp_acc[i] - sD[r]);
      }
      sS[r * SLD + c] = ds;
    }
    __syncthreads();
    for (int j = 0; j < kBK; ++j) {
      const float kv = sK[j * LD + dcol];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        dq_acc[i] += sS[(rfirst + RSTEP * i) * SLD + j] * kv;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = q0 + rfirst + RSTEP * i;
    if (t < t_len)
      dq[((static_cast<size_t>(b) * t_len + t) * heads + h) * DH + dcol] =
          dq_acc[i] * scale;
  }
  if (tid < kBQ && q0 + tid < t_len)
    dsum_out[(static_cast<size_t>(b) * heads + h) * t_len + q0 + tid] =
        sD[tid];
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dk,
                    float* __restrict__ dv, int t_len, int s_len, int heads,
                    int kv_heads, int causal, int window, float scale) {
  constexpr int LD = DH + 1;
  constexpr int PLD = kBQ + 1;
  constexpr int COLS = kBK * DH / kThreads;  // dk, dv keys a thread
  constexpr int CSTEP = kThreads / DH;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;
  float* sdS = sP + kBK * PLD;
  float* sLse = sdS + kBK * PLD;
  float* sD = sLse + kBQ;

  const int c0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int group = heads / kv_heads;
  const int tid = threadIdx.x;

  load_tile<DH>(sK, k, b, c0, s_len, kv_heads, hk);
  load_tile<DH>(sV, v, b, c0, s_len, kv_heads, hk);

  // the query rows that see some key of the tile
  int i_lo = 0, i_hi = t_len;
  if (causal) {
    const int off = s_len - t_len;
    i_lo = max(0, c0 - off);
    if (window > 0) i_hi = min(t_len, min(c0 + kBK, s_len) - 1 + window - off);
  }
  const int i_first = (i_lo / kBQ) * kBQ;

  const int r = tid % kBQ;   // this thread's query row of a tile
  const int cb = tid / kBQ;  // and its first key (keys cb + 4 i)
  const int dcol = tid % DH, cfirst = tid / DH;
  float dk_acc[COLS], dv_acc[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = i_first; qt < i_hi; qt += kBQ) {
      __syncthreads();
      load_tile<DH>(sQ, q, b, qt, t_len, heads, h);
      load_tile<DH>(sdO, dout, b, qt, t_len, heads, h);
      if (tid < kBQ) {
        const int t = qt + tid;
        const size_t at = (static_cast<size_t>(b) * heads + h) * t_len + t;
        sLse[tid] = t < t_len ? lse[at] : INFINITY;
        sD[tid] = t < t_len ? dsum[at] : 0.f;
      }
      __syncthreads();
      float s_acc[16], dp_acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s_acc[i] = dp_acc[i] = 0.f;
      for (int d = 0; d < DH; ++d) {
        const float qv = sQ[r * LD + d], dov = sdO[r * LD + d];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int cc = cb + 4 * i;
          s_acc[i] += sK[cc * LD + d] * qv;
          dp_acc[i] += sV[cc * LD + d] * dov;
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int cc = cb + 4 * i;
        float p = 0.f, ds = 0.f;
        if (qt + r < t_len && visible(c0 + cc, qt + r + s_len - t_len,
                                      s_len, causal, window)) {
          p = expf(s_acc[i] * scale - sLse[r]);
          ds = p * (dp_acc[i] - sD[r]);
        }
        sP[cc * PLD + r] = p;
        sdS[cc * PLD + r] = ds;
      }
      __syncthreads();
      for (int j = 0; j < kBQ; ++j) {
        const float qv = sQ[j * LD + dcol], dov = sdO[j * LD + dcol];
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
          const int cc = cfirst + CSTEP * i;
          dv_acc[i] += sP[cc * PLD + j] * dov;
          dk_acc[i] += sdS[cc * PLD + j] * qv;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    const int j = c0 + cfirst + CSTEP * i;
    if (j < s_len) {
      const size_t at =
          ((static_cast<size_t>(b) * s_len + j) * kv_heads + hk) * DH + dcol;
      dk[at] = dk_acc[i] * scale;
      dv[at] = dv_acc[i];
    }
  }
}

template <int DH>
int launch_simt(const float* q, const float* k, const float* v,
                const float* o, const float* dout, const float* lse,
                float* dq, float* dk, float* dv, float* dsum, int batch,
                int t_len, int s_len, int heads, int kv_heads, int causal,
                int window, float scale, cudaStream_t stream) {
  constexpr size_t a_bytes = dq_smem_bytes<DH>();
  constexpr size_t b_bytes = dkv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_simt_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(a_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_simt_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(b_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a((t_len + kBQ - 1) / kBQ, heads, batch);
  dq_simt_kernel<DH><<<grid_a, kThreads, a_bytes, stream>>>(
      q, k, v, o, dout, lse, dq, dsum, t_len, s_len, heads, kv_heads, causal,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b((s_len + kBK - 1) / kBK, kv_heads, batch);
  dkv_simt_kernel<DH><<<grid_b, kThreads, b_bytes, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, t_len, s_len, heads, kv_heads, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16: wgmma fed by TMA -----------------------------------------

constexpr int kBwdStages = 2;  // ring of k/v (A) or q/dO (B) stages
constexpr int kWarpgroup = 128;

// rows of T that scratch holds per (batch, head): T rounded up to a tile
__host__ __device__ __forceinline__ int padded_rows(int t_len) {
  return (t_len + kTile - 1) / kTile * kTile;
}

template <int kDh>
struct KernelA {
  static constexpr int kConsumers = kWarpgroup;
  static constexpr int kThreads = kConsumers + 32;  // and one loading warp
  // q, dO, kBwdStages k and v tiles (1024-byte aligned), the barriers,
  // and the slack to align the dynamic shared memory's base
  static constexpr int kSmem = (2 + 2 * kBwdStages) * Tile<kDh>::kBytes +
                               (2 * kBwdStages + 1) * 8 + 1024;
};

template <int kDh>
struct KernelB {
  static constexpr int kGroups = kDh == 128 ? 2 : 1;  // warpgroups
  static constexpr int kN = kDh / kGroups;  // dk, dv columns a warpgroup
  static constexpr int kConsumers = kGroups * kWarpgroup;
  static constexpr int kThreads = kConsumers + 32;
  // k and v, kBwdStages q and dO tiles, kBwdStages (LSE2, D) rows of 64
  // floats each, the barriers and the slack
  static constexpr int kSmem = (2 + 2 * kBwdStages) * Tile<kDh>::kBytes +
                               kBwdStages * 2 * kTile * 4 +
                               (2 * kBwdStages + 1) * 8 + 1024;
};

// sum over kPer columns of a * b, both bf16, 16-byte loads
template <int kPer>
__device__ __forceinline__ float dot_bf16(const __nv_bfloat16* a,
                                          const __nv_bfloat16* b) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; i += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + i);
    const uint4 y = *reinterpret_cast<const uint4*>(b + i);
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 xf = __bfloat1622float2(xs[j]);
      const float2 yf = __bfloat1622float2(ys[j]);
      acc += xf.x * yf.x + xf.y * yf.y;
    }
  }
  return acc;
}

template <int kDh>
__global__ void __launch_bounds__(KernelA<kDh>::kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap domap,
             const __nv_bfloat16* __restrict__ out,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
             float* __restrict__ lse2_out, float* __restrict__ dsum_out,
             int t_len, int s_len, int heads, int kv_heads, int causal,
             int window, float scale, float scale_log2) {
  using L = Tile<kDh>;
  constexpr int kConsumers = KernelA<kDh>::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + L::kBytes;
  const uint32_t kv_s = base + 2 * L::kBytes;  // k stages, then v stages
  const uint32_t bars = base + (2 + 2 * kBwdStages) * L::kBytes;
  const uint32_t qbar = bars + 16 * kBwdStages;
  // full[st] at bars + 8 st, empty[st] at bars + 8 (kBwdStages + st)

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int off = s_len - t_len;

  // the keys some row of the tile sees, in whole tiles
  int k_lo = 0, k_hi = s_len;
  if (causal) {
    k_hi = min(s_len, min(q0 + kTile, t_len) + off);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }
  const int t_first = (k_lo / kTile) * kTile;
  const int n_tiles =
      k_hi > t_first ? (k_hi - t_first + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kBwdStages + st), kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer: one lane keeps the ring of stages full
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(qbar, 2 * L::kBytes);
#pragma unroll
      for (int a = 0; a < L::kAtoms; ++a) {
        tma_load(q_s + a * L::kBlockBytes, &qmap, qbar,
                 h * kDh + a * L::kCols, q0, b);
        tma_load(do_s + a * L::kBlockBytes, &domap, qbar,
                 h * kDh + a * L::kCols, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kBwdStages;
        if (i >= kBwdStages)
          mbar_wait(bars + 8 * (kBwdStages + st),
                    (i / kBwdStages - 1) & 1);
        const uint32_t full = bars + 8 * st;
        mbar_expect_tx(full, 2 * L::kBytes);
        const int t0 = t_first + i * kTile;
        const uint32_t ks = kv_s + st * L::kBytes;
        const uint32_t vs = kv_s + (kBwdStages + st) * L::kBytes;
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
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  const int pos0 = row0 + off;
  const int pos1 = pos0 + 8;

  // D of both rows from O and dO as stored, the quad's four threads
  // taking dh / 4 columns each; LSE in log2 units; rows past T: D = 0,
  // LSE2 = +inf
  constexpr int kPer = kDh / 4;
  const int64_t stride = static_cast<int64_t>(heads) * kDh;
  const int64_t at0 = (static_cast<int64_t>(b) * t_len + row0) * stride +
                      static_cast<int64_t>(h) * kDh + (lane % 4) * kPer;
  float d0 = row0 < t_len ? dot_bf16<kPer>(out + at0, dout + at0) : 0.f;
  float d1 = row1 < t_len ? dot_bf16<kPer>(out + at0 + 8 * stride,
                                           dout + at0 + 8 * stride)
                          : 0.f;
#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, d);
    d1 += __shfl_xor_sync(0xffffffffu, d1, d);
  }
  const int64_t lrow = (static_cast<int64_t>(b) * heads + h) * t_len;
  const float lse0 = row0 < t_len ? lse[lrow + row0] * kLog2e : INFINITY;
  const float lse1 = row1 < t_len ? lse[lrow + row1] * kLog2e : INFINITY;
  if ((lane & 3) == 0) {  // kernel B's copies, every row of the tile
    const int64_t at = (static_cast<int64_t>(b) * heads + h) *
                           padded_rows(t_len) + row0;
    lse2_out[at] = lse0;
    lse2_out[at + 8] = lse1;
    dsum_out[at] = d0;
    dsum_out[at + 8] = d1;
  }

  float acc[kDh / 2];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) acc[i] = 0.f;

  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kBwdStages;
    const int t0 = t_first + i * kTile;
    const uint32_t ks = kv_s + st * L::kBytes;
    const uint32_t vs = kv_s + (kBwdStages + st) * L::kBytes;
    mbar_wait(bars + 8 * st, (i / kBwdStages) & 1);

    // S = Q . K^T and dP = dO . V^T
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<kDh>(q_s, kk), kmajor_desc<kDh>(ks, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<kDh>(do_s, kk), kmajor_desc<kDh>(vs, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // dS = P * (dP - D), P = exp2(S * scale log2 e - LSE2), 0 where a row
    // of the tile does not see a key of it
    const bool whole =
        t0 + kTile <= s_len &&
        (!causal || (t0 + kTile - 1 <= q0 + off &&
                     (window <= 0 || t0 > q0 + kTile - 1 + off - window)));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2f(s[4 * j + e] * scale_log2 - lse0);
        float p1 = exp2f(s[4 * j + 2 + e] * scale_log2 - lse1);
        if (!whole) {
          const int kpos = t0 + 8 * j + cq + e;
          if (!visible(kpos, pos0, s_len, causal, window)) p0 = 0.f;
          if (!visible(kpos, pos1, s_len, causal, window)) p1 = 0.f;
        }
        dp[4 * j + e] = p0 * (dp[4 * j + e] - d0);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - d1);
      }
    }

    // dq += dS_hi . K + dS_lo . K
    uint32_t hi[16], lo[16];
    split_tile(dp, hi, lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t kd = mnmajor_desc<kDh>(ks, kk);
      wgmma_rs<kDh>(acc, &hi[4 * kk], kd);
      wgmma_rs<kDh>(acc, &lo[4 * kk], kd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kDh / 2>(acc);
    mbar_arrive(bars + 8 * (kBwdStages + st));  // the stage may be refilled
  }

  __nv_bfloat16* base0 = dq + (static_cast<int64_t>(b) * t_len + row0) *
                                  stride + static_cast<int64_t>(h) * kDh;
  __nv_bfloat16* base1 = base0 + 8 * stride;
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    if (row0 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(base0 + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (row1 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(base1 + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale,
                                acc[4 * j + 3] * scale);
  }
}

template <int kDh>
__global__ void __launch_bounds__(KernelB<kDh>::kThreads, 1)
dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap domap,
              const float* __restrict__ lse2, const float* __restrict__ dsum,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              float* __restrict__ dk_part, float* __restrict__ dv_part,
              int t_len, int s_len, int heads, int kv_heads, int causal,
              int window, float scale, float scale_log2) {
  using L = Tile<kDh>;
  using K = KernelB<kDh>;
  constexpr int kN = K::kN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + L::kBytes;
  const uint32_t q_s = base + 2 * L::kBytes;  // q stages, then dO stages
  const uint32_t ld_s = base + (2 + 2 * kBwdStages) * L::kBytes;
  const uint32_t bars = ld_s + kBwdStages * 2 * kTile * 4;
  const uint32_t kvbar = bars + 16 * kBwdStages;
  // LSE2 of stage st at ld_s + 512 st, D 256 bytes after it; full[st] at
  // bars + 8 st, empty[st] at bars + 8 (kBwdStages + st)
  const float* ld_f = reinterpret_cast<const float*>(smem_raw + (ld_s - raw));

  const int c0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int group = heads / kv_heads;
  const int hk = h / group;
  const int off = s_len - t_len;
  const int t_pad = padded_rows(t_len);

  // the query rows that see some key of the tile, in whole tiles
  int i_lo = 0, i_hi = t_len;
  if (causal) {
    i_lo = max(0, c0 - off);
    if (window > 0)
      i_hi = min(t_len, min(c0 + kTile, s_len) - 1 + window - off);
  }
  const int i_first = (i_lo / kTile) * kTile;
  const int n_tiles =
      i_hi > i_first ? (i_hi - i_first + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kBwdStages + st), K::kConsumers);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= K::kConsumers) {
    if (threadIdx.x == K::kConsumers && n_tiles > 0) {
      mbar_expect_tx(kvbar, 2 * L::kBytes);
#pragma unroll
      for (int a = 0; a < L::kAtoms; ++a) {
        tma_load(k_s + a * L::kBlockBytes, &kmap, kvbar,
                 hk * kDh + a * L::kCols, c0, b);
        tma_load(v_s + a * L::kBlockBytes, &vmap, kvbar,
                 hk * kDh + a * L::kCols, c0, b);
      }
      const float* lrow = lse2 + (static_cast<int64_t>(b) * heads + h) * t_pad;
      const float* drow = dsum + (static_cast<int64_t>(b) * heads + h) * t_pad;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kBwdStages;
        if (i >= kBwdStages)
          mbar_wait(bars + 8 * (kBwdStages + st),
                    (i / kBwdStages - 1) & 1);
        const uint32_t full = bars + 8 * st;
        mbar_expect_tx(full, 2 * L::kBytes + 2 * kTile * 4);
        const int qt = i_first + i * kTile;
        const uint32_t qs = q_s + st * L::kBytes;
        const uint32_t ds = q_s + (kBwdStages + st) * L::kBytes;
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(qs + a * L::kBlockBytes, &qmap, full,
                   h * kDh + a * L::kCols, qt, b);
          tma_load(ds + a * L::kBlockBytes, &domap, full,
                   h * kDh + a * L::kCols, qt, b);
        }
        bulk_load(ld_s + st * 2 * kTile * 4, lrow + qt, kTile * 4, full);
        bulk_load(ld_s + st * 2 * kTile * 4 + kTile * 4, drow + qt,
                  kTile * 4, full);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns dk's and dv's columns wg kN ..; its
  // thread t holds keys r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8 of the
  // tile (rows of S^T), queries 8 j + cq and 8 j + cq + 1 (columns)
  const int wg = threadIdx.x / kWarpgroup;
  const int t = threadIdx.x % kWarpgroup;
  const int warp = t / 32;
  const int lane = t % 32;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int key0 = c0 + r0;
  const int key1 = key0 + 8;
  const uint32_t col_off = wg * kN * 2 / L::kRowBytes * L::kBlockBytes;

  float dk_acc[kN / 2], dv_acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n_tiles > 0) mbar_wait(kvbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kBwdStages;
    const int qt = i_first + i * kTile;
    const uint32_t qs = q_s + st * L::kBytes;
    const uint32_t ds = q_s + (kBwdStages + st) * L::kBytes;
    const float* l_sm = ld_f + st * 2 * kTile;
    const float* d_sm = l_sm + kTile;
    mbar_wait(bars + 8 * st, (i / kBwdStages) & 1);

    // S^T = K . Q^T and dP^T = V . dO^T
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<kDh>(k_s, kk), kmajor_desc<kDh>(qs, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<kDh>(v_s, kk), kmajor_desc<kDh>(ds, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // P^T and dS^T = P^T * (dP^T - D), 0 where a query of the tile does
    // not see a key of it
    const bool whole =
        c0 + kTile <= s_len &&
        (!causal || (c0 + kTile - 1 <= qt + off &&
                     (window <= 0 || c0 > qt + kTile - 1 + off - window)));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + cq + e;
        const float l2 = l_sm[col];
        const float dd = d_sm[col];
        float p0 = exp2f(s[4 * j + e] * scale_log2 - l2);
        float p1 = exp2f(s[4 * j + 2 + e] * scale_log2 - l2);
        if (!whole) {
          const int qpos = qt + col + off;
          if (!visible(key0, qpos, s_len, causal, window)) p0 = 0.f;
          if (!visible(key1, qpos, s_len, causal, window)) p1 = 0.f;
        }
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
        dp[4 * j + e] = p0 * (dp[4 * j + e] - dd);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dd);
      }
    }

    // dv += P^T_hi . dO + P^T_lo . dO
    uint32_t hi[16], lo[16];
    split_tile(s, hi, lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t dd = mnmajor_desc<kDh>(ds + col_off, kk);
      wgmma_rs<kN>(dv_acc, &hi[4 * kk], dd);
      wgmma_rs<kN>(dv_acc, &lo[4 * kk], dd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kN / 2>(dv_acc);

    // dk += dS^T_hi . Q + dS^T_lo . Q
    split_tile(dp, hi, lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t qd = mnmajor_desc<kDh>(qs + col_off, kk);
      wgmma_rs<kN>(dk_acc, &hi[4 * kk], qd);
      wgmma_rs<kN>(dk_acc, &lo[4 * kk], qd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kN / 2>(dk_acc);
    mbar_arrive(bars + 8 * (kBwdStages + st));  // the stage may be refilled
  }

  const int col0 = wg * kN + cq;
  if (group == 1) {  // the head is its own kv head: store in bf16
    const int64_t stride = static_cast<int64_t>(kv_heads) * kDh;
    const int64_t at = (static_cast<int64_t>(b) * s_len + key0) * stride +
                       static_cast<int64_t>(hk) * kDh + col0;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      if (key0 < s_len) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
            __floats2bfloat162_rn(dk_acc[4 * j] * scale,
                                  dk_acc[4 * j + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
            __floats2bfloat162_rn(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
      if (key1 < s_len) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * stride + 8 * j) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2] * scale,
                                  dk_acc[4 * j + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * stride + 8 * j) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
    return;
  }
  // fp32 partials of this query head, [B, S, H, dh], for kernel C
  const int64_t stride = static_cast<int64_t>(heads) * kDh;
  const int64_t at = (static_cast<int64_t>(b) * s_len + key0) * stride +
                     static_cast<int64_t>(h) * kDh + col0;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    if (key0 < s_len) {
      *reinterpret_cast<float2*>(dk_part + at + 8 * j) =
          make_float2(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
      *reinterpret_cast<float2*>(dv_part + at + 8 * j) =
          make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (key1 < s_len) {
      *reinterpret_cast<float2*>(dk_part + at + 8 * stride + 8 * j) =
          make_float2(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
      *reinterpret_cast<float2*>(dv_part + at + 8 * stride + 8 * j) =
          make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

// Kernel C: dk and dv of each (batch, key, kv head) as the sum of the
// group's partials in head order, narrowed to bf16; four columns a
// thread.  n4 = B S Hk dh / 4.
__global__ void __launch_bounds__(256)
dkv_group_sum_kernel(const float* __restrict__ dk_part,
                     const float* __restrict__ dv_part,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int64_t n4, int group,
                     int head_dim) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t e = 4 * i;
    const int64_t row = e / head_dim;  // (b S + s) Hk + hk
    const int64_t col = e - row * head_dim;
    const int64_t src = row * group * head_dim + col;
    float4 sk = *reinterpret_cast<const float4*>(dk_part + src);
    float4 sv = *reinterpret_cast<const float4*>(dv_part + src);
    for (int g = 1; g < group; ++g) {
      const float4 xk = *reinterpret_cast<const float4*>(
          dk_part + src + static_cast<int64_t>(g) * head_dim);
      const float4 xv = *reinterpret_cast<const float4*>(
          dv_part + src + static_cast<int64_t>(g) * head_dim);
      sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
      sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
    }
    __nv_bfloat162 ok[2] = {__floats2bfloat162_rn(sk.x, sk.y),
                            __floats2bfloat162_rn(sk.z, sk.w)};
    __nv_bfloat162 ov[2] = {__floats2bfloat162_rn(sv.x, sv.y),
                            __floats2bfloat162_rn(sv.z, sv.w)};
    *reinterpret_cast<uint2*>(dk + e) = *reinterpret_cast<const uint2*>(ok);
    *reinterpret_cast<uint2*>(dv + e) = *reinterpret_cast<const uint2*>(ov);
  }
}

template <int kDh>
int launch_tc(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const float* lse, void* dq, void* dk,
              void* dv, float* scratch, int batch, int t_len, int s_len,
              int heads, int kv_heads, int causal, int window, float scale,
              cudaStream_t stream) {
  using L = Tile<kDh>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const CUtensorMapSwizzle swizzle = tile_swizzle<kDh>();
  CUtensorMap qmap, kmap, vmap, domap;
  if (!make_map(encode, &qmap, q, heads * kDh, t_len, batch, L::kCols,
                swizzle) ||
      !make_map(encode, &domap, dout, heads * kDh, t_len, batch, L::kCols,
                swizzle) ||
      !make_map(encode, &kmap, k, kv_heads * kDh, s_len, batch, L::kCols,
                swizzle) ||
      !make_map(encode, &vmap, v, kv_heads * kDh, s_len, batch, L::kCols,
                swizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dq_tc_kernel<kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KernelA<kDh>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_tc_kernel<kDh>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KernelB<kDh>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int group = heads / kv_heads;
  const int64_t rows = static_cast<int64_t>(batch) * heads *
                       padded_rows(t_len);
  float* lse2 = scratch;
  float* dsum = lse2 + rows;
  float* dk_part = dsum + rows;  // only where group > 1
  float* dv_part =
      dk_part + static_cast<int64_t>(batch) * s_len * heads * kDh;
  const float scale_log2 = scale * kLog2e;
  auto* bq = static_cast<__nv_bfloat16*>(dq);
  auto* bk = static_cast<__nv_bfloat16*>(dk);
  auto* bv = static_cast<__nv_bfloat16*>(dv);

  const dim3 grid_a((t_len + kTile - 1) / kTile, heads, batch);
  dq_tc_kernel<kDh><<<grid_a, KernelA<kDh>::kThreads, KernelA<kDh>::kSmem,
                      stream>>>(
      qmap, kmap, vmap, domap, static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), lse, bq, lse2, dsum, t_len,
      s_len, heads, kv_heads, causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b((s_len + kTile - 1) / kTile, heads, batch);
  dkv_tc_kernel<kDh><<<grid_b, KernelB<kDh>::kThreads, KernelB<kDh>::kSmem,
                       stream>>>(
      qmap, kmap, vmap, domap, lse2, dsum, bk, bv, dk_part, dv_part, t_len,
      s_len, heads, kv_heads, causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || group == 1) return static_cast<int>(err);
  const int64_t n4 = static_cast<int64_t>(batch) * s_len * kv_heads * kDh / 4;
  const int64_t want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  dkv_group_sum_kernel<<<blocks, 256, 0, stream>>>(dk_part, dv_part, bk, bv,
                                                   n4, group, kDh);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* scratch, int batch, int t_len, int s_len, int heads,
           int kv_heads, int causal, int window, int dtype, float scale,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_simt<kDh>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), scratch, batch,
        t_len, s_len, heads, kv_heads, causal, window, scale, stream);
  if (dtype == 1)
    return launch_tc<kDh>(q, k, v, o, dout, lse, dq, dk, dv, scratch, batch,
                          t_len, s_len, heads, kv_heads, causal, window,
                          scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The fp32 scratch a call needs, in floats: float32, D [B, H, T]; bfloat16,
// LSE2 and D [B, H, T rounded up to 64] and, where heads > kv_heads, the
// fp32 partials of dk and dv [B, S, H, dh] each.
extern "C" long long flash_attention_bwd_scratch_floats(
    int batch, int t_len, int s_len, int heads, int kv_heads, int head_dim,
    int dtype) {
  const long long bh = static_cast<long long>(batch) * heads;
  if (dtype == 0) return bh * t_len;
  long long n = 2 * bh * padded_rows(t_len);
  if (kv_heads > 0 && heads != kv_heads)
    n += 2 * static_cast<long long>(batch) * s_len * heads * head_dim;
  return n;
}

// dq [B, T, H, dh] and dk, dv [B, S, Hk, dh] in the inputs' dtype (0:
// float32, 1: bfloat16, whose q, k, v, out and dout must be 16-byte
// aligned for TMA); lse is the forward's fp32 [B, H, T]; scratch holds
// flash_attention_bwd_scratch_floats(...) floats.  Launches two kernels
// on ``stream`` (three in bf16 where heads > kv_heads); returns a
// cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* dq, void* dk, void* dv,
                                   void* scratch, int batch, int t_len,
                                   int s_len, int heads, int kv_heads,
                                   int head_dim, int causal, int window,
                                   int dtype, float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || s_len <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || heads > 65535 ||
      batch > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(scratch);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, out, dout, l, dq, dk, dv, w, batch, t_len,
                        s_len, heads, kv_heads, causal, window, dtype, scale,
                        s);
    case 64:
      return launch<64>(q, k, v, out, dout, l, dq, dk, dv, w, batch, t_len,
                        s_len, heads, kv_heads, causal, window, dtype, scale,
                        s);
    case 128:
      return launch<128>(q, k, v, out, dout, l, dq, dk, dv, w, batch, t_len,
                         s_len, heads, kv_heads, causal, window, dtype,
                         scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
