// The gradient of the RWKV6 WKV scan (csrc/wkv6.cu), with the state
// carried in and the final state's gradient taken in.
//
// Replaces no TPU kernel: the JAX package trains RWKV6 through XLA's
// autodiff of its jnp chunked form (src/repro/models/rwkv.py
// _wkv_chunked, under jax.value_and_grad in src/repro/launch/steps.py),
// and its Pallas wkv6 runs only in serving.  This is the backward of the
// port's wkv6 kernel, so that a training step differentiates through the
// kernels (kernels/rwkv6_scan/ops.py wkv6_heads).
//
// What it computes, per (b, h), with S_{t-1} the [dh_k, dh_v] state
// entering step t and G the adjoint of the state after step t (the final
// state's gradient at t = T):
//   dr_t = (S_{t-1} + u (x) k_t^T v_t) do_t
//   dk_t = G v_t + r_t (x) u (v_t . do_t)
//   dv_t = G^T k_t + (r_t . (u (x) k_t)) do_t
//   dlogw_t = w_t (x) sum_v (G (x) S_{t-1})
//   du = sum_{b, t} r_t (x) k_t (v_t . do_t)
//   G <- diag(w_t) G + r_t^T do_t
// and the input state's gradient is the last G, all in fp32; dr, dk, dv
// stored in r's dtype, dlogw, du and the state's gradient in fp32.
//
// What bounds it on an H100.  At RWKV6-7B's training shape (B = 8,
// T = 256, H = 64, dh = 64, bf16) the function reads r, k, v, do (bf16)
// and logw (fp32) and writes dr, dk, dv (bf16) and dlogw (fp32): 185 MB,
// 0.055 ms at 3.35 TB/s.  In the chunked form below its products,
// each counted once (chip_smoke.py's wkv_bwd_flops), are 9.1 GFLOP:
// 0.009 ms at the bf16 tensor-core rate, so the bytes bound it.
//
// The design, picked from t_len and the dtype inside the C entry point:
//
// bfloat16, T > 1: chunk-parallel, the prefill's design (csrc/wkv6.cu)
// run backwards over its chunks of kChunk = 64 steps and strips of kSub
// = 16 (csrc/wkv6_chunk.cuh holds what the two share).  Per chunk c,
// with cum the in-chunk inclusive prefix sum of logw, cumx = cum - logw,
// total the chunk's sum, S_c / S_{c+1} the states entering and leaving
// the chunk and G_c the adjoint leaving it:
//  (a), (b) the states entering each chunk and the final state: the
//      prefill's scratch and final state when the caller saved them (the
//      autograd op does), else the prefill's increments_kernel and
//      pass_kernel run again, bit for bit what its scratch holds;
//  (a'), (b') adjoint_increments_kernel, one block a (b, h, chunk), all
//      at once: the adjoint's increment (r exp(cumx))^T do by the
//      prefill's increment_rows; adjoint_pass_kernel, the prefill's walk
//      backwards, G_{c-1} = exp(total_c) G_c + increment, which leaves
//      each chunk's G_c in the scratch and the input state's gradient;
//  (c) grads_kernel, one block a (b, h, chunk), all at once (its comment
//      has the chunk's formulas): dr, dk, dv and dlogw, each once, and
//      du's per-chunk partial; then reduce_du_kernel sums those over
//      batch rows and chunks in order.
//  dlogw comes from the chunk-local identity
//      dlogw_j = sum_{t>j} r_t dr'_t - sum_{s>=j} k_s dk'_s
//                + sum_v (G_c (x) S_{c+1})
//  (dr', dk': dr, dk without their u terms), not from the per-step
//  w (x) sum_v (G (x) S_{t-1}), which forced a serial walk.  Its terms
//  cancel, and it is held to 2e-5 of its largest value: the operands
//  that feed it (the states and adjoints, the adjoint's increments, the
//  D = do v^T tiles and the decay-weighted k and r they meet) go in as
//  three bf16 pieces, hi + mid + lo, some 24 bits; the states'
//  increments and dv's as pairs, like the prefill's
//  (tests/test_torch_scan_bwd_design.py: pairs there read some 8x the
//  error, a single rounding over 100x the limit).  Every
//  exponent is a non-positive sum over its own stretch of steps, as in
//  the prefill; the diagonal 16 x 16 tiles keep each (t, s) pair's exact
//  exponent on the CUDA cores.  Scratch: 144 MB at the training shape
//  (the serial form below took 537 MB).
//
// float32, and T = 1 in either dtype: wkv6_bwd_kernel, the serial form,
// so that fp32 callers keep exact fp32 products.  One block a (b, h, 16
// value columns); each thread owns one key row i and 4 of the block's
// columns, 4 state elements, so the block holds a [dh, 16] slice of S
// and of G in registers (dh = 32, 64, 128: 128, 256, 512 threads).
//  (1) Forward walk over the chunks of kCkpt = 16 steps: the state
//      entering each chunk goes to a scratch of checkpoints (each thread
//      its own float4, coalesced), and the final state is dropped.
//  (2) Reverse walk over the chunks: each thread reloads its chunk's
//      checkpoint and recomputes the chunk's 16 entering states into
//      registers, then walks the chunk's steps backwards with G.  A
//      state cannot be recovered from the next one by dividing by w_t,
//      which underflows to 0 in fp32 once logw falls below about -87;
//      the checkpoints and the recomputation avoid that, and every
//      factor is the plain recurrence's w_t, never a quotient or
//      exp(-cum) (no exponent is formed but the step's own logw).
//      Each step's sums over the slice's columns (dr, dk, dlogw) are
//      reduced over a row's 4 lanes by shuffles and staged in shared
//      memory; dv's sum over key rows by shuffles over the warp's rows,
//      then over the warps in order at the chunk's end, where the block
//      writes dv (it owns those columns whole) and its column slice's
//      dr, dk, dlogw partials to scratch.
//  (3) reduce_rows_kernel sums the slices' partials in slice order into
//      dr, dk and dlogw = w (x) sum; reduce_du_kernel sums du's per-block
//      partials over batch rows and slices in order.
//  Scratch: the checkpoints, B H ceil(T/16) dh^2 floats, then 3 (dh/16)
//  B T H dh partial floats, then B H dh^2/16 du partials.  Rows past T
//  (the ragged last chunk) are r = k = v = do = 0 and w = 1: they change
//  neither S nor G and are not written.
//
// No atomics in either form: two calls on the same inputs give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wkv6_chunk.cuh"

namespace {

constexpr int kCkpt = 16;             // steps a checkpoint covers
constexpr int kCols = 16;             // value columns a block owns
constexpr int kPer = 4;               // value columns a thread owns
constexpr int kLanes = kCols / kPer;  // threads a key row

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

template <int kDh>
struct Shape {
  static constexpr int kThreads = kDh * kLanes;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSlices = kDh / kCols;
  // shared floats: r, k, w rows and the v, do slices of a chunk, u, the
  // dr, dk, dw partials of a chunk and the warps' dv partials
  static constexpr int kFloats = 3 * kCkpt * kDh + 2 * kCkpt * kCols +
                                 kDh + 3 * kCkpt * kDh +
                                 kCkpt * kWarps * kCols;
  static constexpr int kBytes = kFloats * 4;
  static_assert(kThreads % 32 == 0 && 32 % kLanes == 0, "whole warps");
};

template <typename T, int kDh>
__global__ void __launch_bounds__(Shape<kDh>::kThreads)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u,
                const float* __restrict__ state_in,
                const T* __restrict__ dout,
                const float* __restrict__ dstate, T* __restrict__ dv_out,
                float* __restrict__ dstate_in, float* __restrict__ ckpt,
                float* __restrict__ part, float* __restrict__ du_part,
                int t_len, int heads, int n_chunks, size_t n_rows) {
  using L = Shape<kDh>;
  constexpr int kThreads = L::kThreads;
  constexpr int kWarps = L::kWarps;
  constexpr int kSlices = L::kSlices;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                  // [kCkpt][kDh]
  float* ks = rs + kCkpt * kDh;     // [kCkpt][kDh]
  float* ws = ks + kCkpt * kDh;     // [kCkpt][kDh], exp(logw)
  float* vs = ws + kCkpt * kDh;     // [kCkpt][kCols]
  float* ds = vs + kCkpt * kCols;   // [kCkpt][kCols]
  float* pr = ds + kCkpt * kCols;   // [kCkpt][kDh]
  float* pk = pr + kCkpt * kDh;     // [kCkpt][kDh]
  float* pw = pk + kCkpt * kDh;     // [kCkpt][kDh]
  float* pv = pw + kCkpt * kDh;     // [kCkpt][kWarps][kCols]
  float* us = pv + kCkpt * kWarps * kCols;  // [kDh]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = tid / kLanes;
  const int grp = tid % kLanes;
  const int slice = blockIdx.x % kSlices;
  const int bh = blockIdx.x / kSlices;
  const int b = bh / heads;
  const int h = bh % heads;
  const int c0 = slice * kCols;         // the block's first value column
  const int cx = grp * kPer;            // the thread's, within the slice
  // element (t, d) of [B, T, H, dh] is at base + t * row_stride + d
  const size_t row_stride = static_cast<size_t>(heads) * kDh;
  const size_t base = (static_cast<size_t>(b) * t_len * heads + h) * kDh;
  const size_t sbase =
      (static_cast<size_t>(bh) * kDh + row) * kDh + c0 + cx;
  float4* ck = reinterpret_cast<float4*>(ckpt) +
               static_cast<size_t>(blockIdx.x) * n_chunks * kThreads + tid;

  for (int d = tid; d < kDh; d += kThreads) us[d] = u[h * kDh + d];

  // a chunk's rows into shared memory; rows past T are r = k = v = do =
  // 0 and w = 1
  auto load = [&](int c, bool backward) {
    const int t0 = c * kCkpt;
    for (int i = tid; i < kCkpt * kDh; i += kThreads) {
      const int j = i / kDh, d = i % kDh;
      const bool live = t0 + j < t_len;
      const size_t at = base + static_cast<size_t>(t0 + j) * row_stride + d;
      ks[i] = live ? to_f32(k[at]) : 0.f;
      ws[i] = live ? expf(logw[at]) : 1.f;
      if (backward) rs[i] = live ? to_f32(r[at]) : 0.f;
    }
    for (int i = tid; i < kCkpt * kCols; i += kThreads) {
      const int j = i / kCols, cc = i % kCols;
      const bool live = t0 + j < t_len;
      const size_t at =
          base + static_cast<size_t>(t0 + j) * row_stride + c0 + cc;
      vs[i] = live ? to_f32(v[at]) : 0.f;
      if (backward) ds[i] = live ? to_f32(dout[at]) : 0.f;
    }
  };

  float S[kPer], G[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    S[e] = state_in ? state_in[sbase + e] : 0.f;

  // (1) forward: the state entering each chunk into the checkpoints
  for (int c = 0; c < n_chunks; ++c) {
    ck[static_cast<size_t>(c) * kThreads] = make_float4(S[0], S[1], S[2],
                                                        S[3]);
    __syncthreads();  // the last chunk's rows are read
    load(c, false);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCkpt; ++j) {
      const float kk = ks[j * kDh + row];
      const float wk = ws[j * kDh + row];
      const float4 v4 = *reinterpret_cast<const float4*>(vs + j * kCols + cx);
      const float vv[kPer] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < kPer; ++e) S[e] = fmaf(wk, S[e], kk * vv[e]);
    }
  }

  // (2) backward, chunk by chunk from the last
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    G[e] = dstate ? dstate[sbase + e] : 0.f;
  float du_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    __syncthreads();  // the last chunk's rows and partials are read
    load(c, true);
    const float4 s4 = ck[static_cast<size_t>(c) * kThreads];
    __syncthreads();
    // the states entering the chunk's steps, recomputed
    float hist[kCkpt][kPer];
    S[0] = s4.x;
    S[1] = s4.y;
    S[2] = s4.z;
    S[3] = s4.w;
#pragma unroll
    for (int j = 0; j < kCkpt; ++j) {
      const float kk = ks[j * kDh + row];
      const float wk = ws[j * kDh + row];
      const float4 v4 = *reinterpret_cast<const float4*>(vs + j * kCols + cx);
      const float vv[kPer] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        hist[j][e] = S[e];
        S[e] = fmaf(wk, S[e], kk * vv[e]);
      }
    }
#pragma unroll
    for (int j = kCkpt - 1; j >= 0; --j) {
      const float rr = rs[j * kDh + row];
      const float kk = ks[j * kDh + row];
      const float wk = ws[j * kDh + row];
      const float uu = us[row];
      const float4 v4 = *reinterpret_cast<const float4*>(vs + j * kCols + cx);
      const float4 d4 = *reinterpret_cast<const float4*>(ds + j * kCols + cx);
      const float vv[kPer] = {v4.x, v4.y, v4.z, v4.w};
      const float dd[kPer] = {d4.x, d4.y, d4.z, d4.w};
      const float ru = rr * uu;
      const float uk = uu * kk;
      float dr = 0.f, dk = 0.f, dw = 0.f, vdo = 0.f;
      float dv[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        // the adjoint of k_t^T v_t's element: G and the bonus's r u do
        const float a = fmaf(ru, dd[e], G[e]);
        dr = fmaf(dd[e], fmaf(uk, vv[e], hist[j][e]), dr);
        dk = fmaf(vv[e], a, dk);
        dw = fmaf(G[e], hist[j][e], dw);
        dv[e] = kk * a;
        vdo = fmaf(vv[e], dd[e], vdo);
        G[e] = fmaf(wk, G[e], rr * dd[e]);
      }
      du_acc = fmaf(rr * kk, vdo, du_acc);
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) {
        dr += __shfl_xor_sync(0xffffffffu, dr, o);
        dk += __shfl_xor_sync(0xffffffffu, dk, o);
        dw += __shfl_xor_sync(0xffffffffu, dw, o);
      }
      if (grp == 0) {
        pr[j * kDh + row] = dr;
        pk[j * kDh + row] = dk;
        pw[j * kDh + row] = dw;
      }
#pragma unroll
      for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          dv[e] += __shfl_xor_sync(0xffffffffu, dv[e], o);
      }
      if (lane < kLanes)
        *reinterpret_cast<float4*>(pv + (j * kWarps + warp) * kCols + cx) =
            make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
    __syncthreads();
    const int t0 = c * kCkpt;
    for (int i = tid; i < kCkpt * kDh; i += kThreads) {
      const int j = i / kDh, d = i % kDh;
      if (t0 + j >= t_len) continue;
      const size_t at = base + static_cast<size_t>(t0 + j) * row_stride + d;
      part[(0 * kSlices + slice) * n_rows + at] = pr[i];
      part[(1 * kSlices + slice) * n_rows + at] = pk[i];
      part[(2 * kSlices + slice) * n_rows + at] = pw[i];
    }
    for (int i = tid; i < kCkpt * kCols; i += kThreads) {
      const int j = i / kCols, cc = i % kCols;
      if (t0 + j >= t_len) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += pv[(j * kWarps + w) * kCols + cc];
      dv_out[base + static_cast<size_t>(t0 + j) * row_stride + c0 + cc] =
          from_f32<T>(sum);
    }
  }
  if (dstate_in) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) dstate_in[sbase + e] = G[e];
  }
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1)
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, o);
  if (grp == 0)
    du_part[static_cast<size_t>(blockIdx.x) * kDh + row] = du_acc;
}

// dr, dk and dlogw: the column slices' partials summed in slice order
template <typename T, int kSlices>
__global__ void __launch_bounds__(256)
reduce_rows_kernel(const float* __restrict__ part,
                   const float* __restrict__ logw, T* __restrict__ dr,
                   T* __restrict__ dk, float* __restrict__ dlogw,
                   size_t n_rows) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_rows; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float a = 0.f, bsum = 0.f, c = 0.f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      a += part[(0 * kSlices + s) * n_rows + i];
      bsum += part[(1 * kSlices + s) * n_rows + i];
      c += part[(2 * kSlices + s) * n_rows + i];
    }
    dr[i] = from_f32<T>(a);
    dk[i] = from_f32<T>(bsum);
    dlogw[i] = expf(logw[i]) * c;
  }
}

// du [H, dh]: the blocks' partials summed over batch rows, then slices
__global__ void __launch_bounds__(256)
reduce_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                 int batch, int heads, int head_dim, int slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= heads * head_dim) return;
  const int h = i / head_dim, d = i % head_dim;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b)
    for (int s = 0; s < slices; ++s)
      acc += du_part[((static_cast<size_t>(b) * heads + h) * slices + s) *
                         head_dim + d];
  du[i] = acc;
}

// ---- bfloat16, T > 1: chunk-parallel on mma.sync --------------------------

// bf16 pieces of the fp32 operands whose products feed dlogw (the
// entering states and adjoints, their increments, the intra-chunk D = do
// v^T tiles and the decay-weighted k and r they meet); dv's take pairs
constexpr int kPieces = 3;

template <int kDh>
struct GradSmem {
  static constexpr int kB = kDh + 8;  // bf16 row pitch (16 bytes of pad)
  static constexpr int kF = kDh + 4;  // fp32 row pitch
  static constexpr int kPairs = kStrips * (kStrips - 1) / 2;
  // exp2 of the strips between each pair i < w, of the strips before w
  // and of the strips after w
  static constexpr int kFactors = kPairs + 2 * kStrips;
  static constexpr int kTri = kSub * (kSub + 1) / 2;  // s <= t in a tile
  // r, k, v, do; w, k weighted, a state (S_c, then G_c); tot; u; the
  // factors; D's and A's diagonal tiles; the strips' totals of r dr' and
  // k dk'; sum_v G S
  static constexpr int kBytes =
      4 * kChunk * kB * 2 + 2 * kChunk * kF * 4 + kDh * kF * 4 +
      kStrips * kDh * 4 +
      kDh * 4 + kFactors * kDh * 4 + 2 * kStrips * kSub * kSub * 4 +
      2 * kStrips * kDh * 4 + kDh * 4;
};

// A fragment of a bf16 [row][col] array: rows r0 + g, r0 + g + 8,
// columns c0 + 2q (+1, +8, +9)
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* m, int pitch,
                                       int r0, int c0, int g, int q) {
  const bf16* p = m + (r0 + g) * pitch + c0 + 2 * q;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch + 8);
}

// B fragment (k = k0 + 2q (+1, +8, +9), n = n0 + g) of a bf16 array held
// [n][k]
__device__ __forceinline__ void frag_b_nk(uint32_t* b, const bf16* m,
                                          int pitch, int n0, int k0, int g,
                                          int q) {
  const bf16* p = m + (n0 + g) * pitch + k0 + 2 * q;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// the same of a bf16 array held [k][n]
__device__ __forceinline__ void frag_b_kn(uint32_t* b, const bf16* m,
                                          int pitch, int n0, int k0, int g,
                                          int q) {
  const int n = n0 + g, k = k0 + 2 * q;
  b[0] = pack_bf16(m[k * pitch + n], m[(k + 1) * pitch + n]);
  b[1] = pack_bf16(m[(k + 8) * pitch + n], m[(k + 9) * pitch + n]);
}

// two 16 x 8 accumulator tiles (columns 0-7, 8-15) as the kP pieces of
// one 16 x 16 A operand
template <int kP>
__device__ __forceinline__ void tiles_as_a(const float (*t)[4],
                                           uint32_t (*a)[4]) {
  uint32_t p[4][kP];
  split_pieces<kP>(t[0][0], t[0][1], p[0]);
  split_pieces<kP>(t[0][2], t[0][3], p[1]);
  split_pieces<kP>(t[1][0], t[1][1], p[2]);
  split_pieces<kP>(t[1][2], t[1][3], p[3]);
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[i][r] = p[r][i];
}

// d += A . B with both sides in kP pieces: the products of pieces i, j
// with i + j < kP (hi.hi + hi.lo + lo.hi for pairs)
template <int kP>
__device__ __forceinline__ void mma_pieces(float* d, const uint32_t (*a)[4],
                                           const uint32_t (*b)[2]) {
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int j = 0; j + i < kP; ++j) mma(d, a[i], b[j]);
}

// exp2(cumx_t - cumx_b) of row t in its strip (b the strip's first row):
// the strip-local sum of the steps before t
__device__ __forceinline__ float strip_before(const float* w, int pitch,
                                              int t, int d) {
  return t % kSub ? w[(t - 1) * pitch + d] : 0.f;
}

// (c) one block a (chunk, b * H + h), warp w the strip of rows s0 = 16 w
// .. s0 + 15, in turn as the rows t of dr and as the rows s of dk and dv.
// With S_c, S_{c+1} the states entering and leaving the chunk, G_c the
// adjoint leaving it, D = do v^T and A the forward's scores:
//   dr'_t = exp2(cumx_t) (S_c do_t) + sum_{s<t} exp2(cumx_t - cum_s) k_s D_ts
//   dk'_s = exp2(total - cum_s) (G_c v_s) + sum_{t>s} exp2(cumx_t - cum_s)
//           r_t D_ts
//   dv_s = G_c^T (exp2(total - cum_s) k_s) + sum_{t>=s} A_ts do_t
//   dlogw_j = sum_{t>j} r_t dr'_t - sum_{s>=j} k_s dk'_s
//             + sum_v (G_c (x) S_{c+1})
// and dr = dr' + u k_t D_tt, dk = dk' + u r_s D_ss.  Between strips the
// exponent factors at the strip boundary, exp2(cumx_t - cumx_b) times
// exp2(cumx_b - cum_s), both 0 or less; on the diagonal tiles each (t, s)
// keeps its exact exponent, on the CUDA cores.
template <int kDh>
__global__ void __launch_bounds__(kThreads)
grads_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ logw, const float* __restrict__ u,
             const float* __restrict__ states,
             const float* __restrict__ final_state,
             const float* __restrict__ adjoints, bf16* __restrict__ dr,
             bf16* __restrict__ dk, bf16* __restrict__ dv,
             float* __restrict__ dlogw, float* __restrict__ du_part,
             float* __restrict__ diag, int t_len, int heads, int has_state,
             int has_dstate) {
  using L = GradSmem<kDh>;
  constexpr int kB = L::kB, kF = L::kF, kN = kDh / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* rs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = rs + kChunk * kB;
  bf16* vs = ks + kChunk * kB;
  bf16* ds = vs + kChunk * kB;
  float* w = reinterpret_cast<float*>(ds + kChunk * kB);  // then cum
  float* kw = w + kChunk * kF;  // k weighted to its strip's end
  float* st = kw + kChunk * kF;  // [kDh][kF]: S_c, then G_c
  float* tot = st + kDh * kF;
  float* us = tot + kStrips * kDh;
  float* fac = us + kDh;
  float* dgs = fac + L::kFactors * kDh;         // [kStrips][kSub][kSub]
  float* ags = dgs + kStrips * kSub * kSub;     // [kStrips][kSub][kSub]
  float* tota = ags + kStrips * kSub * kSub;    // [kStrips][kDh]
  float* totb = tota + kStrips * kDh;           // [kStrips][kDh]
  float* cc = totb + kStrips * kDh;             // [kDh]

  const int c = blockIdx.x, n_chunks = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int t0 = c * kChunk;
  const int live = min(kChunk, t_len - t0);
  const size_t row_stride = static_cast<size_t>(heads) * kDh;
  const size_t base =
      (static_cast<size_t>(b) * t_len + t0) * row_stride + h * kDh;
  constexpr size_t kElems = static_cast<size_t>(kDh) * kDh;
  const size_t slot = static_cast<size_t>(bh) * n_chunks + c;
  // S_c is zero for chunk 0 without a state in, G_c for the last chunk
  // without the final state's gradient
  const bool inter_s = c > 0 || has_state;
  const bool inter_g = c + 1 < n_chunks || has_dstate;
  const float* Sc = states + slot * kElems;
  const float* Sn = c + 1 < n_chunks ? Sc + kElems
                                     : final_state + bh * kElems;
  const float* Gc = adjoints + slot * kElems;

  load_rows(w, kF, logw + base, row_stride, kDh, live);
  cp_async_commit();
  load_rows(rs, kB, r + base, row_stride, kDh, live);
  load_rows(ks, kB, k + base, row_stride, kDh, live);
  load_rows(vs, kB, v + base, row_stride, kDh, live);
  load_rows(ds, kB, dout + base, row_stride, kDh, live);
  if (inter_s) {
    for (int i = threadIdx.x; i < kDh * kDh / 4; i += blockDim.x) {
      const int d = i / (kDh / 4), j = (i % (kDh / 4)) * 4;
      cp_async16(st + d * kF + j, Sc + d * kDh + j, true);
    }
  }
  cp_async_commit();
  for (int d = threadIdx.x; d < kDh; d += blockDim.x) us[d] = u[h * kDh + d];
  // this block's rows of the diagonal tiles' terms of dr' and dk'
  float* diag_r = diag + slot * 2 * kChunk * kDh;
  float* diag_k = diag_r + kChunk * kDh;
  // sum_v G_c (x) S_{c+1}, two threads a row, while the loads fly
  for (int i0 = 0; i0 < kDh; i0 += kThreads / 2) {
    const int i = i0 + threadIdx.x / 2, half = threadIdx.x % 2;
    float s = 0.f;
    if (i < kDh && inter_g) {
      const float4* gr =
          reinterpret_cast<const float4*>(Gc + i * kDh + half * (kDh / 2));
      const float4* sr =
          reinterpret_cast<const float4*>(Sn + i * kDh + half * (kDh / 2));
#pragma unroll 4
      for (int j = 0; j < kDh / 8; ++j) {
        const float4 x = __ldg(gr + j), y = __ldg(sr + j);
        s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (i < kDh && half == 0) cc[i] = s;
  }
  cp_async_wait<1>();
  __syncthreads();
  // the log decays (log2 units) as strip-local inclusive prefix sums,
  // and the strips' totals; one thread a (strip, column)
  for (int p = threadIdx.x; p < kStrips * kDh; p += blockDim.x) {
    const int i = p / kDh, d = p % kDh;
    float run = 0.f;
#pragma unroll
    for (int t = kSub * i; t < kSub * (i + 1); ++t) {
      run += w[t * kF + d] * kLog2e;
      w[t * kF + d] = run;
    }
    tot[i * kDh + d] = run;
  }
  cp_async_wait<0>();
  __syncthreads();

  // shared by the warps: k weighted to its strip's end (the rest of the
  // strip is a difference of two sums over at most 16 steps, as on the
  // diagonal tiles); the factors; A's diagonal tiles (the exact pairwise
  // exponent, the bonus u for s = t), one thread a (t, s <= t) of a strip
  for (int p = threadIdx.x; p < kChunk * kDh; p += blockDim.x) {
    const int t = p / kDh, d = p % kDh;
    kw[t * kF + d] = __bfloat162float(ks[t * kB + d]) *
                     fast_exp2(tot[(t / kSub) * kDh + d] - w[t * kF + d]);
  }
  for (int p = threadIdx.x; p < L::kFactors * kDh; p += blockDim.x) {
    int f = p / kDh, lo, hi;
    if (f < L::kPairs) {  // pair f = w (w - 1) / 2 + i: strips i + 1 .. w - 1
      hi = 1;
      while (f >= hi) f -= hi++;
      lo = f + 1;
    } else if (f < L::kPairs + kStrips) {  // the strips before w
      lo = 0;
      hi = f - L::kPairs;
    } else {  // the strips after w
      lo = f - L::kPairs - kStrips + 1;
      hi = kStrips;
    }
    fac[p] = fast_exp2(span<kDh>(tot, lo, hi, p % kDh));
  }
  for (int p = threadIdx.x; p < kStrips * L::kTri; p += blockDim.x) {
    const int strip = p / L::kTri;
    int sl = p % L::kTri, tl = 0;
    while (sl > tl) sl -= ++tl;
    const int t = kSub * strip + tl, s = kSub * strip + sl;
    float a = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; d += 2) {
      const float2 rt = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(rs + t * kB + d));
      const float2 kv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ks + s * kB + d));
      if (sl < tl) {
        const float2 xt =
            *reinterpret_cast<const float2*>(w + (t - 1) * kF + d);
        const float2 cs = *reinterpret_cast<const float2*>(w + s * kF + d);
        a += rt.x * kv.x * fast_exp2(xt.x - cs.x) +
             rt.y * kv.y * fast_exp2(xt.y - cs.y);
      } else {
        a += rt.x * us[d] * kv.x + rt.y * us[d + 1] * kv.y;
      }
    }
    ags[(kSub * strip + tl) * kSub + sl] = a;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int s0 = kSub * warp;                 // the strip's first row
  const int ta = s0 + g, tb = ta + 8;         // this lane's rows
  float* dg = dgs + warp * kSub * kSub;       // D's diagonal tile [t][s]
  {
    float dt[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, ds, kB, s0, 16 * kk, g, q);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t bb[2];
        frag_b_nk(bb, vs, kB, s0 + 8 * half, 16 * kk, g, q);
        mma(dt[half], a, bb);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dg[(g + 8 * (e >> 1)) * kSub + 8 * half + 2 * q + (e & 1)] =
            dt[half][e];
  }
  __syncthreads();  // kw, the factors, the diagonal tiles
  // the diagonal tiles' exact terms of dr' and dk', one thread a (strip,
  // column) over the strip's pairs s < t, each pair's exponent taken
  // once for both: dr'_t += D_ts k_s exp2(cumx_t - cum_s), dk'_s +=
  // D_ts r_t exp2(cumx_t - cum_s); into this block's scratch rows
  for (int p = threadIdx.x; p < kStrips * kDh; p += blockDim.x) {
    const int strip = p / kDh, i = p % kDh, r0 = kSub * strip;
    const float* dgt = dgs + strip * kSub * kSub;
    float cr[kSub], ck[kSub], kv[kSub], rv[kSub], cw[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      cr[t] = 0.f;
      ck[t] = 0.f;
      kv[t] = __bfloat162float(ks[(r0 + t) * kB + i]);
      rv[t] = __bfloat162float(rs[(r0 + t) * kB + i]);
      cw[t] = w[(r0 + t) * kF + i];
    }
#pragma unroll
    for (int t = 1; t < kSub; ++t)
#pragma unroll
      for (int s = 0; s < t; ++s) {
        const float e = dgt[t * kSub + s] * fast_exp2(cw[t - 1] - cw[s]);
        cr[t] += e * kv[s];
        ck[s] += e * rv[t];
      }
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      diag_r[(r0 + t) * kDh + i] = cr[t];
      diag_k[(r0 + t) * kDh + i] = ck[t];
    }
  }
  __syncthreads();

  // this lane's element e of n-tile n: row (e < 2 ? ta : tb), column
  // 8 n + 2 q + (e & 1)
  float dl[kN][4];  // dlogw, strip-local, until the strips' totals are in

  // ---- dr' and dr (rows t of the strip) ----
  {
    float acc[kN][4] = {};
    if (inter_s) {
      const float* before = fac + (L::kPairs + warp) * kDh;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        uint32_t a[4];
        frag_a(a, ds, kB, s0, 16 * kk, g, q);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const int i = 8 * n + g, v0 = 16 * kk + 2 * q;
          const float f = before[i];
          const float* row = st + i * kF + v0;
          const float2 x0 = *reinterpret_cast<const float2*>(row);
          const float2 x1 = *reinterpret_cast<const float2*>(row + 8);
          uint32_t p0[kPieces], p1[kPieces];
          split_pieces<kPieces>(x0.x * f, x0.y * f, p0);
          split_pieces<kPieces>(x1.x * f, x1.y * f, p1);
#pragma unroll
          for (int j = 0; j < kPieces; ++j) {
            const uint32_t bb[2] = {p0[j], p1[j]};
            mma(acc[n], a, bb);
          }
        }
      }
    }
    for (int j = 0; j < warp; ++j) {  // the strips before
      float dt[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        uint32_t a[4];
        frag_a(a, ds, kB, s0, 16 * kk, g, q);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t bb[2];
          frag_b_nk(bb, vs, kB, kSub * j + 8 * half, 16 * kk, g, q);
          mma(dt[half], a, bb);
        }
      }
      uint32_t ap[kPieces][4];
      tiles_as_a<kPieces>(dt, ap);
      const float* pf = fac + (warp * (warp - 1) / 2 + j) * kDh;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int i = 8 * n + g, s = kSub * j + 2 * q;
        const float f = pf[i];
        uint32_t p0[kPieces], p1[kPieces], bp[kPieces][2];
        split_pieces<kPieces>(kw[s * kF + i] * f, kw[(s + 1) * kF + i] * f,
                              p0);
        split_pieces<kPieces>(kw[(s + 8) * kF + i] * f,
                              kw[(s + 9) * kF + i] * f, p1);
#pragma unroll
        for (int x = 0; x < kPieces; ++x) {
          bp[x][0] = p0[x];
          bp[x][1] = p1[x];
        }
        mma_pieces<kPieces>(acc[n], ap, bp);
      }
    }
    // the row factor, then the diagonal tile's exact terms
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = e < 2 ? ta : tb;
        const int i = 8 * n + 2 * q + (e & 1);
        acc[n][e] = acc[n][e] * fast_exp2(strip_before(w, kF, t, i)) +
                    diag_r[t * kDh + i];
      }
    // r_t dr'_t summed over the strip's later rows (exact order: a suffix
    // scan over the lanes' rows g, the rows g + 8 after all of g), the
    // strip's total; then dr
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int i = 8 * n + 2 * q + e1;
        float lo = __bfloat162float(rs[ta * kB + i]) * acc[n][e1];
        float hi = __bfloat162float(rs[tb * kB + i]) * acc[n][2 + e1];
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          const float ylo = __shfl_down_sync(0xffffffffu, lo, 4 * off);
          const float yhi = __shfl_down_sync(0xffffffffu, hi, 4 * off);
          if (g + off < 8) {
            lo += ylo;
            hi += yhi;
          }
        }
        const float all_hi = __shfl_sync(0xffffffffu, hi, q);
        lo += all_hi;  // rows ta .. s0 + 15
        const float nlo = __shfl_down_sync(0xffffffffu, lo, 4);
        const float nhi = __shfl_down_sync(0xffffffffu, hi, 4);
        dl[n][e1] = g < 7 ? nlo : all_hi;
        dl[n][2 + e1] = g < 7 ? nhi : 0.f;
        if (g == 0) tota[warp * kDh + i] = lo;
      }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int i = 8 * n + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? tb : ta, tl = t - s0;
        if (t >= live) continue;
        const float dd = dg[tl * kSub + tl];
        const float x0 = acc[n][2 * half] +
                         us[i] * __bfloat162float(ks[t * kB + i]) * dd;
        const float x1 = acc[n][2 * half + 1] +
                         us[i + 1] * __bfloat162float(ks[t * kB + i + 1]) * dd;
        *reinterpret_cast<__nv_bfloat162*>(
            dr + base + static_cast<size_t>(t) * row_stride + i) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }

  // the adjoint leaving the chunk replaces the state entering it
  __syncthreads();
  if (inter_g) {
    for (int i = threadIdx.x; i < kDh * kDh / 4; i += blockDim.x) {
      const int d = i / (kDh / 4), j = (i % (kDh / 4)) * 4;
      cp_async16(st + d * kF + j, Gc + d * kDh + j, true);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- dk' and dk (rows s of the strip) ----
  {
    float acc[kN][4] = {};
    if (inter_g) {
      const float* after = fac + (L::kPairs + kStrips + warp) * kDh;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        uint32_t a[4];
        frag_a(a, vs, kB, s0, 16 * kk, g, q);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const int i = 8 * n + g, v0 = 16 * kk + 2 * q;
          const float f = after[i];
          const float* row = st + i * kF + v0;
          const float2 x0 = *reinterpret_cast<const float2*>(row);
          const float2 x1 = *reinterpret_cast<const float2*>(row + 8);
          uint32_t p0[kPieces], p1[kPieces];
          split_pieces<kPieces>(x0.x * f, x0.y * f, p0);
          split_pieces<kPieces>(x1.x * f, x1.y * f, p1);
#pragma unroll
          for (int j = 0; j < kPieces; ++j) {
            const uint32_t bb[2] = {p0[j], p1[j]};
            mma(acc[n], a, bb);
          }
        }
      }
    }
    for (int j = warp + 1; j < kStrips; ++j) {  // the strips after
      float dt[2][4] = {};  // D^T: rows s of this strip, columns t of j
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        uint32_t a[4];
        frag_a(a, vs, kB, s0, 16 * kk, g, q);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t bb[2];
          frag_b_nk(bb, ds, kB, kSub * j + 8 * half, 16 * kk, g, q);
          mma(dt[half], a, bb);
        }
      }
      uint32_t ap[kPieces][4];
      tiles_as_a<kPieces>(dt, ap);
      const float* pf = fac + (j * (j - 1) / 2 + warp) * kDh;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int i = 8 * n + g;
        const float f = pf[i];
        float x[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {  // rows t = 16 j + 2q (+1, +8, +9)
          const int t = kSub * j + 2 * q + (p & 1) + 8 * (p >> 1);
          x[p] = __bfloat162float(rs[t * kB + i]) *
                 fast_exp2(strip_before(w, kF, t, i)) * f;
        }
        uint32_t p0[kPieces], p1[kPieces], bp[kPieces][2];
        split_pieces<kPieces>(x[0], x[1], p0);
        split_pieces<kPieces>(x[2], x[3], p1);
#pragma unroll
        for (int y = 0; y < kPieces; ++y) {
          bp[y][0] = p0[y];
          bp[y][1] = p1[y];
        }
        mma_pieces<kPieces>(acc[n], ap, bp);
      }
    }
    // the row factor (the rest of s's strip), then the diagonal tile's
    // exact terms
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = e < 2 ? ta : tb;
        const int i = 8 * n + 2 * q + (e & 1);
        acc[n][e] =
            acc[n][e] * fast_exp2(tot[warp * kDh + i] - w[s * kF + i]) +
            diag_k[s * kDh + i];
      }
    // k_s dk'_s summed over the strip's rows from s on; the strip's total;
    // then dk
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int i = 8 * n + 2 * q + e1;
        float lo = __bfloat162float(ks[ta * kB + i]) * acc[n][e1];
        float hi = __bfloat162float(ks[tb * kB + i]) * acc[n][2 + e1];
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          const float ylo = __shfl_down_sync(0xffffffffu, lo, 4 * off);
          const float yhi = __shfl_down_sync(0xffffffffu, hi, 4 * off);
          if (g + off < 8) {
            lo += ylo;
            hi += yhi;
          }
        }
        lo += __shfl_sync(0xffffffffu, hi, q);
        dl[n][e1] -= lo;
        dl[n][2 + e1] -= hi;
        if (g == 0) totb[warp * kDh + i] = lo;
      }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int i = 8 * n + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = half ? tb : ta, sl = s - s0;
        if (s >= live) continue;
        const float dd = dg[sl * kSub + sl];
        const float x0 = acc[n][2 * half] +
                         us[i] * __bfloat162float(rs[s * kB + i]) * dd;
        const float x1 = acc[n][2 * half + 1] +
                         us[i + 1] * __bfloat162float(rs[s * kB + i + 1]) * dd;
        *reinterpret_cast<__nv_bfloat162*>(
            dk + base + static_cast<size_t>(s) * row_stride + i) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }

  // ---- dv (rows s of the strip, columns v) ----
  {
    float acc[kN][4] = {};
    // K^ of this strip's rows: k weighted to its strip's end, A operand
    // pairs over the i steps
    auto kw_frag = [&](int kk, const float* scale, uint32_t (*ap)[4]) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int s = p & 1 ? tb : ta;
        const int i = 16 * kk + 2 * q + 8 * (p >> 1);
        const float a0 = scale ? scale[i] : 1.f;
        const float a1 = scale ? scale[i + 1] : 1.f;
        uint32_t pc[2];
        split_pieces<2>(kw[s * kF + i] * a0, kw[s * kF + i + 1] * a1, pc);
        ap[0][p] = pc[0];
        ap[1][p] = pc[1];
      }
    };
    if (inter_g) {
      const float* after = fac + (L::kPairs + kStrips + warp) * kDh;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        uint32_t ap[2][4];
        kw_frag(kk, after, ap);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const int vv = 8 * n + g, i = 16 * kk + 2 * q;
          uint32_t p0[2], p1[2], bp[2][2];
          split_pieces<2>(st[i * kF + vv], st[(i + 1) * kF + vv], p0);
          split_pieces<2>(st[(i + 8) * kF + vv], st[(i + 9) * kF + vv], p1);
          bp[0][0] = p0[0];
          bp[0][1] = p1[0];
          bp[1][0] = p0[1];
          bp[1][1] = p1[1];
          mma_pieces<2>(acc[n], ap, bp);
        }
      }
    }
    for (int j = warp + 1; j < kStrips; ++j) {  // the strips after
      const float* pf = fac + (j * (j - 1) / 2 + warp) * kDh;
      float at[2][4] = {};  // A^T: rows s of this strip, columns t of j
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        uint32_t ap[2][4];
        kw_frag(kk, nullptr, ap);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = kSub * j + 8 * half + g;
          float x[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {  // i = 16 kk + 2q (+1, +8, +9)
            const int i = 16 * kk + 2 * q + (p & 1) + 8 * (p >> 1);
            x[p] = __bfloat162float(rs[t * kB + i]) *
                   fast_exp2(strip_before(w, kF, t, i)) * pf[i];
          }
          uint32_t p0[2], p1[2], bp[2][2];
          split_pieces<2>(x[0], x[1], p0);
          split_pieces<2>(x[2], x[3], p1);
          bp[0][0] = p0[0];
          bp[0][1] = p1[0];
          bp[1][0] = p0[1];
          bp[1][1] = p1[1];
          mma_pieces<2>(at[half], ap, bp);
        }
      }
      uint32_t ap[2][4];
      tiles_as_a<2>(at, ap);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        uint32_t bb[2];
        frag_b_kn(bb, ds, kB, 8 * n, kSub * j, g, q);
        mma(acc[n], ap[0], bb);
        mma(acc[n], ap[1], bb);
      }
    }
    {  // A's diagonal tile, transposed: rows s, columns t >= s
      const float* ag = ags + warp * kSub * kSub;
      float tt[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sl = g + 8 * (e >> 1), tl = 8 * half + 2 * q + (e & 1);
          tt[half][e] = tl >= sl ? ag[tl * kSub + sl] : 0.f;
        }
      uint32_t ap[2][4];
      tiles_as_a<2>(tt, ap);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        uint32_t bb[2];
        frag_b_kn(bb, ds, kB, 8 * n, s0, g, q);
        mma(acc[n], ap[0], bb);
        mma(acc[n], ap[1], bb);
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int j = 8 * n + 2 * q;
      if (ta < live)
        *reinterpret_cast<__nv_bfloat162*>(
            dv + base + static_cast<size_t>(ta) * row_stride + j) =
            __floats2bfloat162_rn(acc[n][0], acc[n][1]);
      if (tb < live)
        *reinterpret_cast<__nv_bfloat162*>(
            dv + base + static_cast<size_t>(tb) * row_stride + j) =
            __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
  }

  __syncthreads();  // every strip's totals of r dr' and k dk'
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int i = 8 * n + 2 * q;
    float later[2] = {0.f, 0.f};
    for (int j = warp + 1; j < kStrips; ++j) {
      later[0] += tota[j * kDh + i] - totb[j * kDh + i];
      later[1] += tota[j * kDh + i + 1] - totb[j * kDh + i + 1];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = half ? tb : ta;
      if (t >= live) continue;
      *reinterpret_cast<float2*>(
          dlogw + base + static_cast<size_t>(t) * row_stride + i) =
          make_float2(dl[n][2 * half] + later[0] + cc[i],
                      dl[n][2 * half + 1] + later[1] + cc[i + 1]);
    }
  }
  // du's partial over the chunk: r_t k_t D_tt summed over t in order
  for (int d = threadIdx.x; d < kDh; d += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < kChunk; ++t)
      s += __bfloat162float(rs[t * kB + d]) *
           __bfloat162float(ks[t * kB + d]) *
           dgs[(t / kSub) * kSub * kSub + (t % kSub) * (kSub + 1)];
    du_part[slot * kDh + d] = s;
  }
}

// (a') one block a (chunk, b * H + h): the chunk's increment of the
// adjoint, dG = R~^T dO with R~ = r exp2(cumx) (the steps before each
// row), by the prefill's increment_rows in kPieces pieces.
template <int kDh>
__global__ void __launch_bounds__(kThreads)
adjoint_increments_kernel(const bf16* __restrict__ r,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ logw,
                          float* __restrict__ inc, int t_len, int heads) {
  using L = Smem<kDh>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* rs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ds = rs + kChunk * L::kB;
  float* w = reinterpret_cast<float*>(ds + kChunk * L::kB);
  float* ex = w + kChunk * L::kF;
  float* tot = ex + kChunk * L::kF;

  const int c = blockIdx.x, n_chunks = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int t0 = c * kChunk;
  const int live = min(kChunk, t_len - t0);
  const size_t row_stride = static_cast<size_t>(heads) * kDh;
  const size_t base =
      (static_cast<size_t>(b) * t_len + t0) * row_stride + h * kDh;

  load_rows(w, L::kF, logw + base, row_stride, kDh, live);
  cp_async_commit();
  load_rows(rs, L::kB, r + base, row_stride, kDh, live);
  load_rows(ds, L::kB, dout + base, row_stride, kDh, live);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  strip_sums<kDh>(w, ex, tot, L::kF);
  __syncthreads();
  // ex becomes cumx_t: the strip's steps before the row, after the
  // strips before it
  for (int p = threadIdx.x; p < kChunk * kDh; p += blockDim.x) {
    const int t = p / kDh, d = p % kDh;
    ex[t * L::kF + d] = (t % kSub ? w[(t - 1) * L::kF + d] : 0.f) +
                        span<kDh>(tot, 0, t / kSub, d);
  }
  cp_async_wait<0>();
  __syncthreads();
  const size_t slot = static_cast<size_t>(bh) * n_chunks + c;
  increment_rows<kDh, kPieces>(rs, ds, ex, inc + slot * kDh * kDh);
}

// (b') the prefill's walk over the chunks, backwards: G_{c-1} =
// exp2(total_c) G_c + dG_c from G_{NC-1} = dstate, leaving each chunk's
// G_c in `inc` and the input state's gradient in dstate_in
template <int kDh>
__global__ void __launch_bounds__(kPassThreads)
adjoint_pass_kernel(const float* dstate, float* dstate_in, float* inc,
                    const float* __restrict__ decays, int n_chunks) {
  pass_walk<kDh, true>(dstate, dstate_in, inc, decays, n_chunks);
}

template <int kDh>
int launch_chunked(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* state_in,
                   const void* dout, const float* dstate, void* dr, void* dk,
                   void* dv, float* dlogw, float* du, float* dstate_in,
                   float* scratch, const float* saved, const float* final_in,
                   int batch, int t_len, int heads, cudaStream_t stream) {
  using L = Smem<kDh>;
  const int nc = static_cast<int>(n_chunks_of(t_len));
  const int bhs = batch * heads;
  if (bhs > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  const size_t elems = static_cast<size_t>(kDh) * kDh;
  // the prefill's scratch layout: the states entering each chunk
  // [bhs][nc][dh][dh], then the chunks' decays [bhs][nc][dh]
  float* states = scratch;
  float* decays = states + static_cast<size_t>(bhs) * nc * elems;
  float* final_state = decays + static_cast<size_t>(bhs) * nc * kDh;
  float* adjoints = final_state + static_cast<size_t>(bhs) * elems;
  float* du_part = adjoints + static_cast<size_t>(bhs) * nc * elems;
  float* diag = du_part + static_cast<size_t>(bhs) * nc * kDh;
  cudaError_t err = allow_smem(increments_kernel<kDh>, L::kIncBytes);
  if (err == cudaSuccess)
    err = allow_smem(adjoint_increments_kernel<kDh>, L::kIncBytes);
  if (err == cudaSuccess)
    err = allow_smem(grads_kernel<kDh>, GradSmem<kDh>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* rb = static_cast<const bf16*>(r);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* db = static_cast<const bf16*>(dout);
  const dim3 pass_grid(kDh * kDh / 4 / kPassThreads, bhs);
  const float* st = saved;
  const float* dec =
      saved ? saved + static_cast<size_t>(bhs) * nc * elems : nullptr;
  const float* fin = final_in;
  if (!saved) {
    // the states entering each chunk and the final state: the prefill's
    // phases (a) and (b), bit for bit what its scratch holds
    increments_kernel<kDh><<<dim3(nc, bhs), kThreads, L::kIncBytes,
                             stream>>>(kb, vb, logw, states, decays, t_len,
                                       heads);
    pass_kernel<kDh><<<pass_grid, kPassThreads, 0, stream>>>(
        state_in, final_state, states, decays, nc);
    st = states;
    dec = decays;
    fin = final_state;
  }
  // the adjoints leaving each chunk and the input state's gradient
  adjoint_increments_kernel<kDh>
      <<<dim3(nc, bhs), kThreads, L::kIncBytes, stream>>>(
          rb, db, logw, adjoints, t_len, heads);
  adjoint_pass_kernel<kDh><<<pass_grid, kPassThreads, 0, stream>>>(
      dstate, dstate_in, adjoints, dec, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grads_kernel<kDh><<<dim3(nc, bhs), kThreads, GradSmem<kDh>::kBytes,
                      stream>>>(
      rb, kb, vb, db, logw, u, st, fin, adjoints,
      static_cast<bf16*>(dr), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      dlogw, du_part, diag, t_len, heads, state_in != nullptr,
      dstate != nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_du_kernel<<<(heads * kDh + 255) / 256, 256, 0, stream>>>(
      du_part, du, batch, heads, kDh, nc);
  return static_cast<int>(cudaGetLastError());
}

int n_ckpts_of(int t_len) { return (t_len + kCkpt - 1) / kCkpt; }

template <typename T, int kDh>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* state_in, const void* dout,
           const float* dstate, void* dr, void* dk, void* dv, float* dlogw,
           float* du, float* dstate_in, float* scratch, const float* saved,
           const float* final_in, int batch, int t_len, int heads,
           cudaStream_t stream) {
  using L = Shape<kDh>;
  if constexpr (sizeof(T) == 2) {
    if (t_len > 1)
      return launch_chunked<kDh>(r, k, v, logw, u, state_in, dout, dstate,
                                 dr, dk, dv, dlogw, du, dstate_in, scratch,
                                 saved, final_in, batch, t_len, heads,
                                 stream);
  }
  const int n_chunks = n_ckpts_of(t_len);
  const size_t blocks = static_cast<size_t>(batch) * heads * L::kSlices;
  const size_t n_rows = static_cast<size_t>(batch) * t_len * heads * kDh;
  float* ckpt = scratch;
  float* part = ckpt + blocks * n_chunks * L::kThreads * 4;
  float* du_part = part + 3 * L::kSlices * n_rows;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<T, kDh><<<static_cast<unsigned>(blocks), L::kThreads,
                            L::kBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, state_in,
      static_cast<const T*>(dout), dstate, static_cast<T*>(dv), dstate_in,
      ckpt, part, du_part, t_len, heads, n_chunks, n_rows);
  const size_t grid = (n_rows + 255) / 256;
  reduce_rows_kernel<T, L::kSlices>
      <<<static_cast<unsigned>(grid < 65536 * 8 ? grid : 65536 * 8), 256, 0,
         stream>>>(part, logw, static_cast<T*>(dr), static_cast<T*>(dk),
                   dlogw, n_rows);
  reduce_du_kernel<<<(heads * kDh + 255) / 256, 256, 0, stream>>>(
      du_part, du, batch, heads, kDh, L::kSlices);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* state_in, const void* dout,
             const float* dstate, void* dr, void* dk, void* dv, float* dlogw,
             float* du, float* dstate_in, float* scratch, const float* saved,
             const float* final_in, int batch, int t_len, int heads,
             int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(r, k, v, logw, u, state_in, dout, dstate, dr, dk,
                           dv, dlogw, du, dstate_in, scratch, saved, final_in,
                           batch, t_len, heads, stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, state_in, dout, dstate, dr, dk,
                           dv, dlogw, du, dstate_in, scratch, saved, final_in,
                           batch, t_len, heads, stream);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, state_in, dout, dstate, dr, dk,
                            dv, dlogw, du, dstate_in, scratch, saved, final_in,
                            batch, t_len, heads, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Scratch floats wkv6_bwd needs (0 for an empty call).  A bfloat16 call
// with t_len > 1 (dtype 1): the states entering each chunk of 64 steps
// and the adjoints leaving it, [batch, heads, NC, head_dim, head_dim]
// each, the final state, the chunks' decays and du's per-chunk partials,
// [batch, heads, NC, head_dim] each.  Otherwise: the checkpoints, the
// column slices' partials of dr, dk and dlogw, and du's per-block
// partials.
extern "C" long long wkv6_bwd_scratch_floats(int batch, int t_len, int heads,
                                             int head_dim, int dtype) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || head_dim % kCols) return 0;
  const long long bh = static_cast<long long>(batch) * heads;
  const long long dh2 = static_cast<long long>(head_dim) * head_dim;
  if (dtype == 1 && t_len > 1) {
    const long long nc = static_cast<long long>(n_chunks_of(t_len));
    return bh * (2 * nc * dh2 + dh2 + 2 * nc * head_dim +
                 2 * nc * kChunk * head_dim);
  }
  const long long slices = head_dim / kCols;
  return bh * n_ckpts_of(t_len) * dh2 +
         3 * slices * bh * t_len * head_dim + bh * slices * head_dim;
}

// C interface, loaded with ctypes.  r, k, v, dout, dr, dk, dv: [batch,
// t_len, heads, head_dim] of one dtype (0 float32, 1 bfloat16); logw and
// dlogw: the same shape in float32; u, du: [heads, head_dim] float32;
// state_in (or null for a zero state), dstate (the final state's
// gradient, or null for zeros) and dstate_in (the input state's
// gradient, or null to skip it): [batch, heads, head_dim, head_dim]
// float32, k index before v index; scratch: at least
// wkv6_bwd_scratch_floats(...) floats, 16-byte aligned; all contiguous.
// For a bfloat16 call with t_len > 1, r, k, v, dout and logw 16-byte
// aligned (cp.async), and `saved` either null or the scratch of the wkv6
// call on the same inputs (the states entering each chunk, then the
// chunks' decays, as wkv6_scratch_floats lays them out) with `final_in`
// that call's final state: the backward then takes the states from them
// instead of recomputing them; both are ignored otherwise.  batch, t_len
// and heads must be at least 1.  Launches on `stream` (four kernels for
// a bfloat16 call with t_len > 1 and `saved`, six without, three
// otherwise), does not synchronise, and returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for a head dim other than 32, 64
// or 128, another dtype, or a bfloat16 call with t_len > 1 of more than
// 65,535 (batch, head) rows).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* logw, const void* u,
                        const void* state_in, const void* dout,
                        const void* dstate, void* dr, void* dk, void* dv,
                        void* dlogw, void* du, void* dstate_in,
                        void* scratch, const void* saved,
                        const void* final_in, int batch, int t_len, int heads,
                        int head_dim, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(logw);
  const auto* up = static_cast<const float*>(u);
  const auto* si = static_cast<const float*>(state_in);
  const auto* dsf = static_cast<const float*>(dstate);
  auto* dw = static_cast<float*>(dlogw);
  auto* dup = static_cast<float*>(du);
  auto* dsi = static_cast<float*>(dstate_in);
  auto* sc = static_cast<float*>(scratch);
  const auto* sv = static_cast<const float*>(saved);
  const auto* fi = static_cast<const float*>(final_in);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, up, si, dout, dsf, dr, dk, dv, dw,
                           dup, dsi, sc, sv, fi, batch, t_len, heads,
                           head_dim, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, up, si, dout, dsf, dr, dk, dv,
                                   dw, dup, dsi, sc, sv, fi, batch, t_len,
                                   heads, head_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
