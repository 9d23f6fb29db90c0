// The gradient of the Mamba-2 SSD scan (csrc/ssd.cu), with the state
// carried in and the final state's gradient taken in.
//
// Replaces no TPU kernel: the JAX package trains the hybrid through
// XLA's autodiff of its jnp chunked form (src/repro/models/mamba.py
// _ssd_chunked, under jax.value_and_grad in src/repro/launch/steps.py),
// and its Pallas ssd runs only in serving.  This is the backward of the
// port's ssd kernel, so that a training step differentiates through the
// kernels (kernels/mamba_scan/ops.py ssd_heads).
//
// What it computes, per (b, h), with a_t = exp(dt_t A), h_{t-1} the
// [dh, N] state entering step t and G the adjoint of h_t:
//   G_t = a_{t+1} G_{t+1} + dy_t^T C_t  (the final state's gradient
//         entering at t = T - 1)
//   dx_t = dt_t G_t B_t;   dC_t = sum_h h_t^T dy_t;
//   dB_t = dt_t sum_h G_t^T x_t
//   ddt_t = sum (G_t (x) x_t B_t^T) + A a_t sum (G_t (x) h_{t-1})
//   dA = sum_{b, t} dt_t a_t sum (G_t (x) h_{t-1})
// and the input state's gradient is a_0 G_0, all in fp32; dx, dB_ and
// dC_ stored in x's dtype, ddt, dA and the state's gradient in fp32.
// B_ and C_ are shared by every head, so their gradients sum over the
// heads: 256 of them at Jamba-1.5-Large's full width.
//
// What bounds it on an H100.  At Jamba's full-width mixer shape (B = 1,
// T = 4096, H = 256, dh = 64, N = 16, bf16) the function reads x, dy
// (bf16), dt (fp32), B_, C_ (bf16) and A, and writes dx (bf16), ddt,
// dB_, dC_ and dA: 412 MB, 0.123 ms at 3.35 TB/s.  The chunked form's
// products, each counted once (chip_smoke.py's ssd_bwd_flops), are 21.5
// GFLOP: 0.022 ms at the bf16 tensor-core rate, so the bytes bound it.
//
// The design, picked from t_len and the dtype inside the C entry point:
//
// bfloat16, T > 1: chunk-parallel, the prefill's design (csrc/ssd.cu)
// run backwards over its chunks of kChunk = 64 steps, strips of kSub =
// 16 and groups of kHeads = 8 heads (csrc/ssd_chunk.cuh holds what the
// two share).  With l_t = dt_t A, cum the in-chunk inclusive prefix sum
// of l and total its last value, S_c the state entering chunk c and G_c
// the adjoint leaving it:
//  (a), (b) the states entering each chunk: the prefill's scratch when
//      the caller saved it (the autograd op does), else the prefill's
//      increments_kernel and pass_kernel run again, bit for bit what its
//      scratch holds;
//  (a'), (b') adjoint_increments_kernel, one block a (b, chunk, 4
//      heads), all at once: the adjoint's increment dy^T (C_ exp(cum))
//      by the prefill's increment_head; adjoint_pass_kernel, the
//      prefill's walk backwards, G_{c-1} = exp(total_c) G_c + increment,
//      which leaves each chunk's G_c in the scratch and the input state's
//      gradient;
//  (c) grads_kernel, one block a (b, chunk, 8 heads), all at once (its
//      comment has the chunk's formulas): C B^T formed once and shared
//      by the heads, each head's x, dy and states loaded by cp.async into
//      one of two buffers while the head before computes; dx and ddt
//      once, dB_ and dC_ summed over the group's heads in order, dA's
//      per-chunk partials; then reduce_heads_kernel sums the groups'
//      dB_, dC_ in group order and reduce_da_chunks_kernel dA's partials
//      over batch rows and chunks in order.
//  ddt and dA come through the decay's gradient dl, from the chunk-local
//  identity dl_j = sum_{t>=j} dy_t . y_t - sum_{s>=j} x~_s . dx~_s +
//  sum (G_c (x) S_{c+1}) (x~ = dt x), taken in the form where the pairs
//  (t, s) that appear in both sums are taken out (grads_kernel): held to
//  2e-5 of its largest value with decays down to dt A = -12, where the
//  cancelling form is not.  The operands of dx~ and dC_ (the states,
//  their increments, the (C B^T) * L and (dy x^T) * dt * L tiles) go in
//  as three bf16 pieces, hi + mid + lo, those of dB_ as pairs
//  (tests/test_torch_scan_bwd_design.py).  Every exponent is a
//  non-positive sum of log decays from strip-local sums, as in the
//  prefill.  Scratch: 151 MB at Jamba's shape (the serial form below
//  took 402 MB).
//
// float32, and T = 1 in either dtype: ssd_bwd_kernel, the serial form,
// so that fp32 callers keep exact fp32 products.  One block a (b, h);
// each thread owns one row d of the state and 4 of its N columns (N = 8
// or 16: 2 or 4 lanes a row), so the block holds h and G in registers
// (dh = 32, 64, 128 at N = 16: 128, 256, 512 threads).
//  (1) Forward walk over chunks of kCkpt = 16 steps: the state entering
//      each chunk goes to a scratch of checkpoints.
//  (2) Reverse walk: each chunk's 16 entering states recomputed from
//      its checkpoint into registers (a state is never recovered from
//      the next one by dividing by a_t), then the chunk's steps
//      backwards with G.  dx's sum over N by shuffles over a row's
//      lanes; dB_'s and dC_'s sums over rows by shuffles over the
//      warp's rows; ddt's and dA's sums over the whole state by
//      shuffles over the warp; then over the warps in order at the
//      chunk's end, where the block writes dx and ddt (whole) and its
//      head's dB_, dC_ partials to scratch, and accumulates dA's.
//  (3) reduce_heads_kernel sums the heads' dB_ and dC_ partials in
//      head order; reduce_da_kernel dA's over batch rows in order.
//  Scratch: the checkpoints, B H ceil(T/16) dh N floats, then 2 B T H N
//  partial floats, then B H dA partials.  Rows past T are x = B_ = C_ =
//  dy = dt = 0 and a = 1: they change neither h nor G and are not
//  written.
//
// No atomics in either form: two calls on the same inputs give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_chunk.cuh"

namespace {

constexpr int kCkpt = 16;   // steps a checkpoint covers
constexpr int kPer = 4;     // state columns a thread owns

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

template <int kDh, int kN>
struct Shape {
  static constexpr int kLanes = kN / kPer;  // threads a state row
  static constexpr int kThreads = kDh * kLanes;
  static constexpr int kWarps = kThreads / 32;
  // shared floats: x, dy rows, B_, C_, dt and a of a chunk, dx of a
  // chunk, the warps' dC_, dB_ partials and their two sums a step
  static constexpr int kFloats = 2 * kCkpt * kDh + 2 * kCkpt * kN +
                                 2 * kCkpt + kCkpt * kDh +
                                 2 * kCkpt * kWarps * kN +
                                 2 * kCkpt * kWarps;
  static constexpr int kBytes = kFloats * 4;
  static_assert(kThreads % 32 == 0 && 32 % kLanes == 0, "whole warps");
};

template <typename T, int kDh, int kN>
__global__ void __launch_bounds__(Shape<kDh, kN>::kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const float* __restrict__ A,
               const float* __restrict__ state_in,
               const T* __restrict__ dy, const float* __restrict__ dstate,
               T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dstate_in, float* __restrict__ ckpt,
               float* __restrict__ part_b, float* __restrict__ part_c,
               float* __restrict__ da_part, int t_len, int heads,
               int n_chunks) {
  using L = Shape<kDh, kN>;
  constexpr int kThreads = L::kThreads;
  constexpr int kWarps = L::kWarps;
  constexpr int kLanes = L::kLanes;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // [kCkpt][kDh]
  float* ys = xs + kCkpt * kDh;      // [kCkpt][kDh], dy
  float* px = ys + kCkpt * kDh;      // [kCkpt][kDh], dx
  float* bs = px + kCkpt * kDh;      // [kCkpt][kN]
  float* cs = bs + kCkpt * kN;       // [kCkpt][kN]
  float* pc = cs + kCkpt * kN;       // [kCkpt][kWarps][kN]
  float* pb = pc + kCkpt * kWarps * kN;  // [kCkpt][kWarps][kN]
  float* ps = pb + kCkpt * kWarps * kN;  // [kCkpt][kWarps][2]
  float* dts = ps + 2 * kCkpt * kWarps;  // [kCkpt]
  float* as = dts + kCkpt;               // [kCkpt], exp(dt A)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = tid / kLanes;
  const int grp = tid % kLanes;
  const int cx = grp * kPer;  // the thread's first state column
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const float a_h = A[h];
  // element (t, d) of [B, T, H, dh] is at xbase + t * x_stride + d;
  // (t, n) of [B, T, N] at nbase + t * kN + n; (t) of [B, T, H] at
  // tbase + t * heads
  const size_t x_stride = static_cast<size_t>(heads) * kDh;
  const size_t xbase = (static_cast<size_t>(b) * t_len * heads + h) * kDh;
  const size_t nbase = static_cast<size_t>(b) * t_len * kN;
  const size_t tbase = static_cast<size_t>(b) * t_len * heads + h;
  const size_t sbase = (static_cast<size_t>(bh) * kDh + row) * kN + cx;
  float4* ck = reinterpret_cast<float4*>(ckpt) +
               static_cast<size_t>(bh) * n_chunks * kThreads + tid;

  // a chunk's rows into shared memory; rows past T are x = B_ = C_ = dy
  // = dt = 0 and a = 1
  auto load = [&](int c, bool backward) {
    const int t0 = c * kCkpt;
    for (int i = tid; i < kCkpt * kDh; i += kThreads) {
      const int j = i / kDh, d = i % kDh;
      const bool live = t0 + j < t_len;
      const size_t at = xbase + static_cast<size_t>(t0 + j) * x_stride + d;
      xs[i] = live ? to_f32(x[at]) : 0.f;
      if (backward) ys[i] = live ? to_f32(dy[at]) : 0.f;
    }
    for (int i = tid; i < kCkpt * kN; i += kThreads) {
      const int j = i / kN, n = i % kN;
      const bool live = t0 + j < t_len;
      const size_t at = nbase + static_cast<size_t>(t0 + j) * kN + n;
      bs[i] = live ? to_f32(bm[at]) : 0.f;
      if (backward) cs[i] = live ? to_f32(cm[at]) : 0.f;
    }
    for (int j = tid; j < kCkpt; j += kThreads) {
      const bool live = t0 + j < t_len;
      const float d = live ? dt[tbase + static_cast<size_t>(t0 + j) * heads]
                           : 0.f;
      dts[j] = d;
      as[j] = expf(d * a_h);
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
      const float dtx = xs[j * kDh + row] * dts[j];
      const float aa = as[j];
      const float4 b4 = *reinterpret_cast<const float4*>(bs + j * kN + cx);
      const float bb[kPer] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int e = 0; e < kPer; ++e) S[e] = fmaf(aa, S[e], dtx * bb[e]);
    }
  }

  // (2) backward, chunk by chunk from the last
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    G[e] = dstate ? dstate[sbase + e] : 0.f;
  float da_acc = 0.f;  // thread 0's
  for (int c = n_chunks - 1; c >= 0; --c) {
    __syncthreads();  // the last chunk's rows and partials are read
    load(c, true);
    const float4 s4 = ck[static_cast<size_t>(c) * kThreads];
    __syncthreads();
    float hist[kCkpt][kPer];
    S[0] = s4.x;
    S[1] = s4.y;
    S[2] = s4.z;
    S[3] = s4.w;
#pragma unroll
    for (int j = 0; j < kCkpt; ++j) {
      const float dtx = xs[j * kDh + row] * dts[j];
      const float aa = as[j];
      const float4 b4 = *reinterpret_cast<const float4*>(bs + j * kN + cx);
      const float bb[kPer] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        hist[j][e] = S[e];
        S[e] = fmaf(aa, S[e], dtx * bb[e]);
      }
    }
#pragma unroll
    for (int j = kCkpt - 1; j >= 0; --j) {
      const float xx = xs[j * kDh + row];
      const float yy = ys[j * kDh + row];
      const float dtx = xx * dts[j];
      const float aa = as[j];
      const float4 b4 = *reinterpret_cast<const float4*>(bs + j * kN + cx);
      const float4 c4 = *reinterpret_cast<const float4*>(cs + j * kN + cx);
      const float bb[kPer] = {b4.x, b4.y, b4.z, b4.w};
      const float cc[kPer] = {c4.x, c4.y, c4.z, c4.w};
      float gb = 0.f, gh = 0.f;
      float dcp[kPer], dbp[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const float ht = fmaf(aa, hist[j][e], dtx * bb[e]);
        G[e] = fmaf(yy, cc[e], G[e]);
        dcp[e] = ht * yy;
        dbp[e] = G[e] * xx;
        gb = fmaf(G[e], bb[e], gb);
        gh = fmaf(G[e], hist[j][e], gh);
        G[e] = aa * G[e];
      }
      float q1 = xx * gb;  // this thread's share of sum G (x) x B^T
      float q2 = gh;
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1)
        gb += __shfl_xor_sync(0xffffffffu, gb, o);
      if (grp == 0) px[j * kDh + row] = dts[j] * gb;
#pragma unroll
      for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          dcp[e] += __shfl_xor_sync(0xffffffffu, dcp[e], o);
          dbp[e] += __shfl_xor_sync(0xffffffffu, dbp[e], o);
        }
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        q1 += __shfl_xor_sync(0xffffffffu, q1, o);
        q2 += __shfl_xor_sync(0xffffffffu, q2, o);
      }
      if (lane < kLanes) {
        const int at = (j * kWarps + warp) * kN + cx;
        *reinterpret_cast<float4*>(pc + at) =
            make_float4(dcp[0], dcp[1], dcp[2], dcp[3]);
        *reinterpret_cast<float4*>(pb + at) =
            make_float4(dbp[0], dbp[1], dbp[2], dbp[3]);
      }
      if (lane == 0) {
        ps[(j * kWarps + warp) * 2] = q1;
        ps[(j * kWarps + warp) * 2 + 1] = q2;
      }
    }
    __syncthreads();
    const int t0 = c * kCkpt;
    for (int i = tid; i < kCkpt * kDh; i += kThreads) {
      const int j = i / kDh, d = i % kDh;
      if (t0 + j >= t_len) continue;
      dx[xbase + static_cast<size_t>(t0 + j) * x_stride + d] =
          from_f32<T>(px[i]);
    }
    for (int i = tid; i < kCkpt * kN; i += kThreads) {
      const int j = i / kN, n = i % kN;
      if (t0 + j >= t_len) continue;
      float sc = 0.f, sb = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sc += pc[(j * kWarps + w) * kN + n];
        sb += pb[(j * kWarps + w) * kN + n];
      }
      const size_t at = (tbase + static_cast<size_t>(t0 + j) * heads) * kN + n;
      part_c[at] = sc;
      part_b[at] = dts[j] * sb;
    }
    for (int j = tid; j < kCkpt; j += kThreads) {
      if (t0 + j >= t_len) continue;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s1 += ps[(j * kWarps + w) * 2];
        s2 += ps[(j * kWarps + w) * 2 + 1];
      }
      ddt[tbase + static_cast<size_t>(t0 + j) * heads] =
          fmaf(a_h * as[j], s2, s1);
    }
    if (tid == 0) {
      for (int j = kCkpt - 1; j >= 0; --j) {
        if (t0 + j >= t_len) continue;
        float s2 = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s2 += ps[(j * kWarps + w) * 2 + 1];
        da_acc = fmaf(dts[j] * as[j], s2, da_acc);
      }
    }
  }
  if (dstate_in) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) dstate_in[sbase + e] = G[e];
  }
  if (tid == 0) da_part[bh] = da_acc;
}

// dB_ and dC_ [B, T, N]: the heads' partials summed in head order
template <typename T>
__global__ void __launch_bounds__(256)
reduce_heads_kernel(const float* __restrict__ part_b,
                    const float* __restrict__ part_c, T* __restrict__ db,
                    T* __restrict__ dc, size_t n_rows, int heads, int n) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_rows; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t bt = i / n, col = i % n;
    const size_t at = bt * heads * n + col;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < heads; ++h) {
      sb += part_b[at + static_cast<size_t>(h) * n];
      sc += part_c[at + static_cast<size_t>(h) * n];
    }
    db[i] = from_f32<T>(sb);
    dc[i] = from_f32<T>(sc);
  }
}

// dA [H]: the blocks' partials summed over batch rows in order
__global__ void __launch_bounds__(256)
reduce_da_kernel(const float* __restrict__ da_part, float* __restrict__ da,
                 int batch, int heads) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= heads) return;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b)
    acc += da_part[static_cast<size_t>(b) * heads + h];
  da[h] = acc;
}

// ---- bfloat16, T > 1: chunk-parallel on mma.sync --------------------------

// bf16 pieces of the fp32 operands of dx~ and dC_ (the adjoint and state,
// the M = (C B^T) * L and W = (dy x^T) * dt * L tiles), whose products
// feed ddt and dA; dB_'s take pairs
constexpr int kPieces = 3;

template <int kDh, int kN>
struct GradSmem {
  static constexpr int kXB = kDh + 8;  // bf16 row pitches (16 bytes of pad)
  static constexpr int kNB = kN + 8;
  static constexpr int kSF = kN + 4;   // fp32 row pitch of a state
  static constexpr int kPF = kChunk + 1;  // fp32 row pitch of a [t][s] tile
  // each head's x, dy; S_c, G_c
  static constexpr int kBufBytes = 2 * kChunk * kXB * 2 + 2 * kDh * kSF * 4;
  // C_, B_; the group's dt; C B^T; E; kBufs head buffers; each warp's
  // cum, rx, tot; the rows' ia, ib, x . dx~; the sums of dt dl; the
  // warps' sums of S (x) G
  static constexpr int kBytes = 2 * kChunk * kNB * 2 + kChunk * kHeads * 4 +
                                2 * kChunk * kPF * 4 + kBufs * kBufBytes +
                                kStrips * (2 * kChunk + kStrips) * 4 +
                                4 * kChunk * 4 + kStrips * 4;
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

// the lane's two rows' sums of `v` over a row's 4 lanes (q)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// (c) one block a (chunk, b * groups + group of kHeads heads); for each
// head of the group in turn, warp w the strip of rows s0 = 16 w .. s0 +
// 15.  With x~ = dt x, L_ts = exp2(cum_t - cum_s) for s <= t, S_c the
// state entering the chunk and G_c the adjoint leaving it:
//   dx~_s = exp2(total - cum_s) G_c B_s + sum_{t>=s} (C_t . B_s) L_ts dy_t
//   dC_t += exp2(cum_t) S_c^T dy_t + sum_{s<=t} W_ts B_s
//   dB_s += exp2(total - cum_s) dt_s G_c^T x_s + sum_{t>=s} W_ts C_t
//   with W_ts = (dy_t . x_s) dt_s L_ts, dC_ and dB_ summed over the
//   group's heads in order; and, for the decay,
//   dl_j = sum_{t>=j} ia_t + sum_{s<j} ib_s + exp2(total) <G_c, S_c>
//          + sum_{t>=j>s} E_ts
//   with ia_t = C_t . (exp2(cum_t) S_c^T dy_t), ib_s = dt_s x_s .
//   (exp2(total - cum_s) G_c B_s) and E_ts = W_ts (C_t . B_s): the
//   chunk-local identity dl_j = sum_{t>=j} dy_t . y_t - sum_{s>=j} x~_s .
//   dx~_s + sum (G_c (x) S_{c+1}) with the pairs that cancel in it taken
//   out, so that no sum cancels; ddt_s = x_s . dx~_s + A dl_s and dA's
//   per-chunk partial sum_j dt_j dl_j.
template <int kDh, int kN>
__global__ void __launch_bounds__(kThreads)
grads_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
             const bf16* __restrict__ bm, const bf16* __restrict__ cm,
             const float* __restrict__ a_neg, const bf16* __restrict__ dy,
             const float* __restrict__ states,
             const float* __restrict__ adjoints, bf16* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ part_b,
             float* __restrict__ part_c, float* __restrict__ da_part,
             int t_len, int heads, int has_state, int has_dstate) {
  using L = GradSmem<kDh, kN>;
  constexpr int kXB = L::kXB, kNB = L::kNB, kSF = L::kSF, kPF = L::kPF;
  constexpr int kNT = kN / 8;   // n tiles over N
  constexpr int kJT = kDh / 8;  // n tiles over dh
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = cs + kChunk * kNB;
  float* dts = reinterpret_cast<float*>(bs + kChunk * kNB);  // [t][hh]
  float* cb = dts + kChunk * kHeads;  // [t][s] C_t . B_s
  float* es = cb + kChunk * kPF;      // [t][s] E_ts, then row prefix sums
  uint8_t* bufs = reinterpret_cast<uint8_t*>(es + kChunk * kPF);
  float* sums = reinterpret_cast<float*>(bufs + kBufs * L::kBufBytes);
  float* ia = sums + kStrips * (2 * kChunk + kStrips);
  float* ib = ia + kChunk;
  float* xdx = ib + kChunk;
  float* dtdl = xdx + kChunk;  // the two warps' sums of dt dl
  float* red = dtdl + kChunk;
  auto xbuf = [&](int i) {
    return reinterpret_cast<bf16*>(bufs + i * L::kBufBytes);
  };
  auto sbuf = [&](int i) {
    return reinterpret_cast<float*>(bufs + i * L::kBufBytes +
                                    2 * kChunk * kXB * 2);
  };

  const int c = blockIdx.x, n_chunks = gridDim.x;
  const int groups = (heads + kHeads - 1) / kHeads;
  const int b = blockIdx.y / groups, grp = blockIdx.y % groups;
  const int h0 = grp * kHeads;
  const int n_heads = min(kHeads, heads - h0);
  const int t0 = c * kChunk;
  const int live = min(kChunk, t_len - t0);
  const size_t row0 = static_cast<size_t>(b) * t_len + t0;
  const size_t row_stride = static_cast<size_t>(heads) * kDh;
  // S_c is zero for chunk 0 without a state in, G_c for the last chunk
  // without the final state's gradient
  const bool inter_s = c > 0 || has_state;
  const bool inter_g = c + 1 < n_chunks || has_dstate;

  auto load_head = [&](int hh, int i) {
    const int h = h0 + hh;
    load_rows(xbuf(i), kXB, x + (row0 * heads + h) * kDh, row_stride, kDh,
              live);
    load_rows(xbuf(i) + kChunk * kXB, kXB, dy + (row0 * heads + h) * kDh,
              row_stride, kDh, live);
    const size_t slot =
        (static_cast<size_t>(b) * heads + h) * n_chunks + c;
    const float* src_s = states + slot * kDh * kN;
    const float* src_g = adjoints + slot * kDh * kN;
    float* dst = sbuf(i);
    for (int p = threadIdx.x; p < kDh * kN / 4; p += blockDim.x) {
      const int j = p / (kN / 4), n = (p % (kN / 4)) * 4;
      cp_async<16>(dst + j * kSF + n, src_s + j * kN + n, true);
      cp_async<16>(dst + kDh * kSF + j * kSF + n, src_g + j * kN + n, true);
    }
  };
  load_rows(cs, kNB, cm + row0 * kN, kN, kN, live);
  load_rows(bs, kNB, bm + row0 * kN, kN, kN, live);
  load_dt(dts, kHeads, dt + row0 * heads + h0, heads, n_heads, live);
  // a ring of kBufs buffers, as in the prefill's outputs_kernel
  load_head(0, 0);
  cp_async_commit();
#pragma unroll
  for (int ahead = 1; ahead < kBufs - 1; ++ahead) {
    if (ahead < n_heads) load_head(ahead, ahead);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int s0 = kSub * warp;
  const int ta = s0 + g, tb = ta + 8;  // this lane's rows
  float* cum = sums + warp * (2 * kChunk + kStrips);  // this warp's own
  float* rx = cum + kChunk;
  float* tot = rx + kChunk;

  // this strip's rows of dB_ and dC_, summed over the group's heads in
  // order
  float acc_db[kNT][4] = {}, acc_dc[kNT][4] = {};

  for (int hh = 0; hh < n_heads; ++hh) {
    const int i = hh % kBufs;
    __syncthreads();  // head hh - 1's buffer and rows are done with
    if (hh + kBufs - 1 < n_heads)
      load_head(hh + kBufs - 1, (hh + kBufs - 1) % kBufs);
    cp_async_commit();
    cp_async_wait<kBufs - 1>();
    __syncthreads();
    if (hh == 0) {  // C B^T, once for the group: warp w its rows
      uint32_t cfr[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int t = p & 1 ? tb : ta;
        const int n = 2 * q + 8 * (p >> 1);
        cfr[p] = n < kN ? *reinterpret_cast<const uint32_t*>(cs + t * kNB + n)
                        : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        const int s = 8 * nt + g;
        const uint32_t bfr[2] = {
            *reinterpret_cast<const uint32_t*>(bs + s * kNB + 2 * q),
            kN > 8 ? *reinterpret_cast<const uint32_t*>(bs + s * kNB +
                                                        2 * q + 8)
                   : 0u};
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma(d, cfr, bfr);
        cb[ta * kPF + 8 * nt + 2 * q] = d[0];
        cb[ta * kPF + 8 * nt + 2 * q + 1] = d[1];
        cb[tb * kPF + 8 * nt + 2 * q] = d[2];
        cb[tb * kPF + 8 * nt + 2 * q + 1] = d[3];
      }
      __syncthreads();
    }
    const int h = h0 + hh;
    const float* dth = dts + hh;  // row t at dth[t * kHeads]
    const float a_h = a_neg[h];
    strip_sums(dth, kHeads, a_h * kLog2e, cum, rx, tot);
    __syncwarp();
    const bf16* xs = xbuf(i);
    const bf16* ys = xs + kChunk * kXB;
    const float* S = sbuf(i);
    const float* G = S + kDh * kSF;
    // exp2(cum_t - cum_s) for s <= t, every exponent a sum of its own
    // steps' terms
    auto decay = [&](int t, int s) {
      const int wt = t / kSub, ws = s / kSub;
      return fast_exp2(wt == ws ? cum[t] - cum[s]
                                : cum[t] + rx[s] + span(tot, ws + 1, wt));
    };
    const float pre = span(tot, 0, warp), post = span(tot, warp + 1, kStrips);
    const float ecum_a = fast_exp2(pre + cum[ta]);
    const float ecum_b = fast_exp2(pre + cum[tb]);
    const float etc_a = fast_exp2(rx[ta] + post);
    const float etc_b = fast_exp2(rx[tb] + post);
    const float dt_a = dth[ta * kHeads], dt_b = dth[tb * kHeads];

    // ---- dC_ (rows t of the strip) and ia ----
    {
      float acc[kNT][4] = {};
      if (inter_s) {
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk) {
          uint32_t a[4];
          frag_a(a, ys, kXB, s0, 16 * kk, g, q);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const int n = 8 * nt + g, j0 = 16 * kk + 2 * q;
            uint32_t p0[kPieces], p1[kPieces];
            split_pieces<kPieces>(S[j0 * kSF + n], S[(j0 + 1) * kSF + n], p0);
            split_pieces<kPieces>(S[(j0 + 8) * kSF + n], S[(j0 + 9) * kSF + n],
                                  p1);
#pragma unroll
            for (int y = 0; y < kPieces; ++y) {
              const uint32_t bb[2] = {p0[y], p1[y]};
              mma(acc[nt], a, bb);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] *= e < 2 ? ecum_a : ecum_b;
      }
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int n = 8 * nt + 2 * q + e1;
          pa += __bfloat162float(cs[ta * kNB + n]) * acc[nt][e1];
          pb += __bfloat162float(cs[tb * kNB + n]) * acc[nt][2 + e1];
        }
      pa = quad_sum(pa);
      pb = quad_sum(pb);
      if (q == 0) {
        ia[ta] = pa;
        ia[tb] = pb;
      }
      for (int j = 0; j <= warp; ++j) {  // the strips up to this one
        float qt[2][4] = {};  // dy_t . x_s: rows t, columns s of strip j
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk) {
          uint32_t a[4];
          frag_a(a, ys, kXB, s0, 16 * kk, g, q);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t bb[2];
            frag_b_nk(bb, xs, kXB, kSub * j + 8 * half, 16 * kk, g, q);
            mma(qt[half], a, bb);
          }
        }
        // W = Q dt_s L (s <= t), and E = W C B^T (s < t) for dl
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = e < 2 ? ta : tb;
            const int s = kSub * j + 8 * half + 2 * q + (e & 1);
            const float wv =
                s <= t ? qt[half][e] * dth[s * kHeads] * decay(t, s) : 0.f;
            qt[half][e] = wv;
            es[t * kPF + s] = s < t ? wv * cb[t * kPF + s] : 0.f;
          }
        uint32_t ap[kPieces][4];
        tiles_as_a<kPieces>(qt, ap);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t bb[2];
          frag_b_kn(bb, bs, kNB, 8 * nt, kSub * j, g, q);
#pragma unroll
          for (int y = 0; y < kPieces; ++y) mma(acc[nt], ap[y], bb);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_dc[nt][e] += acc[nt][e];
    }

    // ---- dx~, dx and ib, x . dx~ (rows s of the strip) ----
    {
      float acc[kJT][4] = {};
      if (inter_g) {
        uint32_t a[4];  // B_ rows s, k = n (zero past kN)
        a[0] = *reinterpret_cast<const uint32_t*>(bs + ta * kNB + 2 * q);
        a[1] = *reinterpret_cast<const uint32_t*>(bs + tb * kNB + 2 * q);
        a[2] = kN > 8 ? *reinterpret_cast<const uint32_t*>(bs + ta * kNB +
                                                           2 * q + 8)
                      : 0u;
        a[3] = kN > 8 ? *reinterpret_cast<const uint32_t*>(bs + tb * kNB +
                                                           2 * q + 8)
                      : 0u;
#pragma unroll
        for (int n = 0; n < kJT; ++n) {
          const int j = 8 * n + g;
          uint32_t p0[kPieces], p1[kPieces];
          split_pieces<kPieces>(G[j * kSF + 2 * q], G[j * kSF + 2 * q + 1],
                                p0);
          if (kN > 8) {
            split_pieces<kPieces>(G[j * kSF + 2 * q + 8],
                                  G[j * kSF + 2 * q + 9], p1);
          } else {
#pragma unroll
            for (int y = 0; y < kPieces; ++y) p1[y] = 0u;
          }
#pragma unroll
          for (int y = 0; y < kPieces; ++y) {
            const uint32_t bb[2] = {p0[y], p1[y]};
            mma(acc[n], a, bb);
          }
        }
#pragma unroll
        for (int n = 0; n < kJT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= e < 2 ? etc_a : etc_b;
      }
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int n = 0; n < kJT; ++n)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int j = 8 * n + 2 * q + e1;
          pa += __bfloat162float(xs[ta * kXB + j]) * acc[n][e1];
          pb += __bfloat162float(xs[tb * kXB + j]) * acc[n][2 + e1];
        }
      pa = quad_sum(pa);
      pb = quad_sum(pb);
      if (q == 0) {
        ib[ta] = dt_a * pa;
        ib[tb] = dt_b * pb;
      }
      for (int j = warp; j < kStrips; ++j) {  // the strips from this one
        float mt[2][4];  // (C_t . B_s) L_ts: rows s, columns t of strip j
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = e < 2 ? ta : tb;
            const int t = kSub * j + 8 * half + 2 * q + (e & 1);
            mt[half][e] = t >= s ? cb[t * kPF + s] * decay(t, s) : 0.f;
          }
        uint32_t ap[kPieces][4];
        tiles_as_a<kPieces>(mt, ap);
#pragma unroll
        for (int n = 0; n < kJT; ++n) {
          uint32_t bb[2];
          frag_b_kn(bb, ys, kXB, 8 * n, kSub * j, g, q);
#pragma unroll
          for (int y = 0; y < kPieces; ++y) mma(acc[n], ap[y], bb);
        }
      }
      pa = 0.f;
      pb = 0.f;
#pragma unroll
      for (int n = 0; n < kJT; ++n)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int j = 8 * n + 2 * q + e1;
          pa += __bfloat162float(xs[ta * kXB + j]) * acc[n][e1];
          pb += __bfloat162float(xs[tb * kXB + j]) * acc[n][2 + e1];
        }
      pa = quad_sum(pa);
      pb = quad_sum(pb);
      if (q == 0) {
        xdx[ta] = pa;
        xdx[tb] = pb;
      }
      bf16* xa = dx + ((row0 + ta) * heads + h) * kDh;
      bf16* xb = dx + ((row0 + tb) * heads + h) * kDh;
#pragma unroll
      for (int n = 0; n < kJT; ++n) {
        const int j = 8 * n + 2 * q;
        if (ta < live)
          *reinterpret_cast<__nv_bfloat162*>(xa + j) =
              __floats2bfloat162_rn(dt_a * acc[n][0], dt_a * acc[n][1]);
        if (tb < live)
          *reinterpret_cast<__nv_bfloat162*>(xb + j) =
              __floats2bfloat162_rn(dt_b * acc[n][2], dt_b * acc[n][3]);
      }
    }

    // ---- dB_ (rows s of the strip) ----
    {
      float acc[kNT][4] = {};
      if (inter_g) {
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk) {
          uint32_t a[4];
          frag_a(a, xs, kXB, s0, 16 * kk, g, q);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const int n = 8 * nt + g, j0 = 16 * kk + 2 * q;
            uint32_t p0[2], p1[2];
            split_pieces<2>(G[j0 * kSF + n], G[(j0 + 1) * kSF + n], p0);
            split_pieces<2>(G[(j0 + 8) * kSF + n], G[(j0 + 9) * kSF + n], p1);
            const uint32_t bh2[2] = {p0[0], p1[0]}, bl2[2] = {p0[1], p1[1]};
            mma(acc[nt], a, bh2);
            mma(acc[nt], a, bl2);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[nt][e] *= e < 2 ? etc_a * dt_a : etc_b * dt_b;
      }
      for (int j = warp; j < kStrips; ++j) {  // the strips from this one
        float qt[2][4] = {};  // x_s . dy_t: rows s, columns t of strip j
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk) {
          uint32_t a[4];
          frag_a(a, xs, kXB, s0, 16 * kk, g, q);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t bb[2];
            frag_b_nk(bb, ys, kXB, kSub * j + 8 * half, 16 * kk, g, q);
            mma(qt[half], a, bb);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = e < 2 ? ta : tb;
            const int t = kSub * j + 8 * half + 2 * q + (e & 1);
            qt[half][e] = t >= s ? qt[half][e] * (e < 2 ? dt_a : dt_b) *
                                       decay(t, s)
                                 : 0.f;
          }
        uint32_t ap[2][4];
        tiles_as_a<2>(qt, ap);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t bb[2];
          frag_b_kn(bb, cs, kNB, 8 * nt, kSub * j, g, q);
          mma(acc[nt], ap[0], bb);
          mma(acc[nt], ap[1], bb);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_db[nt][e] += acc[nt][e];
    }

    // <G_c, S_c>: each thread its elements, then the warps' sums in order
    {
      float p = 0.f;
      for (int e = threadIdx.x; e < kDh * kN; e += blockDim.x) {
        const int at = (e / kN) * kSF + e % kN;
        p += S[at] * G[at];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) red[warp] = p;
    }
    __syncthreads();  // ia, ib, x . dx~, E, the warps' sums
    // E's rows as exclusive prefix sums: es[t][j] = sum_{s<j} E_ts, j <= t
    for (int t = threadIdx.x; t < kChunk; t += blockDim.x) {
      float run = 0.f;
      for (int s = 0; s < t; ++s) {
        const float e = es[t * kPF + s];
        es[t * kPF + s] = run;
        run += e;
      }
      es[t * kPF + t] = run;
    }
    __syncthreads();
    if (threadIdx.x < kChunk) {
      const int j = threadIdx.x;
      float cross = 0.f, sa = 0.f, sb = 0.f;
#pragma unroll 8
      for (int t = j; t < kChunk; ++t) {
        cross += es[t * kPF + j];
        sa += ia[t];
      }
#pragma unroll 8
      for (int s = 0; s < j; ++s) sb += ib[s];
      float gs = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < kStrips; ++w2) gs += red[w2];
      gs *= fast_exp2(span(tot, 0, kStrips));
      const float dl = sa + sb + gs + cross;
      if (j < live) ddt[(row0 + j) * heads + h] = xdx[j] + a_h * dl;
      // dA's partial sum_j dt_j dl_j: each of the two warps' rows by
      // shuffles, then the warps in order
      float p = dth[j * kHeads] * dl;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) dtdl[warp] = p;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      da_part[(static_cast<size_t>(b) * heads + h) * n_chunks + c] =
          dtdl[0] + dtdl[1];
  }
  // the group's partials of dB_ and dC_ [B, T, groups, N]
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = 8 * nt + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = half ? tb : ta;
      if (t >= live) continue;
      const size_t at = ((row0 + t) * groups + grp) * kN + n;
      *reinterpret_cast<float2*>(part_b + at) =
          make_float2(acc_db[nt][2 * half], acc_db[nt][2 * half + 1]);
      *reinterpret_cast<float2*>(part_c + at) =
          make_float2(acc_dc[nt][2 * half], acc_dc[nt][2 * half + 1]);
    }
  }
}

// dA [H]: the per-chunk partials summed over batch rows and chunks in
// order
__global__ void __launch_bounds__(256)
reduce_da_chunks_kernel(const float* __restrict__ da_part,
                        float* __restrict__ da, int batch, int heads,
                        int n_chunks) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= heads) return;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b)
    for (int c = 0; c < n_chunks; ++c)
      acc += da_part[(static_cast<size_t>(b) * heads + h) * n_chunks + c];
  da[h] = acc;
}

// (a') one block a (chunk, b * groups + group of kIncHeads heads), warp
// hh a head: the chunk's increment of the adjoint, dG = dY^T (C_
// exp2(cum)), cum the steps up to and with each row, by the prefill's
// increment_head in kPieces pieces.  The group's dy rows lie side by
// side (kIncHeads dh bf16 a row) and so do its dt.
template <int kDh, int kN>
__global__ void __launch_bounds__(kThreads)
adjoint_increments_kernel(const bf16* __restrict__ dy,
                          const float* __restrict__ dt,
                          const bf16* __restrict__ cm,
                          const float* __restrict__ a_neg,
                          float* __restrict__ inc, int t_len, int heads) {
  using I = Smem<kDh, kN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);  // [kChunk][kIncRow]
  bf16* cs = ys + kChunk * I::kIncRow;
  float* dts = reinterpret_cast<float*>(cs + kChunk * I::kNB);
  float* sums = dts + kChunk * kIncHeads;

  const int c = blockIdx.x, n_chunks = gridDim.x;
  const int groups = (heads + kIncHeads - 1) / kIncHeads;
  const int b = blockIdx.y / groups;
  const int h0 = (blockIdx.y % groups) * kIncHeads;
  const int n_heads = min(kIncHeads, heads - h0);
  const int t0 = c * kChunk;
  const int live = min(kChunk, t_len - t0);
  const size_t row0 = static_cast<size_t>(b) * t_len + t0;

  load_rows(ys, I::kIncRow, dy + (row0 * heads + h0) * kDh,
            static_cast<size_t>(heads) * kDh, n_heads * kDh, live);
  load_rows(cs, I::kNB, cm + row0 * kN, kN, kN, live);
  load_dt(dts, kIncHeads, dt + row0 * heads + h0, heads, n_heads, live);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int hh = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (hh >= n_heads) return;
  const int h = h0 + hh;
  float* cum = sums + hh * (3 * kChunk + kStrips);  // this warp's own
  float* rx = cum + kChunk;
  float* wt = rx + kChunk;
  float* tot = wt + kChunk;
  strip_sums(dts + hh, kIncHeads, a_neg[h] * kLog2e, cum, rx, tot);
  __syncwarp();
  for (int s = lane; s < kChunk; s += 32)
    wt[s] = fast_exp2(cum[s] + span(tot, 0, s / kSub));
  __syncwarp();
  const size_t slot = (static_cast<size_t>(b) * heads + h) * n_chunks + c;
  increment_head<kDh, kN, kPieces>(ys + hh * kDh, I::kIncRow, cs, wt,
                                   inc + slot * kDh * kN);
}

// (b') the prefill's walk over the chunks, backwards: G_{c-1} =
// exp2(total_c) G_c + dG_c from G_{NC-1} = dstate, leaving each chunk's
// G_c in `inc` and the input state's gradient in dstate_in
template <int kDh, int kN>
__global__ void __launch_bounds__(kPassThreads)
adjoint_pass_kernel(const float* dstate, float* dstate_in, float* inc,
                    const float* __restrict__ decays, int n_chunks) {
  pass_walk<kDh, kN, true>(dstate, dstate_in, inc, decays, n_chunks);
}

template <int kDh, int kN>
int launch_chunked(const void* x, const float* dt, const void* bm,
                   const void* cm, const float* A, const float* state_in,
                   const void* dy, const float* dstate, void* dx, float* ddt,
                   void* db, void* dc, float* da, float* dstate_in,
                   float* scratch, const float* saved, int batch, int t_len,
                   int heads, cudaStream_t stream) {
  using I = Smem<kDh, kN>;
  using L = GradSmem<kDh, kN>;
  const int nc = static_cast<int>(n_chunks_of(t_len));
  const int bhs = batch * heads;
  const int groups = (heads + kHeads - 1) / kHeads;
  const int inc_groups = (heads + kIncHeads - 1) / kIncHeads;
  if (bhs > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  const size_t elems = static_cast<size_t>(kDh) * kN;
  // the prefill's scratch layout: the states entering each chunk
  // [bhs][nc][dh][N], then the chunks' decays [bhs][nc] (rounded up to
  // whole float4s here, so that what follows takes float4s)
  float* states = scratch;
  float* decays = states + static_cast<size_t>(bhs) * nc * elems;
  float* adjoints = decays + (static_cast<size_t>(bhs) * nc + 3) / 4 * 4;
  float* part_b = adjoints + static_cast<size_t>(bhs) * nc * elems;
  float* part_c = part_b + static_cast<size_t>(batch) * t_len * groups * kN;
  float* da_part = part_c + static_cast<size_t>(batch) * t_len * groups * kN;
  cudaError_t err = allow_smem(increments_kernel<kDh, kN>, I::kIncBytes);
  if (err == cudaSuccess)
    err = allow_smem(adjoint_increments_kernel<kDh, kN>, I::kIncBytes);
  if (err == cudaSuccess)
    err = allow_smem(grads_kernel<kDh, kN>, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* yb = static_cast<const bf16*>(dy);
  const auto* bb = static_cast<const bf16*>(bm);
  const auto* cb = static_cast<const bf16*>(cm);
  const dim3 pass_grid((kDh * kN / 4 + kPassThreads - 1) / kPassThreads, bhs);
  const float* st = saved;
  const float* dec =
      saved ? saved + static_cast<size_t>(bhs) * nc * elems : nullptr;
  if (!saved) {
    // the states entering each chunk: the prefill's phases (a) and (b),
    // bit for bit what its scratch holds
    increments_kernel<kDh, kN>
        <<<dim3(nc, batch * inc_groups), kThreads, I::kIncBytes, stream>>>(
            xb, dt, bb, A, states, decays, t_len, heads);
    pass_kernel<kDh, kN><<<pass_grid, kPassThreads, 0, stream>>>(
        state_in, nullptr, states, decays, nc);
    st = states;
    dec = decays;
  }
  // the adjoints leaving each chunk and the input state's gradient
  adjoint_increments_kernel<kDh, kN>
      <<<dim3(nc, batch * inc_groups), kThreads, I::kIncBytes, stream>>>(
          yb, dt, cb, A, adjoints, t_len, heads);
  adjoint_pass_kernel<kDh, kN><<<pass_grid, kPassThreads, 0, stream>>>(
      dstate, dstate_in, adjoints, dec, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grads_kernel<kDh, kN><<<dim3(nc, batch * groups), kThreads, L::kBytes,
                          stream>>>(
      xb, dt, bb, cb, A, yb, st, adjoints, static_cast<bf16*>(dx), ddt,
      part_b, part_c, da_part, t_len, heads, state_in != nullptr,
      dstate != nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_rows = static_cast<size_t>(batch) * t_len * kN;
  const size_t grid = (n_rows + 255) / 256;
  reduce_heads_kernel<bf16>
      <<<static_cast<unsigned>(grid < 65536 * 8 ? grid : 65536 * 8), 256, 0,
         stream>>>(part_b, part_c, static_cast<bf16*>(db),
                   static_cast<bf16*>(dc), n_rows, groups, kN);
  reduce_da_chunks_kernel<<<(heads + 255) / 256, 256, 0, stream>>>(
      da_part, da, batch, heads, nc);
  return static_cast<int>(cudaGetLastError());
}

int n_ckpts_of(int t_len) { return (t_len + kCkpt - 1) / kCkpt; }

template <typename T, int kDh, int kN>
int launch(const void* x, const float* dt, const void* bm, const void* cm,
           const float* A, const float* state_in, const void* dy,
           const float* dstate, void* dx, float* ddt, void* db, void* dc,
           float* da, float* dstate_in, float* scratch, const float* saved,
           int batch, int t_len, int heads, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (t_len > 1)
      return launch_chunked<kDh, kN>(x, dt, bm, cm, A, state_in, dy, dstate,
                                     dx, ddt, db, dc, da, dstate_in, scratch,
                                     saved, batch, t_len, heads, stream);
  }
  using L = Shape<kDh, kN>;
  const int n_chunks = n_ckpts_of(t_len);
  const size_t blocks = static_cast<size_t>(batch) * heads;
  const size_t n_part = static_cast<size_t>(batch) * t_len * heads * kN;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  float* ckpt = scratch;
  float* part_b = ckpt + blocks * n_chunks * L::kThreads * 4;
  float* part_c = part_b + n_part;
  float* da_part = part_c + n_part;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T, kDh, kN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel<T, kDh, kN><<<static_cast<unsigned>(blocks), L::kThreads,
                               L::kBytes, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(bm),
      static_cast<const T*>(cm), A, state_in, static_cast<const T*>(dy),
      dstate, static_cast<T*>(dx), ddt, dstate_in, ckpt, part_b, part_c,
      da_part, t_len, heads, n_chunks);
  const size_t n_rows = static_cast<size_t>(batch) * t_len * kN;
  const size_t grid = (n_rows + 255) / 256;
  reduce_heads_kernel<T>
      <<<static_cast<unsigned>(grid < 65536 * 8 ? grid : 65536 * 8), 256, 0,
         stream>>>(part_b, part_c, static_cast<T*>(db), static_cast<T*>(dc),
                   n_rows, heads, kN);
  reduce_da_kernel<<<(heads + 255) / 256, 256, 0, stream>>>(da_part, da,
                                                             batch, heads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kDh>
int by_state(const void* x, const float* dt, const void* bm, const void* cm,
             const float* A, const float* state_in, const void* dy,
             const float* dstate, void* dx, float* ddt, void* db, void* dc,
             float* da, float* dstate_in, float* scratch,
             const float* saved, int batch, int t_len, int heads,
             int d_state, cudaStream_t stream) {
  if (d_state == 8)
    return launch<T, kDh, 8>(x, dt, bm, cm, A, state_in, dy, dstate, dx, ddt,
                             db, dc, da, dstate_in, scratch, saved, batch,
                             t_len, heads, stream);
  if (d_state == 16)
    return launch<T, kDh, 16>(x, dt, bm, cm, A, state_in, dy, dstate, dx,
                              ddt, db, dc, da, dstate_in, scratch, saved,
                              batch, t_len, heads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* x, const float* dt, const void* bm, const void* cm,
             const float* A, const float* state_in, const void* dy,
             const float* dstate, void* dx, float* ddt, void* db, void* dc,
             float* da, float* dstate_in, float* scratch,
             const float* saved, int batch, int t_len, int heads,
             int head_dim, int d_state, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return by_state<T, 32>(x, dt, bm, cm, A, state_in, dy, dstate, dx, ddt,
                             db, dc, da, dstate_in, scratch, saved, batch,
                             t_len, heads, d_state, stream);
    case 64:
      return by_state<T, 64>(x, dt, bm, cm, A, state_in, dy, dstate, dx, ddt,
                             db, dc, da, dstate_in, scratch, saved, batch,
                             t_len, heads, d_state, stream);
    case 128:
      return by_state<T, 128>(x, dt, bm, cm, A, state_in, dy, dstate, dx,
                              ddt, db, dc, da, dstate_in, scratch, saved,
                              batch, t_len, heads, d_state, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Scratch floats ssd_bwd needs (0 for an empty call).  A bfloat16 call
// with t_len > 1 (dtype 1): the states entering each chunk of 64 steps,
// the chunks' decays [batch, heads, NC] (rounded up to whole float4s)
// and the adjoints leaving each chunk, [batch, heads, NC, head_dim,
// d_state] each, the head groups' partials of dB_ and dC_ [batch, t_len,
// ceil(heads / 8), d_state] each, and dA's per-chunk partials.
// Otherwise: the checkpoints, the heads' partials of dB_ and dC_, and
// dA's per-block partials.
extern "C" long long ssd_bwd_scratch_floats(int batch, int t_len, int heads,
                                            int head_dim, int d_state,
                                            int dtype) {
  if (batch <= 0 || t_len <= 0 || heads <= 0) return 0;
  const long long bh = static_cast<long long>(batch) * heads;
  if (dtype == 1 && t_len > 1) {
    const long long nc = static_cast<long long>(n_chunks_of(t_len));
    const long long groups = (heads + kHeads - 1) / kHeads;
    return 2 * bh * nc * head_dim * d_state + (bh * nc + 3) / 4 * 4 +
           2 * static_cast<long long>(batch) * t_len * groups * d_state +
           bh * nc;
  }
  return bh * n_ckpts_of(t_len) * head_dim * d_state +
         2 * bh * t_len * d_state + bh;
}

// C interface, loaded with ctypes.  x, dy, dx: [batch, t_len, heads,
// head_dim] of one dtype (0 float32, 1 bfloat16); dt, ddt: [batch,
// t_len, heads] float32; bm, cm, db, dc: [batch, t_len, d_state] in x's
// dtype; A, dA: [heads] float32; state_in (or null for a zero state),
// dstate (the final state's gradient, or null for zeros) and dstate_in
// (the input state's gradient, or null to skip it): [batch, heads,
// head_dim, d_state] float32; scratch: at least ssd_bwd_scratch_floats(...)
// floats, 16-byte aligned; all contiguous; for a bfloat16 call with
// t_len > 1, x, dt, bm, cm and dy 16-byte aligned (cp.async), state_in
// and dstate read as float4s, and `saved` either null or the scratch of
// the ssd call on the same inputs (the states entering each chunk, then
// the chunks' decays, as ssd_scratch_floats lays them out): the backward
// then takes the states from it instead of recomputing them; it is
// ignored otherwise.  batch, t_len and heads must be at least 1.
// Launches on `stream` (five kernels for a bfloat16 call with t_len > 1
// and `saved`, seven without, three otherwise), does not synchronise,
// and returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a head dim other than 32, 64 or 128, a
// d_state other than 8 or 16, another dtype, or a bfloat16 call with
// t_len > 1 of more than 65,535 (batch, head) rows).
extern "C" int ssd_bwd(const void* x, const void* dt, const void* bm,
                       const void* cm, const void* A, const void* state_in,
                       const void* dy, const void* dstate, void* dx,
                       void* ddt, void* db, void* dc, void* dA,
                       void* dstate_in, void* scratch, const void* saved,
                       int batch, int t_len, int heads, int head_dim,
                       int d_state, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* ap = static_cast<const float*>(A);
  const auto* si = static_cast<const float*>(state_in);
  const auto* dsf = static_cast<const float*>(dstate);
  auto* ddtp = static_cast<float*>(ddt);
  auto* dap = static_cast<float*>(dA);
  auto* dsi = static_cast<float*>(dstate_in);
  auto* sc = static_cast<float*>(scratch);
  const auto* sv = static_cast<const float*>(saved);
  if (dtype == 0)
    return dispatch<float>(x, dtp, bm, cm, ap, si, dy, dsf, dx, ddtp, db, dc,
                           dap, dsi, sc, sv, batch, t_len, heads, head_dim,
                           d_state, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dtp, bm, cm, ap, si, dy, dsf, dx, ddtp,
                                   db, dc, dap, dsi, sc, sv, batch, t_len,
                                   heads, head_dim, d_state, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
