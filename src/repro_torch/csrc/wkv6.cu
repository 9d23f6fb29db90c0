// RWKV6 WKV scan with data-dependent decay, with the state carried in
// and out.
//
// Replaces, in the JAX package, src/repro/kernels/rwkv6_scan/kernel.py
// wkv6 (_wkv_kernel).  The TPU form takes [B*H, T, dh] one head at a
// time (its ops.py loops over heads in Python), walks a (head, chunk)
// grid whose chunk axis is sequential with the [dh, dh] state in VMEM
// scratch, starts from a zero state, returns no state and asserts
// T % chunk == 0.  Here r, k, v, logw are read as [B, T, H, dh], the
// layout the model produces, one call covers every head, the state
// comes in (or is zero) and goes out, and the ragged last chunk is
// masked here, so T takes any value.
//
// What it computes, per (b, h), with S the [dh_k, dh_v] state:
//   o_t = r_t . (S + u (x) k_t^T v_t);   S <- diag(exp(w_t)) S + k_t^T v_t
// all in fp32, o stored in r's dtype, the final S in fp32.
//
// What bounds it on an H100.  At RWKV6-7B's prefill (B = 1, T = 512,
// H = 64, dh = 64, bf16) the function moves 26.2 MB (r, k, v, o in bf16,
// logw in fp32, the final state) and its state terms are 4 dh^2 FLOPs a
// token and head, 0.54 GFLOP: about 8 us either way.  A chunk-serial
// walk (one block a (b, h, 32 columns) taking 32 chunks of 16 one after
// another, each loaded after the last one's update) is a latency chain
// of some 8 us a chunk, 32x the bound.  At decode (T = 1)
// the bytes are the state in and out, 2.1 MB (0.6 us); the floor is the
// kernel's fixed cost.
//
// The design, picked from t_len and the dtype inside the C entry point:
//
// bfloat16 prefill (T > 1): chunk-parallel, three kernels over chunks of
// kChunk = 64 steps, each a warp's strips of kSub = 16 rows.
//  (a) increments_kernel, one block a (b, h, chunk), all at once: the
//      chunk's state increment dS = K~^T V with K~ = k exp(total - cum)
//      and its decay exp(total), into a scratch of [B, H, NC, dh, dh]
//      (and [B, H, NC, dh]) that the wrapper allocates: 8.4 MB at T =
//      512, well inside the 50 MB L2, where phases (b) and (c) find it.
//  (b) pass_kernel, one thread a float4 of state elements: the short
//      sequential walk over the NC chunks, S_{c+1} = exp(total_c) S_c +
//      dS_c, with 16 chunks' loads in flight, which writes the state
//      entering each chunk over its increment and the final state.
//  (c) outputs_kernel, one block a (b, h, chunk), all at once: each
//      output once, o = (r exp(cumx)) S_c + A V with A the chunk's
//      scores, rounded once to bf16.  A keeps the exact pairwise
//      exponent only on its diagonal 16 x 16 tiles, one thread a (t, s)
//      pair on the CUDA cores into shared memory; below them it factors
//      at the later strip's start b, (r_t exp(cumx_t - cumx_b)) .
//      (k_s exp(cumx_b - cum_s)), both exponents 0 or less, and is a
//      matrix product.  The block forms once what its warps share: k
//      weighted to its strip's end and, per pair of strips, the decay of
//      the strips between, so a k_s factor is one product, not an exp.
//  Every product of (a) and (c) runs on the tensor cores (mma.sync
//  m16n8k16, fp32 sums).  r, k, v arrive in bf16 and go in as they are;
//  an operand computed in fp32 (a decay-weighted r or k, the scores,
//  the state) goes in as a bf16 pair hi = bf16(a), lo = bf16(a - hi):
//  two products where one side is a pair, three (hi.hi + hi.lo + lo.hi)
//  where both are.  A single bf16 rounding of those operands breaks
//  chip_smoke.py's limits (tests/test_torch_scan_design.py); the pairs
//  hold them.  Each block loads its chunk with cp.async in groups: the
//  log decays first, whose prefix sums run while r, k, v and the
//  entering state are still in flight.  Decays are 2^x by the SFU
//  (ex2.approx).
//
//  What bounds it now: latency.  At T = 512 the 512 blocks of each
//  phase are one or two waves, each block a chain of loads, prefix sums
//  and products (on an H100, PERF.md: the outputs kernel's loads, sums,
//  shared factors and stores alone take 19 of its 38 us).
//
// float32 prefill: the chunk-serial kernel on the fp32 CUDA cores
// (serial_kernel), so that fp32 callers keep exact fp32 products.
//
// decode (T = 1), either dtype: decode_kernel, one block a (b, h, 16
// value columns), no chunk staging: each thread owns a float4 of
// columns on dh / 32 state rows in registers, reads its rows of r, k,
// w, u and its columns of v, writes the new state rows, and the output
// sums over rows by warp shuffles and one shared-memory step.
//
// Overflow.  The Pallas kernel factors the in-chunk decay as
// (r exp(cum - w)) . (k exp(-cum)), and exp(-cum) overflows fp32 once
// the decay summed over a chunk passes about 88 (logw = -8 over 64 steps
// sums to 512).  Here every exponent is a sum of log decays over a
// stretch of steps, 0 or less, and each such sum is formed from its own
// terms (strip-local prefix and suffix sums, and strip totals added in
// order), never as the difference of two longer sums, which would lose
// the short sum's digits to the long ones'.  The one difference is the
// diagonal tiles' cumx_t - cum_s, of two sums over at most 16 steps, as
// in the chunk-serial kernel.  Decays are taken in log2 units.
//
// Aliasing: state_in may equal state_out.  Only decode_kernel, the
// serial kernel and pass_kernel read state_in, and in each the thread
// (or block) that writes an element of state_out has read it first;
// outputs_kernel reads the entering states from the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wkv6_chunk.cuh"

namespace {

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

// ---- float32 prefill: chunk-serial on the CUDA cores -------------------

constexpr int kSerialChunk = 16;  // timesteps per chunk
constexpr int kCols = 32;         // value columns per block
constexpr int kSerialThreads = 256;
static_assert(kSerialChunk * kSerialChunk == kSerialThreads,
              "one thread per (t, s) pair");

template <int kDh>
constexpr int serial_smem_floats() {
  return kDh * kCols                         // state slice S[d][j]
         + 4 * kSerialChunk * (kDh + 1)      // r, k, cum, cumx
         + kSerialChunk * kCols              // v slice
         + kSerialChunk * (kSerialChunk + 1)  // A
         + 3 * kDh;                          // u, total, exp(total)
}

// One block per (batch, head, 32 value columns) walks the chunks of 16
// in order; a chunk's r, k, cum and cumx are staged as fp32 rows padded
// to dh + 1 words, the state's [dh, 32] slice lives in shared memory,
// one thread a (t, s) pair forms the in-chunk scores A, then each thread
// owns outputs (t, j) and state elements (d, j).
template <typename T, int kDh>
__global__ void __launch_bounds__(kSerialThreads)
serial_kernel(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ logw,
              const float* __restrict__ u, const float* state_in, T* out,
              float* state_out, int t_len, int heads) {
  constexpr int kC = kSerialChunk;
  constexpr int kRow = kDh + 1;
  constexpr int kSplit = kDh / kCols;
  extern __shared__ float smem[];
  float* S = smem;                      // [kDh][kCols]
  float* rs = S + kDh * kCols;          // [kC][kRow]
  float* ks = rs + kC * kRow;
  float* cum = ks + kC * kRow;
  float* cumx = cum + kC * kRow;
  float* vs = cumx + kC * kRow;         // [kC][kCols]
  float* att = vs + kC * kCols;         // [kC][kC + 1]
  float* us = att + kC * (kC + 1);      // [kDh]
  float* total = us + kDh;
  float* decay = total + kDh;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / kSplit;
  const int j0 = (blockIdx.x % kSplit) * kCols;
  const int b = bh / heads;
  const int h = bh % heads;
  // element (t, d) of [B, T, H, dh] is at base + t * row_stride + d
  const size_t row_stride = static_cast<size_t>(heads) * kDh;
  const size_t base = (static_cast<size_t>(b) * t_len * heads + h) * kDh;
  const size_t sbase = static_cast<size_t>(bh) * kDh * kDh;

  for (int i = tid; i < kDh * kCols; i += kSerialThreads) {
    const int d = i / kCols, j = i % kCols;
    S[i] = state_in ? state_in[sbase + d * kDh + j0 + j] : 0.f;
  }
  for (int d = tid; d < kDh; d += kSerialThreads) us[d] = u[h * kDh + d];

  for (int t0 = 0; t0 < t_len; t0 += kC) {
    // rows past T are r = k = v = 0 and w = 0: they add nothing
    for (int i = tid; i < kC * kDh; i += kSerialThreads) {
      const int t = i / kDh, d = i % kDh;
      const bool live = t0 + t < t_len;
      const size_t at = base + static_cast<size_t>(t0 + t) * row_stride + d;
      rs[t * kRow + d] = live ? to_f32(r[at]) : 0.f;
      ks[t * kRow + d] = live ? to_f32(k[at]) : 0.f;
      cum[t * kRow + d] = live ? logw[at] : 0.f;
    }
    for (int i = tid; i < kC * kCols; i += kSerialThreads) {
      const int t = i / kCols, j = i % kCols;
      const size_t at =
          base + static_cast<size_t>(t0 + t) * row_stride + j0 + j;
      vs[i] = t0 + t < t_len ? to_f32(v[at]) : 0.f;
    }
    __syncthreads();
    for (int d = tid; d < kDh; d += kSerialThreads) {
      float run = 0.f;
      for (int t = 0; t < kC; ++t) {
        cumx[t * kRow + d] = run;
        run += cum[t * kRow + d];
        cum[t * kRow + d] = run;
      }
      total[d] = run;
      decay[d] = expf(run);
    }
    __syncthreads();
    {
      const int t = tid / kC, s = tid % kC;
      float a = 0.f;
      if (s < t) {
        for (int d = 0; d < kDh; ++d)
          a += rs[t * kRow + d] * ks[s * kRow + d] *
               expf(cumx[t * kRow + d] - cum[s * kRow + d]);
      } else if (s == t) {
        for (int d = 0; d < kDh; ++d)
          a += rs[t * kRow + d] * us[d] * ks[t * kRow + d];
      }
      att[t * (kC + 1) + s] = a;
    }
    __syncthreads();
    for (int i = tid; i < kC * kDh; i += kSerialThreads) {
      const int t = i / kDh, d = i % kDh;
      rs[t * kRow + d] *= expf(cumx[t * kRow + d]);
      ks[t * kRow + d] *= expf(total[d] - cum[t * kRow + d]);
    }
    __syncthreads();
    for (int i = tid; i < kC * kCols; i += kSerialThreads) {
      const int t = i / kCols, j = i % kCols;
      if (t0 + t >= t_len) continue;
      float o = 0.f;
      for (int s = 0; s <= t; ++s)
        o += att[t * (kC + 1) + s] * vs[s * kCols + j];
      for (int d = 0; d < kDh; ++d) o += rs[t * kRow + d] * S[d * kCols + j];
      out[base + static_cast<size_t>(t0 + t) * row_stride + j0 + j] =
          from_f32<T>(o);
    }
    __syncthreads();
    for (int i = tid; i < kDh * kCols; i += kSerialThreads) {
      const int d = i / kCols, j = i % kCols;
      float s_new = decay[d] * S[i];
      for (int s = 0; s < kC; ++s)
        s_new += ks[s * kRow + d] * vs[s * kCols + j];
      S[i] = s_new;
    }
    __syncthreads();
  }
  for (int i = tid; i < kDh * kCols; i += kSerialThreads) {
    const int d = i / kCols, j = i % kCols;
    state_out[sbase + d * kDh + j0 + j] = S[i];
  }
}

// ---- decode (T = 1) -------------------------------------------------------

constexpr int kDecodeCols = 16;     // value columns of a block
constexpr int kDecodeThreads = 128;  // 4 column quads x 32 row groups

template <typename T, int kDh>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ logw,
              const float* __restrict__ u, const float* state_in, T* out,
              float* state_out, int heads) {
  constexpr int kRowsPer = kDh / 32;  // state rows a thread owns
  constexpr int kSlices = kDh / kDecodeCols;
  __shared__ float part[kDecodeThreads / 32][kDecodeCols];
  const int bh = blockIdx.x / kSlices;
  const int h = bh % heads;
  const int quad = threadIdx.x % 4;   // columns j .. j + 3
  const int group = threadIdx.x / 4;  // rows group + 32 i
  const int j = (blockIdx.x % kSlices) * kDecodeCols + 4 * quad;
  // at T = 1 element d of (b, h) in [B, 1, H, dh] is at bh * dh + d
  const size_t vec = static_cast<size_t>(bh) * kDh;
  float vj[4], o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    vj[e] = to_f32(v[vec + j + e]);
    o[e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int d = group + 32 * i;
    const float rd = to_f32(r[vec + d]);
    const float kd = to_f32(k[vec + d]);
    const float ud = u[h * kDh + d];
    const float wd = expf(logw[vec + d]);
    const size_t at = (vec + d) * kDh + j;
    float4 s = state_in ? *reinterpret_cast<const float4*>(state_in + at)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    float* sv = reinterpret_cast<float*>(&s);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float kv = kd * vj[e];
      o[e] += rd * (sv[e] + ud * kv);
      sv[e] = wd * sv[e] + kv;
    }
    *reinterpret_cast<float4*>(state_out + at) = s;
  }
  // the 8 row groups of a warp sit 4 lanes apart
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] += __shfl_xor_sync(0xffffffffu, o[e], off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) part[warp][4 * lane + e] = o[e];
  }
  __syncthreads();
  if (threadIdx.x < kDecodeCols) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeThreads / 32; ++w) sum += part[w][threadIdx.x];
    out[vec + (blockIdx.x % kSlices) * kDecodeCols + threadIdx.x] =
        from_f32<T>(sum);
  }
}

// ---- bfloat16 prefill: three chunk-parallel phases on mma.sync ---------
// (the chunk shapes, helpers and phases (a) and (b) are in
// csrc/wkv6_chunk.cuh, which the backward shares)

// (c) one block a (chunk, b * H + h); warp w takes the strip of rows
// t = 16 w .. 16 w + 15 of the chunk: o = (r exp2(cumx)) S_c + A V.
template <int kDh>
__global__ void __launch_bounds__(kThreads)
outputs_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u,
               const float* __restrict__ entering, bf16* __restrict__ out,
               int t_len, int heads, int has_state) {
  using L = Smem<kDh>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* rs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = rs + kChunk * L::kB;
  bf16* vs = ks + kChunk * L::kB;
  float* w = reinterpret_cast<float*>(vs + kChunk * L::kB);  // then cum
  float* rx = w + kChunk * L::kF;  // then k weighted to its strip's end
  float* S = rx + kChunk * L::kF;  // [kDh][kF]
  float* tot = S + kDh * L::kF;
  float* us = tot + kStrips * kDh;
  float* fac = us + kDh;            // [kPairs + kStrips][kDh]
  float* dgs = fac + L::kFactors * kDh;  // [kStrips][kSub][kSub]

  const int c = blockIdx.x, n_chunks = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int t0 = c * kChunk;
  const int live = min(kChunk, t_len - t0);
  const size_t row_stride = static_cast<size_t>(heads) * kDh;
  const size_t base =
      (static_cast<size_t>(b) * t_len + t0) * row_stride + h * kDh;
  // the state entering the chunk is zero for chunk 0 without a state in
  const bool inter = c > 0 || has_state;

  load_rows(w, L::kF, logw + base, row_stride, kDh, live);
  cp_async_commit();
  load_rows(rs, L::kB, r + base, row_stride, kDh, live);
  load_rows(ks, L::kB, k + base, row_stride, kDh, live);
  load_rows(vs, L::kB, v + base, row_stride, kDh, live);
  if (inter) {
    const float* src =
        entering + (static_cast<size_t>(bh) * n_chunks + c) * kDh * kDh;
    for (int i = threadIdx.x; i < kDh * kDh / 4; i += blockDim.x) {
      const int d = i / (kDh / 4), j = (i % (kDh / 4)) * 4;
      cp_async16(S + d * L::kF + j, src + d * kDh + j, true);
    }
  }
  cp_async_commit();
  for (int d = threadIdx.x; d < kDh; d += blockDim.x) us[d] = u[h * kDh + d];
  cp_async_wait<1>();
  __syncthreads();
  strip_sums<kDh>(w, rx, tot, L::kF);
  cp_async_wait<0>();
  __syncthreads();

  // shared by the warps: k weighted to its strip's end, k_s exp2(the
  // rest of s's strip), over rx; the decays exp2(strips i + 1 .. w - 1)
  // for the pairs i < w and exp2(strips 0 .. w - 1); the diagonal tiles
  for (int p = threadIdx.x; p < kChunk * kDh; p += blockDim.x) {
    const int t = p / kDh, d = p % kDh;
    rx[t * L::kF + d] =
        __bfloat162float(ks[t * L::kB + d]) * fast_exp2(rx[t * L::kF + d]);
  }
  for (int p = threadIdx.x; p < L::kFactors * kDh; p += blockDim.x) {
    int f = p / kDh, lo = 0, hi = f - L::kPairs;
    if (f < L::kPairs) {  // pair f = w (w - 1) / 2 + i
      hi = 1;
      while (f >= hi) f -= hi++;
      lo = f + 1;
    }
    fac[p] = fast_exp2(span<kDh>(tot, lo, hi, p % kDh));
  }
  // A's diagonal tiles, one thread a (t, s <= t) of a strip: the exact
  // pairwise exponent cumx_t - cum_s for s < t, the bonus u for s = t
  for (int p = threadIdx.x; p < kStrips * L::kTri; p += blockDim.x) {
    const int strip = p / L::kTri;
    int sl = p % L::kTri, tl = 0;
    while (sl > tl) sl -= ++tl;
    const int t = kSub * strip + tl, s = kSub * strip + sl;
    float a = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; d += 2) {
      const float2 rt =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              rs + t * L::kB + d));
      const float2 kv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              ks + s * L::kB + d));
      if (sl < tl) {
        const float2 xt = *reinterpret_cast<const float2*>(
            w + (t - 1) * L::kF + d);
        const float2 cs = *reinterpret_cast<const float2*>(
            w + s * L::kF + d);
        a += rt.x * kv.x * fast_exp2(xt.x - cs.x) +
             rt.y * kv.y * fast_exp2(xt.y - cs.y);
      } else {
        a += rt.x * us[d] * kv.x + rt.y * us[d + 1] * kv.y;
      }
    }
    dgs[(kSub * strip + tl) * kSub + sl] = a;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int ta = kSub * warp + g, tb = ta + 8;  // this lane's rows
  const float* before = fac + (L::kPairs + warp) * kDh;

  float acc[kDh / 8][4];
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // A's tiles below the diagonal: tile 2 i + half holds columns
  // 16 i + 8 half .. of the strips i < warp
  float att[2 * kStrips][4];  // the last two stay unused
#pragma unroll
  for (int n = 0; n < 2 * kStrips; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) att[n][e] = 0.f;

#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    // r_t exp2(cumx_t - cumx_b) at rows ta, tb, b the strip's first
    // row, columns d = 16 kk + 2q (+1, +8, +9)
    float x[4][2];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int t = p & 1 ? tb : ta;
      const int d = 16 * kk + 2 * q + 8 * (p >> 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float cx = t % kSub == 0 ? 0.f : w[(t - 1) * L::kF + d + e];
        x[p][e] = __bfloat162float(rs[t * L::kB + d + e]) * fast_exp2(cx);
      }
    }
    // the entering state's term: (r exp2(cumx)) S_c, both sides pairs
    if (inter) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int d = 16 * kk + 2 * q + 8 * (p >> 1);
        split_bf16(x[p][0] * before[d], x[p][1] * before[d + 1], ah[p],
                   al[p]);
      }
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        const int j = 8 * n + g;
        const int d = 16 * kk + 2 * q;
        uint32_t bh2[2], bl2[2];
        split_bf16(S[d * L::kF + j], S[(d + 1) * L::kF + j], bh2[0], bl2[0]);
        split_bf16(S[(d + 8) * L::kF + j], S[(d + 9) * L::kF + j], bh2[1],
                   bl2[1]);
        mma3(acc[n], ah, al, bh2, bl2);
      }
    }
    // the scores against the strips before: (r_t exp2(cumx_t - cumx_b))
    // . (k_s exp2(the rest of s's strip) exp2(the strips between))
    if (warp > 0) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) split_bf16(x[p][0], x[p][1], ah[p], al[p]);
#pragma unroll
      for (int i = 0; i < kStrips - 1; ++i) {
        if (i >= warp) break;
        const float* dec = fac + (warp * (warp - 1) / 2 + i) * kDh;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = kSub * i + 8 * half + g;  // the column of b
          uint32_t bh2[2], bl2[2];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int d = 16 * kk + 2 * q + 8 * p;
            split_bf16(rx[s * L::kF + d] * dec[d],
                       rx[s * L::kF + d + 1] * dec[d + 1], bh2[p], bl2[p]);
          }
          mma3(att[2 * i + half], ah, al, bh2, bl2);
        }
      }
    }
  }

  // A V: A's tiles are the A operand of m16n8k16 as they stand (tiles
  // 2 i and 2 i + 1 of the accumulator layout are the 16 columns of one
  // k step), as hi and lo pairs; V goes in as bf16
  const float* diag = dgs + kSub * kSub * warp;
#pragma unroll
  for (int i = 0; i < kStrips; ++i) {
    if (i > warp) break;
    float t0f[4], t1f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), col = 2 * q + (e & 1);
      t0f[e] = i < warp ? att[2 * i][e]
                        : (col <= row ? diag[row * kSub + col] : 0.f);
      t1f[e] = i < warp ? att[2 * i + 1][e]
                        : (col + 8 <= row ? diag[row * kSub + col + 8] : 0.f);
    }
    uint32_t ah[4], al[4];
    split_bf16(t0f[0], t0f[1], ah[0], al[0]);
    split_bf16(t0f[2], t0f[3], ah[1], al[1]);
    split_bf16(t1f[0], t1f[1], ah[2], al[2]);
    split_bf16(t1f[2], t1f[3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      const int j = 8 * n + g;
      const int s = kSub * i + 2 * q;
      const uint32_t bv[2] = {
          pack_bf16(vs[s * L::kB + j], vs[(s + 1) * L::kB + j]),
          pack_bf16(vs[(s + 8) * L::kB + j], vs[(s + 9) * L::kB + j])};
      mma(acc[n], ah, bv);
      mma(acc[n], al, bv);
    }
  }

  // each output rounded once
  bf16* oa = out + base + static_cast<size_t>(ta) * row_stride;
  bf16* ob = out + base + static_cast<size_t>(tb) * row_stride;
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n) {
    const int j = 8 * n + 2 * q;
    if (ta < live)
      *reinterpret_cast<__nv_bfloat162*>(oa + j) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (tb < live)
      *reinterpret_cast<__nv_bfloat162*>(ob + j) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

template <int kDh>
int launch_chunked(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* state_in,
                   void* out, float* state_out, float* scratch, int batch,
                   int t_len, int heads, cudaStream_t stream) {
  using L = Smem<kDh>;
  const int nc = static_cast<int>(n_chunks_of(t_len));
  const int bhs = batch * heads;
  if (bhs > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  float* inc = scratch;
  float* decays = scratch + static_cast<size_t>(bhs) * nc * kDh * kDh;
  cudaError_t err = allow_smem(increments_kernel<kDh>, L::kIncBytes);
  if (err == cudaSuccess)
    err = allow_smem(outputs_kernel<kDh>, L::kOutBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  increments_kernel<kDh><<<dim3(nc, bhs), kThreads, L::kIncBytes, stream>>>(
      kb, vb, logw, inc, decays, t_len, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pass_kernel<kDh><<<dim3(kDh * kDh / 4 / kPassThreads, bhs), kPassThreads, 0,
                     stream>>>(state_in, state_out, inc, decays, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  outputs_kernel<kDh><<<dim3(nc, bhs), kThreads, L::kOutBytes, stream>>>(
      static_cast<const bf16*>(r), kb, vb, logw, u, inc,
      static_cast<bf16*>(out), t_len, heads, state_in != nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kDh>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* state_in, void* out,
           float* state_out, float* scratch, int batch, int t_len,
           int heads, cudaStream_t stream) {
  if (t_len == 1) {
    decode_kernel<T, kDh><<<batch * heads * (kDh / kDecodeCols),
                            kDecodeThreads, 0, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), logw, u, state_in, static_cast<T*>(out),
        state_out, heads);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (sizeof(T) == 2) {
    return launch_chunked<kDh>(r, k, v, logw, u, state_in, out, state_out,
                               scratch, batch, t_len, heads, stream);
  } else {
    constexpr int kBytes =
        serial_smem_floats<kDh>() * static_cast<int>(sizeof(float));
    const cudaError_t set = allow_smem(serial_kernel<T, kDh>, kBytes);
    if (set != cudaSuccess) return static_cast<int>(set);
    serial_kernel<T, kDh><<<batch * heads * (kDh / kCols), kSerialThreads,
                            kBytes, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), logw, u, state_in, static_cast<T*>(out),
        state_out, t_len, heads);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* state_in, void* out,
             float* state_out, float* scratch, int batch, int t_len,
             int heads, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(r, k, v, logw, u, state_in, out, state_out,
                           scratch, batch, t_len, heads, s);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, state_in, out, state_out,
                           scratch, batch, t_len, heads, s);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, state_in, out, state_out,
                            scratch, batch, t_len, heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The scratch a call takes, in floats: the chunk increments (then the
// states entering each chunk) [batch, heads, NC, head_dim, head_dim] and
// the chunk decays [batch, heads, NC, head_dim], NC = ceil(t_len / 64),
// for a bfloat16 prefill (t_len > 1); 0 otherwise.
extern "C" long long wkv6_scratch_floats(int batch, int t_len, int heads,
                                         int head_dim, int dtype) {
  if (dtype != 1 || t_len <= 1 || batch <= 0 || heads <= 0) return 0;
  const long long nc = static_cast<long long>(n_chunks_of(t_len));
  return static_cast<long long>(batch) * heads * nc * head_dim *
         (head_dim + 1);
}

// C interface, loaded with ctypes.  r, k, v, out: [batch, t_len, heads,
// head_dim] of one dtype (0 float32, 1 bfloat16); logw: the same shape in
// float32, every entry 0 or less; u: [heads, head_dim] float32; state_in
// (or null for a zero state) and state_out: [batch, heads, head_dim,
// head_dim] float32, k index before v index; scratch: at least
// wkv6_scratch_floats(...) floats (null when that is 0); all contiguous,
// and for a bfloat16 prefill r, k, v and logw 16-byte aligned (cp.async).
// state_in may equal state_out.  t_len must be at least 1.  Launches on
// `stream` (one kernel at T = 1 and in float32, three for a bfloat16
// prefill), does not synchronise, and returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for a head dim other than 32, 64
// or 128, another dtype, or a bfloat16 prefill of more than 65,535
// (batch, head) rows).
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* logw, const void* u, const void* state_in,
                    void* out, void* state_out, void* scratch, int batch,
                    int t_len, int heads, int head_dim, int dtype,
                    void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(logw);
  const auto* up = static_cast<const float*>(u);
  const auto* si = static_cast<const float*>(state_in);
  auto* so = static_cast<float*>(state_out);
  auto* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, up, si, out, so, sc, batch, t_len,
                           heads, head_dim, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, up, si, out, so, sc, batch,
                                   t_len, heads, head_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
