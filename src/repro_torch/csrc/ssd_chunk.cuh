// The chunk-parallel pieces of the Mamba-2 SSD scan that its bf16
// prefill (csrc/ssd.cu) and its backward (csrc/ssd_bwd.cu) share: the
// chunk, strip and head-group shapes, cp.async staging, the bf16 pieces
// of an fp32 operand, mma.sync m16n8k16, the strip-local sums of the log
// decays, and the bodies of two of the prefill's phases: (a) a head's
// state increment over a chunk and (b) the walk over the chunks.  The
// backward runs each twice in one launch: for the states entering each
// chunk, and, the walk reversed, for the adjoints leaving each chunk.
// Each including source is its own library, so everything here sits in
// an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

constexpr int kChunk = 64;   // steps a block of phases (a) and (c) takes
constexpr int kSub = 16;     // rows of a warp's strip
constexpr int kStrips = kChunk / kSub;
constexpr int kThreads = 32 * kStrips;  // one warp a strip
constexpr int kHeads = 8;    // heads a block of phase (c) takes in turn
constexpr int kBufs = 2;     // and the heads' buffers it keeps in flight
constexpr int kIncHeads = kThreads / 32;  // heads of a phase (a) block
constexpr int kPassThreads = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (16 or 4) from global to shared memory, or zeros when !live
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool live) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(live ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(live ? 4 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// rows [0, kChunk) of `width` bf16 each, `row_stride` apart from `src`,
// into shared rows of `pitch`; rows from `live_rows` on are zero
__device__ __forceinline__ void load_rows(bf16* dst, int pitch,
                                          const bf16* src, size_t row_stride,
                                          int width, int live_rows) {
  const int per_row = width / 8;
  for (int i = threadIdx.x; i < kChunk * per_row; i += blockDim.x) {
    const int t = i / per_row, c = (i % per_row) * 8;
    const bool live = t < live_rows;
    cp_async<16>(dst + t * pitch + c,
                 live ? src + static_cast<size_t>(t) * row_stride + c : src,
                 live);
  }
}

// dt of heads h .. h + n_heads - 1 over the chunk, each row's n_heads
// floats side by side (rows `stride` apart), into rows of `pitch`
__device__ __forceinline__ void load_dt(float* dst, int pitch,
                                        const float* src, int stride,
                                        int n_heads, int live_rows) {
  for (int i = threadIdx.x; i < kChunk * n_heads; i += blockDim.x) {
    const int t = i / n_heads, hh = i % n_heads;
    const bool live = t < live_rows;
    cp_async<4>(dst + t * pitch + hh,
                live ? src + static_cast<size_t>(t) * stride + hh : src, live);
  }
}

__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// (x, y) as kP bf16 pieces, each the bf16 rounding of what the pieces
// before it leave: 2 is split_bf16's hi + lo, 3 hi + mid + lo (some 24
// bits of each value)
template <int kP>
__device__ __forceinline__ void split_pieces(float x, float y,
                                             uint32_t* out) {
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    out[p] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 x, bf16 y) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(y)) << 16);
}

// 2^x by the SFU (ex2.approx.ftz: about 2^-22 relative error; results
// below 2^-126 flush to 0, where a decay's product is below fp32's
// range anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a . b: m16n8k16, bf16 in, fp32 sums; fragment layouts as in
// csrc/wkv6.cu (lane 4 g + q: a rows g, g + 8 by columns 2q, 2q + 1,
// 2q + 8, 2q + 9; b rows 2q, 2q + 1, 2q + 8, 2q + 9 of column g; d rows
// g, g + 8 by columns 2q, 2q + 1)
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: the chunk's log decays a_t = dt_t A (log2 units; rows past T
// have dt = 0) as strip-local inclusive prefix sums `cum`, strip-local
// exclusive suffix sums `rx` (the rest of the strip after the row) and
// strip totals `tot`; lane l takes rows l, l + 32, ...; dt of row t at
// dts[t * stride].
__device__ __forceinline__ void strip_sums(const float* dts, int stride,
                                           float a2, float* cum, float* rx,
                                           float* tot) {
  const int lane = threadIdx.x % 32;
  const int sl = lane % kSub;
#pragma unroll
  for (int part = 0; part < kChunk / 32; ++part) {
    const int t = lane + 32 * part;
    const float a = dts[t * stride] * a2;
    float pre = a, suf = a;
#pragma unroll
    for (int off = 1; off < kSub; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, pre, off, kSub);
      const float dn = __shfl_down_sync(0xffffffffu, suf, off, kSub);
      if (sl >= off) pre += up;
      if (sl + off < kSub) suf += dn;
    }
    float after = __shfl_down_sync(0xffffffffu, suf, 1, kSub);
    if (sl == kSub - 1) after = 0.f;
    cum[t] = pre;
    rx[t] = after;
    if (sl == kSub - 1) tot[t / kSub] = pre;
  }
}

// the strips lo .. hi - 1, summed in order
__device__ __forceinline__ float span(const float* tot, int lo, int hi) {
  float s = 0.f;
  for (int i = lo; i < hi; ++i) s += tot[i];
  return s;
}

template <int kDh, int kN>
struct Smem {
  static constexpr int kXB = kDh + 8;  // bf16 row pitches (16 bytes of pad)
  static constexpr int kNB = kN + 8;
  static constexpr int kSF = kN + 4;   // fp32 row pitch of the state
  static constexpr int kIncRow = kIncHeads * kDh + 8;
  // increments_kernel: the group's x, B_, dt; each warp's cum, rx,
  // weights and tot
  static constexpr int kIncBytes = kChunk * kIncRow * 2 + kChunk * kNB * 2 +
                                   kChunk * kIncHeads * 4 +
                                   kIncHeads * (3 * kChunk + kStrips) * 4;
  // outputs_kernel: C_, B_, the group's dt; kBufs buffers of x and the
  // entering state; each warp's cum, rx and tot
  static constexpr int kBufBytes = kChunk * kXB * 2 + kDh * kSF * 4;
  static constexpr int kOutBytes = 2 * kChunk * kNB * 2 +
                                   kChunk * kHeads * 4 + kBufs * kBufBytes +
                                   kStrips * (2 * kChunk + kStrips) * 4;
};

// One warp: a head's state increment over the chunk, all of its dh x N,
// into `out`: X^T (M_ wt), X the head's staged rows (`xh`, rows `pitch`
// apart), M_ the staged [kChunk][kN + 8] B_ or C_ rows and wt a weight a
// row; M_ wt goes in as kPieces bf16 pieces (split_pieces), X as it is.
template <int kDh, int kN, int kPieces>
__device__ __forceinline__ void increment_head(const bf16* xh, int pitch,
                                               const bf16* bs,
                                               const float* wt, float* out) {
  using L = Smem<kDh, kN>;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  // M_ weighted, as B operands (k = s, n = N column), in kPieces pieces
  uint32_t bp[kPieces][kChunk / 16][kN / 8][2];
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int s = 16 * kk + 2 * q + 8 * p, col = 8 * n + g;
        uint32_t pc[kPieces];
        split_pieces<kPieces>(
            __bfloat162float(bs[s * L::kNB + col]) * wt[s],
            __bfloat162float(bs[(s + 1) * L::kNB + col]) * wt[s + 1], pc);
#pragma unroll
        for (int i = 0; i < kPieces; ++i) bp[i][kk][n][p] = pc[i];
      }
#pragma unroll
  for (int m = 0; m < kDh / 16; ++m) {
    float acc[kN / 8][4];
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    const int j0 = 16 * m + g;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      // A = X^T: rows j0, j0 + 8; columns s = 16 kk + 2q (+1, +8, +9)
      uint32_t a[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int j = j0 + 8 * (p & 1);
        const int s = 16 * kk + 2 * q + 8 * (p >> 1);
        a[p] = pack_bf16(xh[s * pitch + j], xh[(s + 1) * pitch + j]);
      }
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int i = 0; i < kPieces; ++i) mma(acc[n], a, bp[i][kk][n]);
    }
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      const int col = 8 * n + 2 * q;
      *reinterpret_cast<float2*>(out + j0 * kN + col) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(out + (j0 + 8) * kN + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// (a) one block a (chunk, b * groups + group of kIncHeads heads), warp
// hh a head: dS = X^T (B_ exp2(total - cum) dt) over the chunk, and the
// chunk's decay exp2(total) into `decays`.  The group's x rows lie side
// by side (kIncHeads dh bf16 a row) and so do its dt.
template <int kDh, int kN, int kPieces = 2>
__global__ void __launch_bounds__(kThreads)
increments_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const bf16* __restrict__ bm,
                  const float* __restrict__ a_neg, float* __restrict__ inc,
                  float* __restrict__ decays, int t_len, int heads) {
  using L = Smem<kDh, kN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kChunk][kIncRow]
  bf16* bs = xs + kChunk * L::kIncRow;
  float* dts = reinterpret_cast<float*>(bs + kChunk * L::kNB);
  float* sums = dts + kChunk * kIncHeads;

  const int c = blockIdx.x, n_chunks = gridDim.x;
  const int groups = (heads + kIncHeads - 1) / kIncHeads;
  const int b = blockIdx.y / groups;
  const int h0 = (blockIdx.y % groups) * kIncHeads;
  const int n_heads = min(kIncHeads, heads - h0);
  const int t0 = c * kChunk;
  const int live = min(kChunk, t_len - t0);
  const size_t row0 = static_cast<size_t>(b) * t_len + t0;

  load_rows(xs, L::kIncRow, x + (row0 * heads + h0) * kDh,
            static_cast<size_t>(heads) * kDh, n_heads * kDh, live);
  load_rows(bs, L::kNB, bm + row0 * kN, kN, kN, live);
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
  // B_s's weight exp2(total - cum_s) dt_s: the rest of the strip, then
  // the strips after it
  for (int s = lane; s < kChunk; s += 32)
    wt[s] = fast_exp2(rx[s] + span(tot, s / kSub + 1, kStrips)) *
            dts[s * kIncHeads + hh];
  const size_t slot = (static_cast<size_t>(b) * heads + h) * n_chunks + c;
  if (lane == 0) decays[slot] = fast_exp2(span(tot, 0, kStrips));
  __syncwarp();
  increment_head<kDh, kN, kPieces>(xs + hh * kDh, L::kIncRow, bs, wt,
                                   inc + slot * kDh * kN);
}

// (b) one thread a float4 of state elements (j, n .. n + 3) of one
// (b, h): the walk over the chunks, from the first (the prefill's
// states) or from the last (kReverse: the backward's adjoints, G_{c-1} =
// exp2(total_c) G_c + dG_c); the state entering each step of the walk
// replaces its increment in `inc`, and the last state goes to state_out
// (skipped when null).
template <int kDh, int kN, bool kReverse>
__device__ __forceinline__ void pass_walk(const float* state_in,
                                          float* state_out, float* inc,
                                          const float* __restrict__ decays,
                                          int n_chunks) {
  constexpr int kElems = kDh * kN;
  constexpr int kAhead = 16;  // chunks whose loads are issued together
  const int bh = blockIdx.y;
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  if (e >= kElems) return;
  const size_t at = static_cast<size_t>(bh) * kElems + e;
  float4 run = state_in ? *reinterpret_cast<const float4*>(state_in + at)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  float* slot = inc + static_cast<size_t>(bh) * n_chunks * kElems + e;
  const float* dec = decays + static_cast<size_t>(bh) * n_chunks;
  for (int c0 = 0; c0 < n_chunks; c0 += kAhead) {
    float4 x[kAhead];
    float a[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int c = kReverse ? n_chunks - 1 - (c0 + i) : c0 + i;
      if (c0 + i < n_chunks) {
        x[i] = *reinterpret_cast<const float4*>(
            slot + static_cast<size_t>(c) * kElems);
        a[i] = dec[c];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int c = kReverse ? n_chunks - 1 - (c0 + i) : c0 + i;
      if (c0 + i < n_chunks) {
        *reinterpret_cast<float4*>(slot + static_cast<size_t>(c) * kElems) =
            run;
        run = make_float4(a[i] * run.x + x[i].x, a[i] * run.y + x[i].y,
                          a[i] * run.z + x[i].z, a[i] * run.w + x[i].w);
      }
    }
  }
  if (state_out) *reinterpret_cast<float4*>(state_out + at) = run;
}

template <int kDh, int kN>
__global__ void __launch_bounds__(kPassThreads)
pass_kernel(const float* state_in, float* state_out, float* inc,
            const float* __restrict__ decays, int n_chunks) {
  pass_walk<kDh, kN, false>(state_in, state_out, inc, decays, n_chunks);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

size_t n_chunks_of(int t_len) { return (t_len + kChunk - 1) / kChunk; }

}  // namespace
