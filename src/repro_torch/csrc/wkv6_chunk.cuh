// The chunk-parallel pieces of the RWKV6 WKV scan that its bf16 prefill
// (csrc/wkv6.cu) and its backward (csrc/wkv6_bwd.cu) share: the chunk
// and strip shapes, cp.async staging, the bf16 pieces of an fp32
// operand, mma.sync m16n8k16, the strip-local sums of the log decays,
// and the bodies of two of the prefill's phases: (a) a chunk's state
// increment and (b) the walk over the chunks.  The backward runs each
// twice in one launch: for the states entering each chunk, and, the walk
// reversed, for the adjoints leaving each chunk.  Each including source
// is its own library, so everything here sits in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

constexpr int kChunk = 64;   // steps a block of phases (a) and (c) takes
constexpr int kSub = 16;     // rows of a warp's strip
constexpr int kStrips = kChunk / kSub;
constexpr int kThreads = 32 * kStrips;  // one warp a strip
constexpr int kPassThreads = 256;  // dh * dh / 4 is a multiple

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !live
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
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

// rows [0, kChunk) of a [T, row_stride] array from `src` (row t0 first)
// into shared rows of `pitch` elements, `width` elements each; rows past
// t_len are zero
template <typename E>
__device__ __forceinline__ void load_rows(E* dst, int pitch, const E* src,
                                          size_t row_stride, int width,
                                          int live_rows) {
  constexpr int kPer = 16 / sizeof(E);
  const int per_row = width / kPer;
  for (int i = threadIdx.x; i < kChunk * per_row; i += blockDim.x) {
    const int t = i / per_row, c = (i % per_row) * kPer;
    const bool live = t < live_rows;
    cp_async16(dst + t * pitch + c,
               live ? src + static_cast<size_t>(t) * row_stride + c : src,
               live);
  }
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi, y - hi),
// the low half holding x
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

// d += a . b: a [16 x 16] bf16 (row), b [16 x 8] bf16 (col), d fp32.
// Lane l = 4 g + q holds a at rows g, g + 8 and columns 2q, 2q + 1,
// 2q + 8, 2q + 9 (registers (g, 2q), (g + 8, 2q), (g, 2q + 8),
// (g + 8, 2q + 8)), b at rows 2q, 2q + 1, 2q + 8, 2q + 9 of column g,
// and d at rows g, g + 8 of columns 2q, 2q + 1.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += (a_hi + a_lo) . (b_hi + b_lo), less lo . lo
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  mma(d, ah, bh);
  mma(d, ah, bl);
  mma(d, al, bh);
}

// The log decays of a chunk, in log2 units, staged in `w` ([kChunk][pitch]
// fp32, rows past T zero), become per strip of kSub rows: `w` the
// inclusive prefix sums inside the strip, `rx` the exclusive suffix sums
// inside the strip (the rest of it after the row), `tot` [kStrips][dh]
// the strip totals.  One thread a (strip, column).
template <int kDh>
__device__ __forceinline__ void strip_sums(float* w, float* rx, float* tot,
                                           int pitch) {
  for (int p = threadIdx.x; p < kStrips * kDh; p += blockDim.x) {
    const int i = p / kDh, d = p % kDh;
    float x[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t)
      x[t] = w[(kSub * i + t) * pitch + d] * kLog2e;
    float run = 0.f;
#pragma unroll
    for (int t = kSub - 1; t >= 0; --t) {
      rx[(kSub * i + t) * pitch + d] = run;
      run += x[t];
    }
    run = 0.f;
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      run += x[t];
      w[(kSub * i + t) * pitch + d] = run;
    }
    tot[i * kDh + d] = run;
  }
}

// the strips lo .. hi - 1 of column d, summed in order
template <int kDh>
__device__ __forceinline__ float span(const float* tot, int lo, int hi,
                                      int d) {
  float s = 0.f;
  for (int i = lo; i < hi; ++i) s += tot[i * kDh + d];
  return s;
}

template <int kDh>
struct Smem {
  static constexpr int kB = kDh + 8;  // bf16 row pitch (16 bytes of pad)
  static constexpr int kF = kDh + 4;  // fp32 row pitch
  // increments_kernel: k, v; w, rx; tot
  static constexpr int kIncBytes =
      2 * kChunk * kB * 2 + 2 * kChunk * kF * 4 + kStrips * kDh * 4;
  // outputs_kernel: r, k, v; w, rx; the entering state; tot; u; the
  // decay factors of the strip pairs i < w and of the strips before w;
  // the diagonal tiles
  static constexpr int kPairs = kStrips * (kStrips - 1) / 2;
  static constexpr int kFactors = kPairs + kStrips;
  static constexpr int kTri = kSub * (kSub + 1) / 2;  // s <= t in a tile
  static constexpr int kOutBytes =
      3 * kChunk * kB * 2 + 2 * kChunk * kF * 4 + kDh * kF * 4 +
      kStrips * kDh * 4 + kDh * 4 + kFactors * kDh * 4 +
      kStrips * kSub * kSub * 4;
};

// A chunk's state increment from its staged rows, into `out`
// ([kDh][kDh] fp32): warp m takes rows 16 m .. 16 m + 15 (the k index),
// all dh columns, out = (a exp2(ex))^T b over the chunk.  a exp2(ex)
// goes in as kPieces bf16 pieces (split_pieces), b as it is.
template <int kDh, int kPieces>
__device__ __forceinline__ void increment_rows(const bf16* as, const bf16* bs,
                                               const float* ex, float* out) {
  using L = Smem<kDh>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  for (int m = warp; m < kDh / 16; m += kStrips) {
    float acc[kDh / 8][4];
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    const int d0 = 16 * m + g;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      // A = (a exp2(ex))^T: rows d0, d0 + 8; columns s = 16 kk + 2q (+1,
      // +8, +9)
      uint32_t ap[kPieces][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int d = d0 + 8 * (p & 1);
        const int s = 16 * kk + 2 * q + 8 * (p >> 1);
        const float x0 = __bfloat162float(as[s * L::kB + d]) *
                         fast_exp2(ex[s * L::kF + d]);
        const float x1 = __bfloat162float(as[(s + 1) * L::kB + d]) *
                         fast_exp2(ex[(s + 1) * L::kF + d]);
        uint32_t pc[kPieces];
        split_pieces<kPieces>(x0, x1, pc);
#pragma unroll
        for (int i = 0; i < kPieces; ++i) ap[i][p] = pc[i];
      }
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        const int j = 8 * n + g;
        const int s = 16 * kk + 2 * q;
        const uint32_t bv[2] = {
            pack_bf16(bs[s * L::kB + j], bs[(s + 1) * L::kB + j]),
            pack_bf16(bs[(s + 8) * L::kB + j], bs[(s + 9) * L::kB + j])};
#pragma unroll
        for (int i = 0; i < kPieces; ++i) mma(acc[n], ap[i], bv);
      }
    }
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      const int j = 8 * n + 2 * q;
      *reinterpret_cast<float2*>(out + d0 * kDh + j) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(out + (d0 + 8) * kDh + j) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// (a) one block a (chunk, b * H + h): the chunk's state increment dS =
// K~^T V, K~ = k exp2(total - cum), and its decay exp2(total) into
// `decays`; K~ in kPieces bf16 pieces.
template <int kDh, int kPieces = 2>
__global__ void __launch_bounds__(kThreads)
increments_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const float* __restrict__ logw, float* __restrict__ inc,
                  float* __restrict__ decays, int t_len, int heads) {
  using L = Smem<kDh>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kChunk * L::kB;
  float* w = reinterpret_cast<float*>(vs + kChunk * L::kB);
  float* rx = w + kChunk * L::kF;
  float* tot = rx + kChunk * L::kF;

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
  load_rows(ks, L::kB, k + base, row_stride, kDh, live);
  load_rows(vs, L::kB, v + base, row_stride, kDh, live);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  strip_sums<kDh>(w, rx, tot, L::kF);
  __syncthreads();
  // rx becomes the exponent total - cum_s: the rest of the strip, then
  // the strips after it; the decay is exp2 of the chunk's total
  for (int p = threadIdx.x; p < kChunk * kDh; p += blockDim.x) {
    const int t = p / kDh, d = p % kDh;
    rx[t * L::kF + d] += span<kDh>(tot, t / kSub + 1, kStrips, d);
  }
  const size_t slot = static_cast<size_t>(bh) * n_chunks + c;
  for (int d = threadIdx.x; d < kDh; d += blockDim.x)
    decays[slot * kDh + d] = fast_exp2(span<kDh>(tot, 0, kStrips, d));
  cp_async_wait<0>();
  __syncthreads();
  increment_rows<kDh, kPieces>(ks, vs, rx, inc + slot * kDh * kDh);
}

// (b) one thread a float4 of state elements (d, j .. j + 3) of one
// (b, h): the walk over the chunks, from the first (the prefill's states)
// or from the last (kReverse: the backward's adjoints, G_{c-1} =
// exp2(total_c) G_c + dG_c); the state entering each step of the walk
// replaces its increment in `inc`, and the last state goes to state_out
// (skipped when null).
template <int kDh, bool kReverse>
__device__ __forceinline__ void pass_walk(const float* state_in,
                                          float* state_out, float* inc,
                                          const float* __restrict__ decays,
                                          int n_chunks) {
  constexpr int kElems = kDh * kDh;
  constexpr int kAhead = 16;  // chunks whose loads are issued together
  const int bh = blockIdx.y;
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  const int d = e / kDh;
  const size_t at = static_cast<size_t>(bh) * kElems + e;
  float4 run = state_in ? *reinterpret_cast<const float4*>(state_in + at)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  float* slot = inc + static_cast<size_t>(bh) * n_chunks * kElems + e;
  const float* dec = decays + static_cast<size_t>(bh) * n_chunks * kDh + d;
  for (int c0 = 0; c0 < n_chunks; c0 += kAhead) {
    float4 x[kAhead];
    float a[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int c = kReverse ? n_chunks - 1 - (c0 + i) : c0 + i;
      if (c0 + i < n_chunks) {
        x[i] = *reinterpret_cast<const float4*>(
            slot + static_cast<size_t>(c) * kElems);
        a[i] = dec[static_cast<size_t>(c) * kDh];
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

template <int kDh>
__global__ void __launch_bounds__(kPassThreads)
pass_kernel(const float* state_in, float* state_out, float* inc,
            const float* __restrict__ decays, int n_chunks) {
  pass_walk<kDh, false>(state_in, state_out, inc, decays, n_chunks);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

size_t n_chunks_of(int t_len) { return (t_len + kChunk - 1) / kChunk; }

}  // namespace
