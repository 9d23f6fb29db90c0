// Mamba-2 SSD scan (state-space duality, chunked form), with the state
// carried in and out.
//
// Replaces, in the JAX package, src/repro/kernels/mamba_scan/kernel.py
// ssd (_ssd_kernel).  The TPU form takes [B*H, T, dh] rows with B_ and
// C_ copied into every head (its ops.py ssd_heads broadcasts them),
// walks a (row, chunk) grid whose chunk axis is sequential with the
// [dh, N] state in VMEM scratch, starts from a zero state, returns no
// state and asserts T % chunk == 0.  Here x is read as [B, T, H, dh]
// and B_, C_ as [B, T, N], the layouts the model produces: every head
// of a batch row reads the same B_ and C_ rows, as the attention kernels
// read a shared kv head under GQA.  The state comes in (or is zero) and
// goes out, and the ragged last chunk is masked here, so T takes any
// value.
//
// What it computes, per (b, h), with the [dh, N] state S and A < 0:
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T;   y_t = S_t C_t
// all in fp32, y stored in x's dtype, the final S in fp32.  Inside a
// chunk, with cum_t the inclusive prefix sum of dt A and total its last
// value:
//   y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//         + exp(cum_t) S_in C_t
//   S_out = exp(total) S_in + sum_s exp(total - cum_s) dt_s x_s B_s^T
//
// What bounds it on an H100.  At Jamba's full width (B = 1, T = 4096,
// H = 256, dh = 64, N = 16, bf16) the function moves about 272 MB (x and
// y in bf16, dt in fp32, B_ and C_, the state) and its state terms are
// 4 dh N FLOPs a token and head, 4.3 GFLOP: about 0.08 ms, bound by
// bytes.  A chunk-serial walk (one block a (b, h) walking 128
// chunks of 32 one after another, every product on the fp32 CUDA cores,
// C_t . B_s recomputed for each of the 256 heads) is a latency chain of
// some 10 us a chunk, 16.6x the bound.  At decode (T = 1) the bytes are
// the state in and out, 2.1 MB (0.6 us); the floor is the kernel's fixed
// cost.
//
// The design, picked from t_len and the dtype inside the C entry point:
//
// bfloat16 prefill (T > 1): chunk-parallel, three kernels over chunks of
// kChunk = 64 steps, each a warp's strips of kSub = 16 rows.
//  (a) increments_kernel, one block a (b, chunk, 4 heads), all at once,
//      a warp a head: the chunk's state increment dS = X^T (B_ exp(total
//      - cum) dt) and its decay exp(total), into a scratch of
//      [B, H, NC, dh, N] (and [B, H, NC]) that the wrapper allocates.
//      The group's x rows and dt lie side by side in memory, so a block
//      reads rows of 512 bytes and its dt in whole sectors.
//  (b) pass_kernel, one thread a float4 of state elements: the short
//      sequential walk over the NC chunks, S_{c+1} = exp(total_c) S_c +
//      dS_c, with 16 chunks' loads in flight, which writes the state
//      entering each chunk over its increment and the final state.
//  (c) outputs_kernel, one block a (b, chunk, kHeads = 8 heads): each
//      output once, y = exp(cum_t) C_t S_c^T + ((C B^T) * L * dt) X,
//      rounded once to bf16, with L the decay of s <= t only.  C B^T,
//      which every head of a batch row shares, is formed from the block's
//      one copy of C_ and B_ (two exact bf16 products a k step), and the
//      group's dt is loaded once; each head's x tile and entering state
//      are loaded by cp.async into one of two buffers while the head
//      before computes.
//  The chunk length decides the scratch: at Jamba's T = 4096 it is 67 MB
//  at kChunk = 64 and 33.5 MB at 128, which would fit the 50 MB L2 beside
//  nothing else; the kernels stream 402 MB of x and y past it, so
//  neither keeps it there.  Measured on an H100 (PERF.md), 128 cut
//  the pass from 60 to 24 us but made the outputs kernel 1.6x slower
//  (twice the pairwise terms a row, eight strips a block): 64 it is.  So are 8 heads
//  a block (4 and 16 no faster) and two buffers (a third slowed it).
//  Every product of (a) and (c) runs on the tensor cores (mma.sync
//  m16n8k16, fp32 sums; N = 8 pads the k axis with zeros).  x, B_, C_
//  arrive in bf16 and go in as they are; an operand computed in fp32
//  (B_ weighted to the chunk's end, the G = (C B^T) * L * dt matrix, the
//  state) goes in as a bf16 pair hi = bf16(a), lo = bf16(a - hi), two
//  products.  A single bf16 rounding of those operands breaks
//  chip_smoke.py's limits (tests/test_torch_scan_design.py); the pairs
//  hold them.  Decays are 2^x by the SFU (ex2.approx).
//
//  What bounds it now: bytes, at about 2 TB/s.  The three phases move
//  some 670 MB (x twice, y once, the scratch four times), 2.4x the
//  function's own; the outputs kernel's loads, prefix sums and stores
//  alone take 171 of its 192 us.
//
// float32 prefill: the chunk-serial kernel on the fp32 CUDA cores
// (serial_kernel), so that fp32 callers keep exact fp32 products.
//
// decode (T = 1), either dtype: decode_kernel, one thread a float4 of a
// state row, no chunk staging: it reads its x, dt, A and B_, C_ entries,
// writes the new state, and the row's N / 4 threads sum y by shuffles.
// Mamba's decode hands it fp32 x, B_ and C_; the kernel is the same.
//
// No overflow.  The Pallas kernel exponentiates cum_t - cum_s for every
// (t, s) and masks s > t afterwards; for s > t that exponent is
// positive and reaches hundreds over a long chunk.  Here only s <= t is
// computed, and every exponent is a sum of log decays, 0 or less, each
// formed from its own terms: strip-local prefix and suffix sums and
// strip totals added in order.  The one difference is inside a strip,
// cum_t - cum_s of two sums over at most 16 steps.  Decays are taken in
// log2 units.
//
// Aliasing: state_in may equal state_out.  Only decode_kernel, the
// serial kernel and pass_kernel read state_in, and in each the thread
// (or block) that writes an element of state_out has read it first;
// outputs_kernel reads the entering states from the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_chunk.cuh"

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

constexpr int kSerialChunk = 32;  // timesteps per chunk: one warp's lanes
constexpr int kSerialThreads = 256;

template <int kDh, int kN>
constexpr int serial_smem_floats() {
  return kDh * (kN + 1)                       // state S[j][n]
         + kSerialChunk * kDh                 // x
         + 3 * kSerialChunk * (kN + 1)        // B_, C_, B_ weighted
         + kSerialChunk * (kSerialChunk + 1)  // G
         + 4 * kSerialChunk                   // dt, cum, exp(cum), weight
         + 1;                                 // exp(total)
}

// One block per (batch, head) walks the chunks of 32 in order: x, B_,
// C_ and dt staged as fp32, the state's [dh, N] slice in shared memory,
// warp 0's shuffles form the prefix sums, one thread a (t, s) pair the
// decay-masked score G, then each thread owns outputs (t, j) and state
// elements (j, n).
template <typename T, int kDh, int kN>
__global__ void __launch_bounds__(kSerialThreads)
serial_kernel(const T* __restrict__ x, const float* __restrict__ dt,
              const T* __restrict__ bm, const T* __restrict__ cm,
              const float* __restrict__ a_neg, const float* state_in, T* y,
              float* state_out, int t_len, int heads) {
  constexpr int kC = kSerialChunk;
  constexpr int kNRow = kN + 1;
  constexpr int kGRow = kC + 1;
  extern __shared__ float smem[];
  float* S = smem;                         // [kDh][kNRow]
  float* xs = S + kDh * kNRow;             // [kC][kDh]
  float* bs = xs + kC * kDh;               // [kC][kNRow]
  float* cs = bs + kC * kNRow;
  float* bw = cs + kC * kNRow;             // B_s exp(total - cum_s) dt_s
  float* g = bw + kC * kNRow;              // [kC][kGRow]
  float* dts = g + kC * kGRow;             // [kC]
  float* cum = dts + kC;
  float* ecum = cum + kC;
  float* wend = ecum + kC;
  float* etot = wend + kC;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const float a = a_neg[h];
  // element (t, j) of x [B, T, H, dh] is at xbase + t * row_stride + j;
  // element (t, n) of B_, C_ [B, T, N] at nbase + t * kN + n; dt
  // [B, T, H] at dbase + t * heads
  const size_t row_stride = static_cast<size_t>(heads) * kDh;
  const size_t xbase = (static_cast<size_t>(b) * t_len * heads + h) * kDh;
  const size_t nbase = static_cast<size_t>(b) * t_len * kN;
  const size_t dbase = static_cast<size_t>(b) * t_len * heads + h;
  const size_t sbase = static_cast<size_t>(bh) * kDh * kN;

  for (int i = tid; i < kDh * kN; i += kSerialThreads) {
    const int j = i / kN, n = i % kN;
    S[j * kNRow + n] = state_in ? state_in[sbase + i] : 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += kC) {
    const int live = min(kC, t_len - t0);
    // rows past T are x = B_ = C_ = 0 and dt = 0: they add nothing
    for (int i = tid; i < kC * kDh; i += kSerialThreads) {
      const int t = i / kDh, j = i % kDh;
      xs[i] = t < live
                  ? to_f32(x[xbase + static_cast<size_t>(t0 + t) * row_stride +
                             j])
                  : 0.f;
    }
    for (int i = tid; i < kC * kN; i += kSerialThreads) {
      const int t = i / kN, n = i % kN;
      const size_t at = nbase + static_cast<size_t>(t0) * kN + i;
      bs[t * kNRow + n] = t < live ? to_f32(bm[at]) : 0.f;
      cs[t * kNRow + n] = t < live ? to_f32(cm[at]) : 0.f;
    }
    if (tid < kC)
      dts[tid] = tid < live ? dt[dbase + static_cast<size_t>(t0 + tid) * heads]
                            : 0.f;
    __syncthreads();
    if (tid < 32) {
      float run = dts[tid] * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += up;
      }
      const float total = __shfl_sync(0xffffffffu, run, 31);
      cum[tid] = run;
      ecum[tid] = expf(run);
      wend[tid] = expf(total - run) * dts[tid];
      if (tid == 0) *etot = expf(total);
    }
    __syncthreads();
    for (int i = tid; i < kC * kC; i += kSerialThreads) {
      const int t = i / kC, s = i % kC;
      if (t >= live || s > t) continue;
      float dot = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) dot += cs[t * kNRow + n] * bs[s * kNRow + n];
      g[t * kGRow + s] = dot * expf(cum[t] - cum[s]) * dts[s];
    }
    for (int i = tid; i < kC * kN; i += kSerialThreads) {
      const int s = i / kN, n = i % kN;
      bw[s * kNRow + n] = bs[s * kNRow + n] * wend[s];
    }
    __syncthreads();
    for (int i = tid; i < kC * kDh; i += kSerialThreads) {
      const int t = i / kDh, j = i % kDh;
      if (t >= live) continue;
      float o = 0.f;
      for (int s = 0; s <= t; ++s) o += g[t * kGRow + s] * xs[s * kDh + j];
      float inter = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) inter += cs[t * kNRow + n] * S[j * kNRow + n];
      y[xbase + static_cast<size_t>(t0 + t) * row_stride + j] =
          from_f32<T>(o + ecum[t] * inter);
    }
    __syncthreads();
    const float decay = *etot;
    for (int i = tid; i < kDh * kN; i += kSerialThreads) {
      const int j = i / kN, n = i % kN;
      float s_new = decay * S[j * kNRow + n];
      for (int s = 0; s < live; ++s) s_new += xs[s * kDh + j] * bw[s * kNRow + n];
      S[j * kNRow + n] = s_new;
    }
    __syncthreads();
  }
  for (int i = tid; i < kDh * kN; i += kSerialThreads) {
    const int j = i / kN, n = i % kN;
    state_out[sbase + i] = S[j * kNRow + n];
  }
}

// ---- decode (T = 1) -------------------------------------------------------

constexpr int kDecodeThreads = 128;

// thread i owns elements 4 i .. 4 i + 3 of the state [B, H, dh, N]
template <typename T, int kDh, int kN>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const T* __restrict__ x, const float* __restrict__ dt,
              const T* __restrict__ bm, const T* __restrict__ cm,
              const float* __restrict__ a_neg, const float* state_in, T* y,
              float* state_out, int heads, int quads) {
  constexpr int kQ = kN / 4;  // threads a state row
  const int i = blockIdx.x * kDecodeThreads + threadIdx.x;
  if (i >= quads) return;  // whole warps: quads is a multiple of 32
  const int row = i / kQ;  // (b * H + h) * dh + j
  const int n0 = (i % kQ) * 4;
  const int bh = row / kDh;
  const int b = bh / heads, h = bh % heads;
  const float dtv = dt[bh];  // at T = 1, dt [B, 1, H] holds (b, h) at bh
  const float decay = expf(dtv * a_neg[h]);
  const float xdt = to_f32(x[row]) * dtv;
  const size_t at = static_cast<size_t>(row) * kN + n0;
  float4 s = state_in ? *reinterpret_cast<const float4*>(state_in + at)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  float* sv = reinterpret_cast<float*>(&s);
  float part = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sv[e] = decay * sv[e] + xdt * to_f32(bm[b * kN + n0 + e]);
    part += sv[e] * to_f32(cm[b * kN + n0 + e]);
  }
  *reinterpret_cast<float4*>(state_out + at) = s;
#pragma unroll
  for (int off = 1; off < kQ; off <<= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (n0 == 0) y[row] = from_f32<T>(part);
}

// ---- bfloat16 prefill: three chunk-parallel phases on mma.sync ---------
// (the chunk shapes, helpers and phases (a) and (b) are in
// csrc/ssd_chunk.cuh, which the backward shares)

// (c) one block a (chunk, b * groups + head group); warp w takes the
// strip of rows t = 16 w .. 16 w + 15 for each head of the group in turn.
template <int kDh, int kN>
__global__ void __launch_bounds__(kThreads)
outputs_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const bf16* __restrict__ bm, const bf16* __restrict__ cm,
               const float* __restrict__ a_neg,
               const float* __restrict__ entering, bf16* __restrict__ y,
               int t_len, int heads, int has_state) {
  using L = Smem<kDh, kN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = cs + kChunk * L::kNB;
  float* dts = reinterpret_cast<float*>(bs + kChunk * L::kNB);  // [t][hh]
  uint8_t* bufs = reinterpret_cast<uint8_t*>(dts + kChunk * kHeads);
  float* sums = reinterpret_cast<float*>(bufs + kBufs * L::kBufBytes);
  auto xbuf = [&](int i) {
    return reinterpret_cast<bf16*>(bufs + i * L::kBufBytes);
  };
  auto sbuf = [&](int i) {
    return reinterpret_cast<float*>(bufs + i * L::kBufBytes +
                                    kChunk * L::kXB * 2);
  };

  const int c = blockIdx.x, n_chunks = gridDim.x;
  const int groups = (heads + kHeads - 1) / kHeads;
  const int b = blockIdx.y / groups;
  const int h0 = (blockIdx.y % groups) * kHeads;
  const int n_heads = min(kHeads, heads - h0);
  const int t0 = c * kChunk;
  const int live = min(kChunk, t_len - t0);
  const size_t row0 = static_cast<size_t>(b) * t_len + t0;
  const size_t row_stride = static_cast<size_t>(heads) * kDh;
  // the state entering the chunk is zero for chunk 0 without a state in
  const bool inter = c > 0 || has_state;

  auto load_head = [&](int hh, int i) {
    const int h = h0 + hh;
    load_rows(xbuf(i), L::kXB, x + (row0 * heads + h) * kDh, row_stride,
              kDh, live);
    if (inter) {
      const float* src = entering + ((static_cast<size_t>(b) * heads + h) *
                                         n_chunks + c) * kDh * kN;
      float* dst = sbuf(i);
      for (int p = threadIdx.x; p < kDh * kN / 4; p += blockDim.x) {
        const int j = p / (kN / 4), n = (p % (kN / 4)) * 4;
        cp_async<16>(dst + j * L::kSF + n, src + j * kN + n, true);
      }
    }
  };
  load_rows(cs, L::kNB, cm + row0 * kN, kN, kN, live);
  load_rows(bs, L::kNB, bm + row0 * kN, kN, kN, live);
  load_dt(dts, kHeads, dt + row0 * heads + h0, heads, n_heads, live);
  // a ring of kBufs buffers: head hh in buffer hh % kBufs, loaded
  // kBufs - 1 heads ahead; a group is committed for every head slot, empty
  // past the last head, so that waiting for all but the newest kBufs - 1
  // groups always waits for head hh
  load_head(0, 0);
  cp_async_commit();
#pragma unroll
  for (int ahead = 1; ahead < kBufs - 1; ++ahead) {
    if (ahead < n_heads) load_head(ahead, ahead);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int ta = kSub * warp + g, tb = ta + 8;  // this lane's rows
  float* cum = sums + warp * (2 * kChunk + kStrips);  // this warp's own
  float* rx = cum + kChunk;
  float* tot = rx + kChunk;

  uint32_t cfr[4];  // C_ rows ta, tb as an A operand (k = n)

  for (int hh = 0; hh < n_heads; ++hh) {
    const int i = hh % kBufs;
    __syncthreads();  // head hh - 1's buffer is done with
    if (hh + kBufs - 1 < n_heads)
      load_head(hh + kBufs - 1, (hh + kBufs - 1) % kBufs);
    cp_async_commit();
    cp_async_wait<kBufs - 1>();
    __syncthreads();
    if (hh == 0) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int t = p & 1 ? tb : ta;
        const int n = 2 * q + 8 * (p >> 1);
        cfr[p] = n < kN ? pack_bf16(cs[t * L::kNB + n],
                                    cs[t * L::kNB + n + 1])
                        : 0u;
      }
    }
    const int h = h0 + hh;
    const float* dth = dts + hh;  // row t at dth[t * kHeads]
    strip_sums(dth, kHeads, a_neg[h] * kLog2e, cum, rx, tot);
    __syncwarp();

    float acc[kDh / 8][4];
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // exp2(cum_t) C_t S_c^T, the state as a hi and lo pair
    if (inter) {
      const float* S = sbuf(i);
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        const int j = 8 * n + g;
        uint32_t bh2[2], bl2[2];
        split_bf16(S[j * L::kSF + 2 * q], S[j * L::kSF + 2 * q + 1], bh2[0],
                   bl2[0]);
        if (kN > 8) {
          split_bf16(S[j * L::kSF + 2 * q + 8], S[j * L::kSF + 2 * q + 9],
                     bh2[1], bl2[1]);
        } else {
          bh2[1] = bl2[1] = 0u;
        }
        mma(acc[n], cfr, bh2);
        mma(acc[n], cfr, bl2);
      }
      const float pre = span(tot, 0, warp);
      const float ea = fast_exp2(pre + cum[ta]), eb = fast_exp2(pre + cum[tb]);
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        acc[n][0] *= ea;
        acc[n][1] *= ea;
        acc[n][2] *= eb;
        acc[n][3] *= eb;
      }
    }

    // ((C B^T) * L * dt) X: G's k step ks covers columns 16 ks .. 16 ks
    // + 15, two tiles of C B^T (exact: bf16 products, fp32 sums) in the
    // A operand's layout
    const bf16* xs = xbuf(i);
#pragma unroll
    for (int ks = 0; ks < kStrips; ++ks) {
      if (ks > warp) break;
      float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = kSub * ks + 8 * half + g;
        const uint32_t bfr[2] = {
            pack_bf16(bs[s * L::kNB + 2 * q], bs[s * L::kNB + 2 * q + 1]),
            kN > 8 ? pack_bf16(bs[s * L::kNB + 2 * q + 8],
                               bs[s * L::kNB + 2 * q + 9])
                   : 0u};
        mma(cb[half], cfr, bfr);
      }
      const float between = ks < warp ? span(tot, ks + 1, warp) : 0.f;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int t = p & 1 ? tb : ta;
        const float* cbt = cb[p >> 1];
        float gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = kSub * ks + 2 * q + 8 * (p >> 1) + e;
          float ex;
          if (ks < warp)
            ex = cum[t] + rx[s] + between;
          else
            ex = s <= t ? cum[t] - cum[s] : -INFINITY;
          gv[e] = s <= t ? cbt[2 * (p & 1) + e] * fast_exp2(ex) *
                               dth[s * kHeads]
                         : 0.f;
        }
        split_bf16(gv[0], gv[1], ah[p], al[p]);
      }
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        const int j = 8 * n + g;
        const int s = kSub * ks + 2 * q;
        const uint32_t bx[2] = {
            pack_bf16(xs[s * L::kXB + j], xs[(s + 1) * L::kXB + j]),
            pack_bf16(xs[(s + 8) * L::kXB + j], xs[(s + 9) * L::kXB + j])};
        mma(acc[n], ah, bx);
        mma(acc[n], al, bx);
      }
    }

    // each output rounded once
    bf16* ya = y + ((row0 + ta) * heads + h) * kDh;
    bf16* yb = y + ((row0 + tb) * heads + h) * kDh;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      const int j = 8 * n + 2 * q;
      if (ta < live)
        *reinterpret_cast<__nv_bfloat162*>(ya + j) =
            __floats2bfloat162_rn(acc[n][0], acc[n][1]);
      if (tb < live)
        *reinterpret_cast<__nv_bfloat162*>(yb + j) =
            __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
  }
}

template <int kDh, int kN>
int launch_chunked(const void* x, const float* dt, const void* bm,
                   const void* cm, const float* a_neg,
                   const float* state_in, void* y, float* state_out,
                   float* scratch, int batch, int t_len, int heads,
                   cudaStream_t stream) {
  using L = Smem<kDh, kN>;
  const int nc = static_cast<int>(n_chunks_of(t_len));
  const int bhs = batch * heads;
  const int groups = (heads + kHeads - 1) / kHeads;
  if (bhs > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  float* inc = scratch;
  float* decays = scratch + static_cast<size_t>(bhs) * nc * kDh * kN;
  cudaError_t err = allow_smem(increments_kernel<kDh, kN>, L::kIncBytes);
  if (err == cudaSuccess)
    err = allow_smem(outputs_kernel<kDh, kN>, L::kOutBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* bb = static_cast<const bf16*>(bm);
  increments_kernel<kDh, kN>
      <<<dim3(nc, batch * ((heads + kIncHeads - 1) / kIncHeads)), kThreads,
         L::kIncBytes, stream>>>(xb, dt, bb, a_neg, inc, decays, t_len,
                                 heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pass_kernel<kDh, kN>
      <<<dim3((kDh * kN / 4 + kPassThreads - 1) / kPassThreads, bhs),
         kPassThreads, 0, stream>>>(state_in, state_out, inc, decays, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  outputs_kernel<kDh, kN>
      <<<dim3(nc, batch * groups), kThreads, L::kOutBytes, stream>>>(
          xb, dt, bb, static_cast<const bf16*>(cm), a_neg, inc,
          static_cast<bf16*>(y), t_len, heads, state_in != nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kDh, int kN>
int launch(const void* x, const float* dt, const void* bm, const void* cm,
           const float* a_neg, const float* state_in, void* y,
           float* state_out, float* scratch, int batch, int t_len,
           int heads, cudaStream_t stream) {
  if (t_len == 1) {
    const int quads = batch * heads * kDh * kN / 4;
    decode_kernel<T, kDh, kN>
        <<<(quads + kDecodeThreads - 1) / kDecodeThreads, kDecodeThreads, 0,
           stream>>>(static_cast<const T*>(x), dt, static_cast<const T*>(bm),
                     static_cast<const T*>(cm), a_neg, state_in,
                     static_cast<T*>(y), state_out, heads, quads);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (sizeof(T) == 2) {
    return launch_chunked<kDh, kN>(x, dt, bm, cm, a_neg, state_in, y,
                                   state_out, scratch, batch, t_len, heads,
                                   stream);
  } else {
    constexpr int kBytes =
        serial_smem_floats<kDh, kN>() * static_cast<int>(sizeof(float));
    const cudaError_t set = allow_smem(serial_kernel<T, kDh, kN>, kBytes);
    if (set != cudaSuccess) return static_cast<int>(set);
    serial_kernel<T, kDh, kN><<<batch * heads, kSerialThreads, kBytes,
                                stream>>>(
        static_cast<const T*>(x), dt, static_cast<const T*>(bm),
        static_cast<const T*>(cm), a_neg, state_in, static_cast<T*>(y),
        state_out, t_len, heads);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int kN>
int by_head_dim(const void* x, const float* dt, const void* bm,
                const void* cm, const float* a_neg, const float* state_in,
                void* y, float* state_out, float* scratch, int batch,
                int t_len, int heads, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32:
      return launch<T, 32, kN>(x, dt, bm, cm, a_neg, state_in, y, state_out,
                               scratch, batch, t_len, heads, s);
    case 64:
      return launch<T, 64, kN>(x, dt, bm, cm, a_neg, state_in, y, state_out,
                               scratch, batch, t_len, heads, s);
    case 128:
      return launch<T, 128, kN>(x, dt, bm, cm, a_neg, state_in, y,
                                state_out, scratch, batch, t_len, heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const float* dt, const void* bm, const void* cm,
             const float* a_neg, const float* state_in, void* y,
             float* state_out, float* scratch, int batch, int t_len,
             int heads, int head_dim, int d_state, cudaStream_t s) {
  switch (d_state) {
    case 8:
      return by_head_dim<T, 8>(x, dt, bm, cm, a_neg, state_in, y, state_out,
                               scratch, batch, t_len, heads, head_dim, s);
    case 16:
      return by_head_dim<T, 16>(x, dt, bm, cm, a_neg, state_in, y,
                                state_out, scratch, batch, t_len, heads,
                                head_dim, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The scratch a call takes, in floats: the chunk increments (then the
// states entering each chunk) [batch, heads, NC, head_dim, d_state] and
// the chunk decays [batch, heads, NC], NC = ceil(t_len / 64), for a
// bfloat16 prefill (t_len > 1); 0 otherwise.
extern "C" long long ssd_scratch_floats(int batch, int t_len, int heads,
                                        int head_dim, int d_state,
                                        int dtype) {
  if (dtype != 1 || t_len <= 1 || batch <= 0 || heads <= 0) return 0;
  const long long nc = static_cast<long long>(n_chunks_of(t_len));
  return static_cast<long long>(batch) * heads * nc *
         (static_cast<long long>(head_dim) * d_state + 1);
}

// C interface, loaded with ctypes.  x, y: [batch, t_len, heads, head_dim]
// of one dtype (0 float32, 1 bfloat16); b, c: [batch, t_len, d_state] of
// that dtype, shared by every head; dt: [batch, t_len, heads] float32,
// each entry 0 or more; a: [heads] float32, each below 0; state_in (or
// null for a zero state) and state_out: [batch, heads, head_dim, d_state]
// float32; scratch: at least ssd_scratch_floats(...) floats (null when
// that is 0); all contiguous, and for a bfloat16 prefill x, b, c and dt
// 16-byte aligned (cp.async).  state_in may equal state_out.  t_len must
// be at least 1.  Launches on `stream` (one kernel at T = 1 and in
// float32, three for a bfloat16 prefill), does not synchronise, and
// returns cudaGetLastError() after the launches (cudaErrorInvalidValue
// for a head dim other than 32, 64 or 128, a d_state other than 8 or 16,
// another dtype, or a bfloat16 prefill of more than 65,535 (batch, head)
// rows).
extern "C" int ssd(const void* x, const void* dt, const void* b,
                   const void* c, const void* a, const void* state_in,
                   void* y, void* state_out, void* scratch, int batch,
                   int t_len, int heads, int head_dim, int d_state,
                   int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(dt);
  const auto* an = static_cast<const float*>(a);
  const auto* si = static_cast<const float*>(state_in);
  auto* so = static_cast<float*>(state_out);
  auto* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return dispatch<float>(x, d, b, c, an, si, y, so, sc, batch, t_len,
                           heads, head_dim, d_state, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, d, b, c, an, si, y, so, sc, batch,
                                   t_len, heads, head_dim, d_state, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
