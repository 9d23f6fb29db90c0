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
// dB_, dC_ and dA: 412 MB, 0.123 ms at 3.35 TB/s.  Its state terms are
// some 12 FLOPs a state element a step, 12.9 GFLOP on the fp32 CUDA
// cores: 0.19 ms.  This kernel is the simple form, far from both: it
// walks the T steps one after another (3.31 ms at that shape on an
// H100, 17x the bound: PERF.md, row 10b).
//
// The design, that of csrc/wkv6_bwd.cu.  ssd_bwd_kernel: one block a
// (b, h); each thread owns one row d of the state and 4 of its N
// columns (N = 8 or 16: 2 or 4 lanes a row), so the block holds h and G
// in registers (dh = 32, 64, 128 at N = 16: 128, 256, 512 threads).
//  (1) Forward walk over chunks of kChunk = 16 steps: the state
//      entering each chunk goes to a scratch of checkpoints.
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
// No atomics: two calls on the same inputs give the same bits.  Rows
// past T are x = B_ = C_ = dy = dt = 0 and a = 1: they change neither h
// nor G and are not written.
//
// Scratch (ssd_bwd_scratch_floats): the checkpoints, B H ceil(T/16) dh
// N floats (268 MB at Jamba's shape), then 2 B T H N partial floats
// (134 MB), then B H dA partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;  // steps a checkpoint covers
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
  static constexpr int kFloats = 2 * kChunk * kDh + 2 * kChunk * kN +
                                 2 * kChunk + kChunk * kDh +
                                 2 * kChunk * kWarps * kN +
                                 2 * kChunk * kWarps;
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
  float* xs = smem;                   // [kChunk][kDh]
  float* ys = xs + kChunk * kDh;      // [kChunk][kDh], dy
  float* px = ys + kChunk * kDh;      // [kChunk][kDh], dx
  float* bs = px + kChunk * kDh;      // [kChunk][kN]
  float* cs = bs + kChunk * kN;       // [kChunk][kN]
  float* pc = cs + kChunk * kN;       // [kChunk][kWarps][kN]
  float* pb = pc + kChunk * kWarps * kN;  // [kChunk][kWarps][kN]
  float* ps = pb + kChunk * kWarps * kN;  // [kChunk][kWarps][2]
  float* dts = ps + 2 * kChunk * kWarps;  // [kChunk]
  float* as = dts + kChunk;               // [kChunk], exp(dt A)

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
    const int t0 = c * kChunk;
    for (int i = tid; i < kChunk * kDh; i += kThreads) {
      const int j = i / kDh, d = i % kDh;
      const bool live = t0 + j < t_len;
      const size_t at = xbase + static_cast<size_t>(t0 + j) * x_stride + d;
      xs[i] = live ? to_f32(x[at]) : 0.f;
      if (backward) ys[i] = live ? to_f32(dy[at]) : 0.f;
    }
    for (int i = tid; i < kChunk * kN; i += kThreads) {
      const int j = i / kN, n = i % kN;
      const bool live = t0 + j < t_len;
      const size_t at = nbase + static_cast<size_t>(t0 + j) * kN + n;
      bs[i] = live ? to_f32(bm[at]) : 0.f;
      if (backward) cs[i] = live ? to_f32(cm[at]) : 0.f;
    }
    for (int j = tid; j < kChunk; j += kThreads) {
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
    for (int j = 0; j < kChunk; ++j) {
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
    float hist[kChunk][kPer];
    S[0] = s4.x;
    S[1] = s4.y;
    S[2] = s4.z;
    S[3] = s4.w;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
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
    for (int j = kChunk - 1; j >= 0; --j) {
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
    const int t0 = c * kChunk;
    for (int i = tid; i < kChunk * kDh; i += kThreads) {
      const int j = i / kDh, d = i % kDh;
      if (t0 + j >= t_len) continue;
      dx[xbase + static_cast<size_t>(t0 + j) * x_stride + d] =
          from_f32<T>(px[i]);
    }
    for (int i = tid; i < kChunk * kN; i += kThreads) {
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
    for (int j = tid; j < kChunk; j += kThreads) {
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
      for (int j = kChunk - 1; j >= 0; --j) {
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

int n_chunks_of(int t_len) { return (t_len + kChunk - 1) / kChunk; }

template <typename T, int kDh, int kN>
int launch(const void* x, const float* dt, const void* bm, const void* cm,
           const float* A, const float* state_in, const void* dy,
           const float* dstate, void* dx, float* ddt, void* db, void* dc,
           float* da, float* dstate_in, float* scratch, int batch,
           int t_len, int heads, cudaStream_t stream) {
  using L = Shape<kDh, kN>;
  const int n_chunks = n_chunks_of(t_len);
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
             float* da, float* dstate_in, float* scratch, int batch,
             int t_len, int heads, int d_state, cudaStream_t stream) {
  if (d_state == 8)
    return launch<T, kDh, 8>(x, dt, bm, cm, A, state_in, dy, dstate, dx, ddt,
                             db, dc, da, dstate_in, scratch, batch, t_len,
                             heads, stream);
  if (d_state == 16)
    return launch<T, kDh, 16>(x, dt, bm, cm, A, state_in, dy, dstate, dx,
                              ddt, db, dc, da, dstate_in, scratch, batch,
                              t_len, heads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* x, const float* dt, const void* bm, const void* cm,
             const float* A, const float* state_in, const void* dy,
             const float* dstate, void* dx, float* ddt, void* db, void* dc,
             float* da, float* dstate_in, float* scratch, int batch,
             int t_len, int heads, int head_dim, int d_state,
             cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return by_state<T, 32>(x, dt, bm, cm, A, state_in, dy, dstate, dx, ddt,
                             db, dc, da, dstate_in, scratch, batch, t_len,
                             heads, d_state, stream);
    case 64:
      return by_state<T, 64>(x, dt, bm, cm, A, state_in, dy, dstate, dx, ddt,
                             db, dc, da, dstate_in, scratch, batch, t_len,
                             heads, d_state, stream);
    case 128:
      return by_state<T, 128>(x, dt, bm, cm, A, state_in, dy, dstate, dx,
                              ddt, db, dc, da, dstate_in, scratch, batch,
                              t_len, heads, d_state, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Scratch floats ssd_bwd needs: the checkpoints, the heads' partials of
// dB_ and dC_, and dA's per-block partials (0 for an empty call).
extern "C" long long ssd_bwd_scratch_floats(int batch, int t_len, int heads,
                                            int head_dim, int d_state) {
  if (batch <= 0 || t_len <= 0 || heads <= 0) return 0;
  const long long bh = static_cast<long long>(batch) * heads;
  return bh * n_chunks_of(t_len) * head_dim * d_state +
         2 * bh * t_len * d_state + bh;
}

// C interface, loaded with ctypes.  x, dy, dx: [batch, t_len, heads,
// head_dim] of one dtype (0 float32, 1 bfloat16); dt, ddt: [batch,
// t_len, heads] float32; bm, cm, db, dc: [batch, t_len, d_state] in x's
// dtype; A, dA: [heads] float32; state_in (or null for a zero state),
// dstate (the final state's gradient, or null for zeros) and dstate_in
// (the input state's gradient, or null to skip it): [batch, heads,
// head_dim, d_state] float32; scratch: at least ssd_bwd_scratch_floats(...)
// floats, 16-byte aligned; all contiguous.  batch, t_len and heads must
// be at least 1.  Launches three kernels on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a head dim other than 32, 64 or 128, a
// d_state other than 8 or 16, or another dtype).
extern "C" int ssd_bwd(const void* x, const void* dt, const void* bm,
                       const void* cm, const void* A, const void* state_in,
                       const void* dy, const void* dstate, void* dx,
                       void* ddt, void* db, void* dc, void* dA,
                       void* dstate_in, void* scratch, int batch, int t_len,
                       int heads, int head_dim, int d_state, int dtype,
                       void* stream) {
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
  if (dtype == 0)
    return dispatch<float>(x, dtp, bm, cm, ap, si, dy, dsf, dx, ddtp, db, dc,
                           dap, dsi, sc, batch, t_len, heads, head_dim,
                           d_state, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dtp, bm, cm, ap, si, dy, dsf, dx, ddtp,
                                   db, dc, dap, dsi, sc, batch, t_len, heads,
                                   head_dim, d_state, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
