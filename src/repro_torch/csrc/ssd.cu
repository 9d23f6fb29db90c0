// Mamba-2 SSD scan (state-space duality, chunked form), with the state
// carried in and out.  One block per (batch, head).
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
// value; T = 1 with the carried state is a decode step.
//
// What it computes, per (b, h), with the [dh, N] state S and A < 0:
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T;   y_t = S_t C_t
// all in fp32, y stored in x's dtype, the final S in fp32.  Inside a
// chunk of C steps, with cum_t the inclusive prefix sum of dt A and
// total its last value:
//   y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//         + exp(cum_t) S_in C_t
//   S_out = exp(total) S_in + sum_s exp(total - cum_s) dt_s x_s B_s^T
//
// No overflow.  The Pallas kernel exponentiates cum_t - cum_s for every
// (t, s) and masks s > t afterwards; for s > t that exponent is
// positive and reaches hundreds over a long chunk.  Here only s <= t is
// computed, so every exponent is a sum of log decays, 0 or less: cum_t,
// total - cum_s and cum_t - cum_s.
//
// Layout of the work.  256 threads.  A chunk's x, B_, C_ and dt are
// staged in shared memory as fp32 (rows of N padded to N + 1 words, so
// a warp reading one column of 32 rows hits 32 banks), beside the
// state's [dh, N] fp32 slice, which lives there across chunks.  Warp 0
// forms the prefix sums with shuffles; one thread a (t, s) pair forms
// the decay-masked score G; then each thread owns outputs (t, j), j over
// dh, so a warp reads one row of x coalesced while G and C_ are
// broadcast; then each thread owns state elements (j, n).  C = 32: the
// in-chunk product costs C / 2 multiply-adds a token and channel, the
// state terms 2 N, so a longer chunk only adds work on CUDA cores.
//
// What bounds it on an H100: at Jamba's full width (B = 1, T = 4096,
// H = 256, dh = 64, N = 16, bf16) the function moves about 272 MB (x and
// y in bf16, dt in fp32, B_ and C_, the state) and its state terms are
// 4 dh N fp32 FLOPs a token and head, 4.3 GFLOP: about 0.08 ms.  This
// kernel does every product on the fp32 CUDA cores, three times the
// state terms' FLOPs, and loads each chunk after the last one's update,
// with no prefetch: it is right first.  Left for later: mma on the chunk
// products, a second chunk in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;    // timesteps per chunk: one warp's lanes
constexpr int kThreads = 256;

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
constexpr int smem_floats() {
  return kDh * (kN + 1)                  // state S[j][n]
         + kChunk * kDh                  // x
         + 3 * kChunk * (kN + 1)         // B_, C_, B_ weighted to the end
         + kChunk * (kChunk + 1)         // G
         + 4 * kChunk                    // dt, cum, exp(cum), to-end weight
         + 1;                            // exp(total)
}

template <typename T, int kDh, int kN>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const T* __restrict__ bm, const T* __restrict__ cm,
           const float* __restrict__ a_neg, const float* state_in, T* y,
           float* state_out, int t_len, int heads) {
  constexpr int kNRow = kN + 1;
  constexpr int kGRow = kChunk + 1;
  extern __shared__ float smem[];
  float* S = smem;                         // [kDh][kNRow]
  float* xs = S + kDh * kNRow;             // [kChunk][kDh]
  float* bs = xs + kChunk * kDh;           // [kChunk][kNRow]
  float* cs = bs + kChunk * kNRow;
  float* bw = cs + kChunk * kNRow;         // B_s exp(total - cum_s) dt_s
  float* g = bw + kChunk * kNRow;          // [kChunk][kGRow]
  float* dts = g + kChunk * kGRow;         // [kChunk]
  float* cum = dts + kChunk;
  float* ecum = cum + kChunk;
  float* wend = ecum + kChunk;
  float* etot = wend + kChunk;

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

  for (int i = tid; i < kDh * kN; i += kThreads) {
    const int j = i / kN, n = i % kN;
    S[j * kNRow + n] = state_in ? state_in[sbase + i] : 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int live = min(kChunk, t_len - t0);
    // stage the chunk; rows past T are x = B_ = C_ = 0 and dt = 0, which
    // add nothing to the output or the state and decay nothing
    for (int i = tid; i < kChunk * kDh; i += kThreads) {
      const int t = i / kDh, j = i % kDh;
      xs[i] = t < live
                  ? to_f32(x[xbase + static_cast<size_t>(t0 + t) * row_stride +
                             j])
                  : 0.f;
    }
    for (int i = tid; i < kChunk * kN; i += kThreads) {
      const int t = i / kN, n = i % kN;
      const size_t at = nbase + static_cast<size_t>(t0) * kN + i;
      bs[t * kNRow + n] = t < live ? to_f32(bm[at]) : 0.f;
      cs[t * kNRow + n] = t < live ? to_f32(cm[at]) : 0.f;
    }
    if (tid < kChunk)
      dts[tid] = tid < live ? dt[dbase + static_cast<size_t>(t0 + tid) * heads]
                            : 0.f;
    __syncthreads();
    if (tid < 32) {
      // inclusive prefix sum of the log decay dt A over the chunk
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
    // G[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t < live
    for (int i = tid; i < kChunk * kChunk; i += kThreads) {
      const int t = i / kChunk, s = i % kChunk;
      if (t >= live || s > t) continue;
      float dot = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) dot += cs[t * kNRow + n] * bs[s * kNRow + n];
      g[t * kGRow + s] = dot * expf(cum[t] - cum[s]) * dts[s];
    }
    for (int i = tid; i < kChunk * kN; i += kThreads) {
      const int s = i / kN, n = i % kN;
      bw[s * kNRow + n] = bs[s * kNRow + n] * wend[s];
    }
    __syncthreads();
    for (int i = tid; i < kChunk * kDh; i += kThreads) {
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
    for (int i = tid; i < kDh * kN; i += kThreads) {
      const int j = i / kN, n = i % kN;
      float s_new = decay * S[j * kNRow + n];
      for (int s = 0; s < live; ++s) s_new += xs[s * kDh + j] * bw[s * kNRow + n];
      S[j * kNRow + n] = s_new;
    }
    __syncthreads();
  }
  for (int i = tid; i < kDh * kN; i += kThreads) {
    const int j = i / kN, n = i % kN;
    state_out[sbase + i] = S[j * kNRow + n];
  }
}

template <typename T, int kDh, int kN>
int launch(const void* x, const float* dt, const void* bm, const void* cm,
           const float* a_neg, const float* state_in, void* y,
           float* state_out, int batch, int t_len, int heads,
           cudaStream_t stream) {
  constexpr int kBytes =
      smem_floats<kDh, kN>() * static_cast<int>(sizeof(float));
  if (kBytes > 48 * 1024) {  // above 48 KB only after an opt-in
    const cudaError_t set = cudaFuncSetAttribute(
        ssd_kernel<T, kDh, kN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBytes);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  ssd_kernel<T, kDh, kN><<<batch * heads, kThreads, kBytes, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(bm),
      static_cast<const T*>(cm), a_neg, state_in, static_cast<T*>(y),
      state_out, t_len, heads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kN>
int by_head_dim(const void* x, const float* dt, const void* bm,
                const void* cm, const float* a_neg, const float* state_in,
                void* y, float* state_out, int batch, int t_len, int heads,
                int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32:
      return launch<T, 32, kN>(x, dt, bm, cm, a_neg, state_in, y, state_out,
                               batch, t_len, heads, s);
    case 64:
      return launch<T, 64, kN>(x, dt, bm, cm, a_neg, state_in, y, state_out,
                               batch, t_len, heads, s);
    case 128:
      return launch<T, 128, kN>(x, dt, bm, cm, a_neg, state_in, y, state_out,
                                batch, t_len, heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const float* dt, const void* bm, const void* cm,
             const float* a_neg, const float* state_in, void* y,
             float* state_out, int batch, int t_len, int heads, int head_dim,
             int d_state, cudaStream_t s) {
  switch (d_state) {
    case 8:
      return by_head_dim<T, 8>(x, dt, bm, cm, a_neg, state_in, y, state_out,
                               batch, t_len, heads, head_dim, s);
    case 16:
      return by_head_dim<T, 16>(x, dt, bm, cm, a_neg, state_in, y, state_out,
                                batch, t_len, heads, head_dim, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes.  x, y: [batch, t_len, heads, head_dim]
// of one dtype (0 float32, 1 bfloat16); b, c: [batch, t_len, d_state] of
// that dtype, shared by every head; dt: [batch, t_len, heads] float32,
// each entry 0 or more; a: [heads] float32, each below 0; state_in (or
// null for a zero state) and state_out: [batch, heads, head_dim, d_state]
// float32; all contiguous.  state_in may equal state_out (each block
// reads its slice before it writes it).  t_len must be at least 1.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// dim other than 32, 64 or 128, a d_state other than 8 or 16, or
// another dtype).
extern "C" int ssd(const void* x, const void* dt, const void* b,
                   const void* c, const void* a, const void* state_in,
                   void* y, void* state_out, int batch, int t_len, int heads,
                   int head_dim, int d_state, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(dt);
  const auto* an = static_cast<const float*>(a);
  const auto* si = static_cast<const float*>(state_in);
  auto* so = static_cast<float*>(state_out);
  if (dtype == 0)
    return dispatch<float>(x, d, b, c, an, si, y, so, batch, t_len, heads,
                           head_dim, d_state, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, d, b, c, an, si, y, so, batch, t_len,
                                   heads, head_dim, d_state, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
