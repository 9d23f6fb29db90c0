// RWKV6 WKV scan with data-dependent decay, chunked, with the state
// carried in and out.  One block per (batch, head, 32 value columns).
//
// Replaces, in the JAX package, src/repro/kernels/rwkv6_scan/kernel.py
// wkv6 (_wkv_kernel).  The TPU form takes [B*H, T, dh] one head at a
// time (its ops.py loops over heads in Python), walks a (head, chunk)
// grid whose chunk axis is sequential with the [dh, dh] state in VMEM
// scratch, starts from a zero state, returns no state and asserts
// T % chunk == 0.  Here r, k, v, logw are read as [B, T, H, dh], the
// layout the model produces, one launch covers every head, the state
// comes in (or is zero) and goes out, and the ragged last chunk is
// masked here, so T takes any value; T = 1 with the carried state is a
// decode step.
//
// What it computes, per (b, h), with S the [dh_k, dh_v] state:
//   o_t = r_t . (S + u (x) k_t^T v_t);   S <- diag(exp(w_t)) S + k_t^T v_t
// all in fp32, o stored in r's dtype, the final S in fp32.
//
// Overflow.  The Pallas kernel factors the in-chunk decay as
// (r exp(cum - w)) . (k exp(-cum)), and exp(-cum) overflows fp32 once
// the decay summed over a chunk passes about 88 (a chunk of 16 steps at
// logw = -8 reaches 128).  Here no factor grows: every exponent is a
// sum of log decays over a stretch of steps, so it is 0 or less:
//   in-chunk  A[t][s] = sum_d r[t,d] k[s,d] exp(cumx[t,d] - cum[s,d]),
//             s < t, where cumx[t] - cum[s] sums w over (s, t);
//   state-in  r[t,d] exp(cumx[t,d]);
//   update    k[s,d] exp(total[d] - cum[s,d]) and exp(total[d]);
// with cum the inclusive and cumx the exclusive prefix sum of w inside
// the chunk.  Small factors underflow to 0, where the exact product is
// below fp32's range anyway.  The price is C * C * dh exponentials a
// chunk for A, against C * dh for the factored form, so the chunk is
// short: C = 16.
//
// Layout of the work.  256 threads.  A chunk's r, k, cum and cumx are
// staged in shared memory as fp32 rows padded to dh + 1 words (a warp
// reading 16 rows at one column hits 16 banks), v for the block's 32
// columns, and the state's [dh, 32] slice lives in shared memory across
// chunks.  One thread a (t, s) pair forms A (C * C = 256); then each
// thread owns outputs (t, j) and state elements (d, j), j over the 32
// columns, so a warp reads one row of v and of S coalesced while r, A
// and k are broadcast.  The head's 64 value columns split over 2 blocks,
// which recompute A each: at B = 1 and 64 heads that is 128 blocks for
// the card's 132 SMs.
//
// What bounds it on an H100: at RWKV6-7B's prefill (B = 1, T = 512,
// H = 64, dh = 64, bf16) the function moves 26.2 MB (r, k, v, o in bf16,
// logw in fp32, the final state) and its state terms are 4 dh^2 fp32
// FLOPs per token and head, 0.54 GFLOP: about 8 us either way.  This
// kernel does its products on the fp32 CUDA cores and loads each chunk
// after the last one's update, with no prefetch: it is right first.
// Left for later: mma on the chunk products, a second chunk in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;    // timesteps per chunk
constexpr int kCols = 32;     // value columns per block
constexpr int kThreads = 256;
static_assert(kChunk * kChunk == kThreads, "one thread per (t, s) pair");

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
constexpr int smem_floats() {
  return kDh * kCols                     // state slice S[d][j]
         + 4 * kChunk * (kDh + 1)        // r, k, cum, cumx
         + kChunk * kCols                // v slice
         + kChunk * (kChunk + 1)         // A
         + 3 * kDh;                      // u, total, exp(total)
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* state_in, T* out,
            float* state_out, int t_len, int heads) {
  constexpr int kRow = kDh + 1;
  constexpr int kSplit = kDh / kCols;
  extern __shared__ float smem[];
  float* S = smem;                          // [kDh][kCols]
  float* rs = S + kDh * kCols;              // [kChunk][kRow]
  float* ks = rs + kChunk * kRow;
  float* cum = ks + kChunk * kRow;
  float* cumx = cum + kChunk * kRow;
  float* vs = cumx + kChunk * kRow;         // [kChunk][kCols]
  float* att = vs + kChunk * kCols;         // [kChunk][kChunk + 1]
  float* us = att + kChunk * (kChunk + 1);  // [kDh]
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

  for (int i = tid; i < kDh * kCols; i += kThreads) {
    const int d = i / kCols, j = i % kCols;
    S[i] = state_in ? state_in[sbase + d * kDh + j0 + j] : 0.f;
  }
  for (int d = tid; d < kDh; d += kThreads) us[d] = u[h * kDh + d];

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    // stage the chunk; rows past T are r = k = v = 0 and w = 0, which
    // add nothing to the output or the state
    for (int i = tid; i < kChunk * kDh; i += kThreads) {
      const int t = i / kDh, d = i % kDh;
      const bool live = t0 + t < t_len;
      const size_t at = base + static_cast<size_t>(t0 + t) * row_stride + d;
      rs[t * kRow + d] = live ? to_f32(r[at]) : 0.f;
      ks[t * kRow + d] = live ? to_f32(k[at]) : 0.f;
      cum[t * kRow + d] = live ? logw[at] : 0.f;
    }
    for (int i = tid; i < kChunk * kCols; i += kThreads) {
      const int t = i / kCols, j = i % kCols;
      const size_t at =
          base + static_cast<size_t>(t0 + t) * row_stride + j0 + j;
      vs[i] = t0 + t < t_len ? to_f32(v[at]) : 0.f;
    }
    __syncthreads();
    // prefix sums of the log decay down each column
    for (int d = tid; d < kDh; d += kThreads) {
      float run = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        cumx[t * kRow + d] = run;
        run += cum[t * kRow + d];
        cum[t * kRow + d] = run;
      }
      total[d] = run;
      decay[d] = expf(run);
    }
    __syncthreads();
    {
      // A[t][s]: the decay-masked r.k product below the diagonal, the
      // bonus u on it, 0 above it
      const int t = tid / kChunk, s = tid % kChunk;
      float a = 0.f;
      if (s < t) {
        for (int d = 0; d < kDh; ++d)
          a += rs[t * kRow + d] * ks[s * kRow + d] *
               expf(cumx[t * kRow + d] - cum[s * kRow + d]);
      } else if (s == t) {
        for (int d = 0; d < kDh; ++d)
          a += rs[t * kRow + d] * us[d] * ks[t * kRow + d];
      }
      att[t * (kChunk + 1) + s] = a;
    }
    __syncthreads();
    // r picks up the decay since the chunk's start, k the decay to its end
    for (int i = tid; i < kChunk * kDh; i += kThreads) {
      const int t = i / kDh, d = i % kDh;
      rs[t * kRow + d] *= expf(cumx[t * kRow + d]);
      ks[t * kRow + d] *= expf(total[d] - cum[t * kRow + d]);
    }
    __syncthreads();
    for (int i = tid; i < kChunk * kCols; i += kThreads) {
      const int t = i / kCols, j = i % kCols;
      if (t0 + t >= t_len) continue;
      float o = 0.f;
      for (int s = 0; s <= t; ++s)
        o += att[t * (kChunk + 1) + s] * vs[s * kCols + j];
      for (int d = 0; d < kDh; ++d) o += rs[t * kRow + d] * S[d * kCols + j];
      out[base + static_cast<size_t>(t0 + t) * row_stride + j0 + j] =
          from_f32<T>(o);
    }
    __syncthreads();
    for (int i = tid; i < kDh * kCols; i += kThreads) {
      const int d = i / kCols, j = i % kCols;
      float s_new = decay[d] * S[i];
      for (int s = 0; s < kChunk; ++s)
        s_new += ks[s * kRow + d] * vs[s * kCols + j];
      S[i] = s_new;
    }
    __syncthreads();
  }
  for (int i = tid; i < kDh * kCols; i += kThreads) {
    const int d = i / kCols, j = i % kCols;
    state_out[sbase + d * kDh + j0 + j] = S[i];
  }
}

template <typename T, int kDh>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* state_in, void* out,
           float* state_out, int batch, int t_len, int heads,
           cudaStream_t stream) {
  constexpr int kBytes = smem_floats<kDh>() * static_cast<int>(sizeof(float));
  if (kBytes > 48 * 1024) {  // above 48 KB only after an opt-in
    const cudaError_t set = cudaFuncSetAttribute(
        wkv6_kernel<T, kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBytes);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const dim3 grid(batch * heads * (kDh / kCols));
  wkv6_kernel<T, kDh><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, state_in, static_cast<T*>(out),
      state_out, t_len, heads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* state_in, void* out,
             float* state_out, int batch, int t_len, int heads, int head_dim,
             cudaStream_t s) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(r, k, v, logw, u, state_in, out, state_out, batch,
                           t_len, heads, s);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, state_in, out, state_out, batch,
                           t_len, heads, s);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, state_in, out, state_out,
                            batch, t_len, heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes.  r, k, v, out: [batch, t_len, heads,
// head_dim] of one dtype (0 float32, 1 bfloat16); logw: the same shape in
// float32, every entry 0 or less; u: [heads, head_dim] float32; state_in
// (or null for a zero state) and state_out: [batch, heads, head_dim,
// head_dim] float32, k index before v index; all contiguous.  state_in
// may equal state_out (each block reads its slice before it writes it).
// t_len must be at least 1.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a head dim other than 32, 64 or 128, or another dtype).
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* logw, const void* u, const void* state_in,
                    void* out, void* state_out, int batch, int t_len,
                    int heads, int head_dim, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(logw);
  const auto* up = static_cast<const float*>(u);
  const auto* si = static_cast<const float*>(state_in);
  auto* so = static_cast<float*>(state_out);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, up, si, out, so, batch, t_len, heads,
                           head_dim, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, up, si, out, so, batch, t_len,
                                   heads, head_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
