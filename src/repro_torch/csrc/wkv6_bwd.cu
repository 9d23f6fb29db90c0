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
// Every state element (k index i, v index j) runs a recurrence of its
// own: S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j], and G the same way
// backwards.  The terms couple them only through sums: dr, dk and dlogw
// sum over value columns, dv over key rows, du over everything.
//
// What bounds it on an H100.  At RWKV6-7B's training shape (B = 8,
// T = 256, H = 64, dh = 64, bf16) the function reads r, k, v, do (bf16)
// and logw (fp32) and writes dr, dk, dv (bf16) and dlogw (fp32): 185 MB,
// 0.055 ms at 3.35 TB/s.  Its state terms are some 12 FLOPs a state
// element a step (the forward state, its recomputation, the adjoint and
// the four products), 6.4 GFLOP on the fp32 CUDA cores: 0.096 ms.  This
// kernel is the simple form, far from both: it walks the T steps one
// after another (1.35 ms at that shape on an H100, 14x the bound:
// PERF.md, row 11b).
//
// The design.  wkv6_bwd_kernel: one block a (b, h, 16 value columns);
// each thread owns one key row i and 4 of the block's columns, 4 state
// elements, so the block holds a [dh, 16] slice of S and of G in
// registers (dh = 32, 64, 128: 128, 256, 512 threads).
//  (1) Forward walk over the chunks of kChunk = 16 steps: the state
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
// No atomics: two calls on the same inputs give the same bits.  Rows
// past T (the ragged last chunk) are r = k = v = do = 0 and w = 1: they
// change neither S nor G and are not written.
//
// Scratch (wkv6_bwd_scratch_floats): the checkpoints, B H ceil(T/16)
// dh^2 floats (134 MB at the training shape), then 3 (dh/16) B T H dh
// partial floats (403 MB), then B H dh^2/16 du partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;            // steps a checkpoint covers
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
  static constexpr int kFloats = 3 * kChunk * kDh + 2 * kChunk * kCols +
                                 kDh + 3 * kChunk * kDh +
                                 kChunk * kWarps * kCols;
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
  float* rs = smem;                  // [kChunk][kDh]
  float* ks = rs + kChunk * kDh;     // [kChunk][kDh]
  float* ws = ks + kChunk * kDh;     // [kChunk][kDh], exp(logw)
  float* vs = ws + kChunk * kDh;     // [kChunk][kCols]
  float* ds = vs + kChunk * kCols;   // [kChunk][kCols]
  float* pr = ds + kChunk * kCols;   // [kChunk][kDh]
  float* pk = pr + kChunk * kDh;     // [kChunk][kDh]
  float* pw = pk + kChunk * kDh;     // [kChunk][kDh]
  float* pv = pw + kChunk * kDh;     // [kChunk][kWarps][kCols]
  float* us = pv + kChunk * kWarps * kCols;  // [kDh]

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
    const int t0 = c * kChunk;
    for (int i = tid; i < kChunk * kDh; i += kThreads) {
      const int j = i / kDh, d = i % kDh;
      const bool live = t0 + j < t_len;
      const size_t at = base + static_cast<size_t>(t0 + j) * row_stride + d;
      ks[i] = live ? to_f32(k[at]) : 0.f;
      ws[i] = live ? expf(logw[at]) : 1.f;
      if (backward) rs[i] = live ? to_f32(r[at]) : 0.f;
    }
    for (int i = tid; i < kChunk * kCols; i += kThreads) {
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
    for (int j = 0; j < kChunk; ++j) {
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
    float hist[kChunk][kPer];
    S[0] = s4.x;
    S[1] = s4.y;
    S[2] = s4.z;
    S[3] = s4.w;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
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
    for (int j = kChunk - 1; j >= 0; --j) {
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
    const int t0 = c * kChunk;
    for (int i = tid; i < kChunk * kDh; i += kThreads) {
      const int j = i / kDh, d = i % kDh;
      if (t0 + j >= t_len) continue;
      const size_t at = base + static_cast<size_t>(t0 + j) * row_stride + d;
      part[(0 * kSlices + slice) * n_rows + at] = pr[i];
      part[(1 * kSlices + slice) * n_rows + at] = pk[i];
      part[(2 * kSlices + slice) * n_rows + at] = pw[i];
    }
    for (int i = tid; i < kChunk * kCols; i += kThreads) {
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

int n_chunks_of(int t_len) { return (t_len + kChunk - 1) / kChunk; }

template <typename T, int kDh>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* state_in, const void* dout,
           const float* dstate, void* dr, void* dk, void* dv, float* dlogw,
           float* du, float* dstate_in, float* scratch, int batch,
           int t_len, int heads, cudaStream_t stream) {
  using L = Shape<kDh>;
  const int n_chunks = n_chunks_of(t_len);
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
             float* du, float* dstate_in, float* scratch, int batch,
             int t_len, int heads, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(r, k, v, logw, u, state_in, dout, dstate, dr, dk,
                           dv, dlogw, du, dstate_in, scratch, batch, t_len,
                           heads, stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, state_in, dout, dstate, dr, dk,
                           dv, dlogw, du, dstate_in, scratch, batch, t_len,
                           heads, stream);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, state_in, dout, dstate, dr, dk,
                            dv, dlogw, du, dstate_in, scratch, batch, t_len,
                            heads, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Scratch floats wkv6_bwd needs: the checkpoints, the column slices'
// partials of dr, dk and dlogw, and du's per-block partials (0 for an
// empty call).
extern "C" long long wkv6_bwd_scratch_floats(int batch, int t_len, int heads,
                                             int head_dim) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || head_dim % kCols) return 0;
  const long long bh = static_cast<long long>(batch) * heads;
  const long long slices = head_dim / kCols;
  return bh * n_chunks_of(t_len) * head_dim * head_dim +
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
// batch, t_len and heads must be at least 1.  Launches three kernels on
// `stream`, does not synchronise, and returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for a head dim other than 32, 64
// or 128, or another dtype).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* logw, const void* u,
                        const void* state_in, const void* dout,
                        const void* dstate, void* dr, void* dk, void* dv,
                        void* dlogw, void* du, void* dstate_in,
                        void* scratch, int batch, int t_len, int heads,
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
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, up, si, dout, dsf, dr, dk, dv, dw,
                           dup, dsi, sc, batch, t_len, heads, head_dim, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, up, si, dout, dsf, dr, dk, dv,
                                   dw, dup, dsi, sc, batch, t_len, heads,
                                   head_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
