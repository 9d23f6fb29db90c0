// Single-token decode attention over KV pages addressed by a block
// table, online softmax across chunks of keys.  One block per
// (sequence, query head).
//
// Replaces, in the JAX package, src/repro/kernels/paged_attention/kernel.py
// paged_attention (_paged_kernel).  The TPU form walks a (B*H, MAXP)
// grid whose page axis is sequential, resolves the page indirection in
// the DMA engine from a prefetched block table, keeps (m, l, acc) in
// VMEM scratch, and needs the kv heads repeated to H by its caller
// (paged_mqa).  Here a block walks the live keys of its sequence itself,
// 128 at a time, reading each key's page from the table; query head h
// reads kv head h / (H / Hk), so GQA makes no copy.
//
// Semantics, those of the TPU kernel:
//   * keys j < min(len, MAXP * PS) are live (pages pi * PS < len); key j
//     is slot j % PS of page max(table[b, j / PS], 0);
//   * q and the pages are upcast to fp32; s = (q . k) * scale; softmax
//     and the P.V product in fp32; out = acc / max(l, 1e-30) in q's
//     dtype, so len = 0 gives zeros.
//
// Layout of the work: 128 threads.  q is staged in shared memory as fp32;
// thread t scores key c0 + t of the chunk, reading its key row with
// 16-byte loads, the block reduces the chunk's max and sum (warp
// shuffles, then four partials in shared memory), and the chunk's
// weights and each key's row offset go to shared memory.  For the P.V
// product thread t owns column t % dh and every (128 / dh)-th key of the
// chunk, so a warp reads consecutive columns of one value row
// (coalesced), and the loop is unrolled so that several rows' loads are
// in flight at once; the partial sums of a column are added at the end.
//
// What bounds it on an H100: a decode step reads each live key and value
// once, 2 * len * Hk * dh * 2 bytes in bf16 (0.28 MB per layer at len =
// 544, Hk = 2, dh = 64, about 0.08 us at HBM bandwidth), and does about
// 4 * len * H * dh FLOPs.  At one sequence of Qwen2-0.5B the launch costs
// more than either: 14 blocks run on 132 SMs.  Left for later: split a
// long sequence's keys over several blocks (a second reduction pass),
// and read each kv head once for all the query heads that share it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // keys per chunk, one a thread
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// the kDh contiguous values at p (16-byte aligned) as fp32, 16 bytes a load
template <int kDh>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float* out) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kDh / 4; ++i) {
    const float4 x = v[i];
    out[4 * i] = x.x;
    out[4 * i + 1] = x.y;
    out[4 * i + 2] = x.z;
    out[4 * i + 3] = x.w;
  }
}
template <int kDh>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float* out) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i) {
    const uint4 x = v[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[8 * i + 2 * j] = f.x;
      out[8 * i + 2 * j + 1] = f.y;
    }
  }
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

// max (kMax) or sum of x over the block; every thread gets the result
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pages_k,
                       const T* __restrict__ pages_v,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ lens, T* __restrict__ out,
                       int heads, int kv_heads, int page_size, int max_pages,
                       float scale) {
  constexpr int kGroups = kThreads / kDh;  // keys a column is split over
  __shared__ float qs[kDh];
  __shared__ float ps[kThreads];
  __shared__ int64_t offs[kThreads];  // each key's row offset in the pages
  __shared__ float red[kWarps];
  __shared__ float part[kGroups][kDh];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int len = max(0, min(lens[b], max_pages * page_size));
  const int32_t* row = table + static_cast<int64_t>(b) * max_pages;
  const int64_t key_row = static_cast<int64_t>(kv_heads) * kDh;

  for (int c = threadIdx.x; c < kDh; c += kThreads)
    qs[c] = to_f32(q[static_cast<int64_t>(bh) * kDh + c]);
  __syncthreads();

  const int col = threadIdx.x % kDh;
  const int grp = threadIdx.x / kDh;
  float m = kNegBig, l = 0.f, acc = 0.f;
  for (int c0 = 0; c0 < len; c0 += kThreads) {
    const int j = c0 + threadIdx.x;
    float s = -INFINITY;
    if (j < len) {
      const int64_t page = max(row[j / page_size], 0);
      const int64_t off = (page * page_size + j % page_size) * key_row +
                          static_cast<int64_t>(hk) * kDh;
      offs[threadIdx.x] = off;
      float kr[kDh];
      load_row<kDh>(pages_k + off, kr);
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < kDh; ++c) d += qs[c] * kr[c];
      s = d * scale;
    }
    const float m_new = fmaxf(m, block_reduce<true>(s, red));
    const float p = expf(s - m_new);  // a dead key gives 0
    ps[threadIdx.x] = p;
    const float alpha = expf(m - m_new);
    l = l * alpha + block_reduce<false>(p, red);  // its syncs publish
                                                  // ps and offs
    m = m_new;
    const int n = min(kThreads, len - c0);
    float a = 0.f;
#pragma unroll 8
    for (int jj = grp; jj < n; jj += kGroups)
      a += ps[jj] * to_f32(pages_v[offs[jj] + col]);
    acc = acc * alpha + a;
    __syncthreads();  // ps is rewritten by the next chunk
  }
  part[grp][col] = acc;
  __syncthreads();
  if (threadIdx.x < kDh) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) total += part[g][threadIdx.x];
    out[static_cast<int64_t>(bh) * kDh + threadIdx.x] =
        from_f32<T>(total / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* pages_k, const void* pages_v,
           const void* table, const void* lens, void* out, int batch,
           int heads, int kv_heads, int head_dim, int page_size,
           int max_pages, float scale, cudaStream_t stream) {
  const dim3 grid(batch * heads);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(pages_k);
  const auto* vp = static_cast<const T*>(pages_v);
  const auto* tp = static_cast<const int32_t*>(table);
  const auto* lp = static_cast<const int32_t*>(lens);
  auto* op = static_cast<T*>(out);
  switch (head_dim) {
    case 32:
      paged_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, tp, lp, op, heads, kv_heads, page_size, max_pages,
          scale);
      break;
    case 64:
      paged_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, tp, lp, op, heads, kv_heads, page_size, max_pages,
          scale);
      break;
    case 128:
      paged_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, tp, lp, op, heads, kv_heads, page_size, max_pages,
          scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  q: [batch, heads, head_dim]; pages_k,
// pages_v: [n_pages, page_size, kv_heads, head_dim]; table: [batch,
// max_pages] int32 (entries below 0 read page 0); lens: [batch] int32;
// out like q; all contiguous, q and the pages of one dtype (0 float32,
// 1 bfloat16), the pages 16-byte aligned.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// dim other than 32, 64 or 128, another dtype, or heads not a multiple
// of kv_heads).
extern "C" int paged_attention(const void* q, const void* pages_k,
                               const void* pages_v, const void* table,
                               const void* lens, void* out, int batch,
                               int heads, int kv_heads, int head_dim,
                               int page_size, int max_pages, int dtype,
                               float scale, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || page_size <= 0 ||
      max_pages < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, pages_k, pages_v, table, lens, out, batch, heads,
                         kv_heads, head_dim, page_size, max_pages, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pages_k, pages_v, table, lens, out, batch,
                                 heads, kv_heads, head_dim, page_size,
                                 max_pages, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
