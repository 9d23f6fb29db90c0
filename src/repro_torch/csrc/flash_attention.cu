// Causal / sliding-window attention forward (prefill), online softmax
// over tiles of keys.  One block per (batch, head, tile of 32 query rows).
//
// Replaces, in the JAX package, src/repro/kernels/flash_attention/kernel.py
// flash_attention (_flash_kernel).  The TPU form takes [B*H, T, dh] with
// the kv heads repeated by the caller, walks a (q block, kv block) grid
// whose kv axis is sequential with (m, l, acc) in VMEM scratch, and
// asserts T % q_block == 0.  Here q is read as [B, T, H, dh] and k, v as
// [B, S, Hk, dh], the layouts the model produces: query head h reads kv
// head h / (H / Hk), so GQA makes no copy; the key loop runs inside the
// block; the ragged last tile of query rows and of keys is masked here,
// so T and S take any value.
//
// Semantics, those of the TPU kernel:
//   * q, k, v are upcast to fp32; scores s = (q . k) * scale; softmax and
//     the P.V product in fp32; the output is stored in q's dtype;
//   * causal: query row i sits at position i + S - T (right-aligned) and
//     sees key j iff j <= pos, and with a window w also j > pos - w; the
//     window applies only with causal, as in the TPU kernel;
//   * out = acc / max(l, 1e-30): a row that sees no key (T > S) is 0.
//   Tiles of keys that lie wholly above the diagonal or before the window
//   of every row of the block are never loaded.
//
// Layout of the work: 128 threads, 4 per query row.  Thread r of a row
// owns the columns c = r + 4 i of q and of the accumulator, so the four
// threads of a row read four consecutive shared-memory words (no bank
// conflict) and the other rows of the warp read the same words
// (broadcast).  A tile of 64 keys (32 when dh = 128) is staged in shared
// memory as fp32, coalesced; each row's four threads form each score
// with two shuffles and keep the tile's scores in registers.
//
// What bounds it on an H100: at the prefill shapes of Qwen2-0.5B (H = 14,
// Hk = 2, dh = 64, T = S = 256-512) a layer's attention is
// 2 * 2 * T^2 * dh * H / 2 FLOPs, 0.47 GFLOP at T = 512 (0.47 us at the
// bf16 tensor-core rate), against 2.1 MB of q, k, v and output in bf16
// (0.63 us at HBM bandwidth): the two bounds are within a factor of two,
// and both are far below what this kernel takes.  It does its products
// on the fp32 CUDA cores, not the tensor cores, and recomputes each exp
// on the four threads of a row: it is right first.  Left for later:
// mma / wgmma on bf16 tiles, TMA staging and a warp-specialised pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;    // query rows per block
constexpr int kLanes = 4;    // threads per query row
constexpr int kThreads = kRows * kLanes;
constexpr float kNegBig = -1e30f;

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

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int t_len, int s_len, int heads, int kv_heads,
                       int causal, int window, float scale) {
  constexpr int kCols = kDh / kLanes;          // columns a thread owns
  constexpr int kKeys = kDh <= 64 ? 64 : 32;   // keys per staged tile
  __shared__ float ks[kKeys][kDh];
  __shared__ float vs[kKeys][kDh];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int q0 = blockIdx.x * kRows;
  const int qi = q0 + row;
  const bool live = qi < t_len;
  const int off = s_len - t_len;
  const int qpos = qi + off;

  float qr[kCols], acc[kCols];
  const int64_t qbase =
      (static_cast<int64_t>(b) * t_len + qi) * heads * kDh +
      static_cast<int64_t>(h) * kDh;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    qr[c] = live ? to_f32(q[qbase + lane + kLanes * c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegBig, l = 0.f;

  // keys any row of this block can see
  int kv_lo = 0, kv_hi = s_len;
  if (causal) {
    const int last_row = min(q0 + kRows, t_len) - 1;
    kv_hi = min(s_len, last_row + off + 1);
    if (window > 0) kv_lo = max(0, q0 + off - window + 1);
  }
  const int64_t kv_row = static_cast<int64_t>(kv_heads) * kDh;
  const int64_t kv_base =
      static_cast<int64_t>(b) * s_len * kv_row + static_cast<int64_t>(hk) * kDh;

  for (int t0 = (kv_lo / kKeys) * kKeys; t0 < kv_hi; t0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kKeys * kDh; i += kThreads) {
      const int j = i / kDh;
      const int c = i - j * kDh;
      const int s = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < s_len) {
        const int64_t o = kv_base + s * kv_row + c;
        kv = to_f32(k[o]);
        vv = to_f32(v[o]);
      }
      ks[j][c] = kv;
      vs[j][c] = vv;
    }
    __syncthreads();

    float sc[kKeys];
    float tmax = kNegBig;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) part += qr[c] * ks[j][lane + kLanes * c];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = t0 + j;
      bool ok = live && kpos < s_len;
      if (causal) {
        ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
      }
      sc[j] = ok ? part * scale : -INFINITY;
      tmax = fmaxf(tmax, sc[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = expf(sc[j] - m_new);  // a masked key gives 0
      psum += p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] += p * vs[j][lane + kLanes * c];
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      out[qbase + lane + kLanes * c] = from_f32<T>(acc[c] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int t_len, int s_len, int heads, int kv_heads, int head_dim,
           int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((t_len + kRows - 1) / kRows, batch * heads);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(out);
  switch (head_dim) {
    case 32:
      flash_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, op, t_len, s_len, heads, kv_heads, causal, window,
          scale);
      break;
    case 64:
      flash_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, op, t_len, s_len, heads, kv_heads, causal, window,
          scale);
      break;
    case 128:
      flash_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, op, t_len, s_len, heads, kv_heads, causal, window,
          scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  q: [batch, t_len, heads, head_dim];
// k, v: [batch, s_len, kv_heads, head_dim]; out like q; all contiguous,
// of one dtype (0 float32, 1 bfloat16).  window <= 0 means none.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// dim other than 32, 64 or 128, another dtype, or heads not a multiple
// of kv_heads).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int t_len, int s_len,
                               int heads, int kv_heads, int head_dim,
                               int causal, int window, int dtype, float scale,
                               void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, batch, t_len, s_len, heads, kv_heads,
                         head_dim, causal, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, batch, t_len, s_len, heads,
                                 kv_heads, head_dim, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
