// Causal / sliding-window attention backward: dq, dk, dv of the function
// csrc/flash_attention.cu computes.
//
// Replaces no TPU kernel.  The JAX package trains through XLA's autodiff
// of its jnp attention (jax.value_and_grad at src/repro/launch/steps.py:34,
// through _sdpa in src/repro/models/attention.py); its Pallas
// flash_attention kernel has no backward.  The port's forward runs on the
// CUDA kernel of csrc/flash_attention.cu, launched through ctypes, so
// autograd cannot differentiate it: this is the gradient that
// repro_torch.kernels.flash_attention.ops.mha's backward launches.
//
// Semantics, those of the forward:
//   * q [B, T, H, dh], k, v [B, S, Hk, dh]; query head h reads kv head
//     h / (H / Hk);
//   * causal: query row i sits at position i + S - T and sees key j iff
//     j <= pos, and with a window w also j > pos - w (the window applies
//     only with causal);
//   * scores s = (q . k) * scale, P = softmax(s) in fp32;
//   * D = rowsum(dO * O) with O the forward's output as stored (bf16 when
//     the forward ran in bf16), dP = dO . V^T, dS = P * (dP - D),
//     dq = scale * dS . K, dk = scale * dS^T . Q, dv = P^T . dO, all in
//     fp32, stored once in q's dtype;
//   * a row that sees no key has P = 0: it adds nothing, and its dq is 0.
//
// A simple design, on the CUDA cores in exact fp32 (bf16 inputs are
// widened on load).  Tiles of 64 query rows and 64 keys sit in shared
// memory as fp32, rows padded to dh + 1 words so that a warp reading a
// column of rows hits 32 banks.  Two kernels, both 256 threads:
//
// A (dq): one block per (64 query rows, head, batch).  It loads the q and
//   dO tiles and forms D from the forward's output.  A first pass over
//   the key tiles the rows can see forms each row's log-sum-exp (online
//   max and sum, one thread a row).  A second pass recomputes P =
//   exp(s - LSE), forms dP and dS for the tile (each thread 16 rows of
//   one key column) and accumulates dq = dS . K in registers (each thread
//   one column of dq over dh / 4 rows).  It writes dq, and LSE and D to
//   fp32 scratch [B, H, T] for kernel B.
// B (dk, dv): one block per (64 keys, kv head, batch).  It keeps its k
//   and v tiles and the dk, dv accumulators (each thread one column over
//   dh / 4 keys) and walks the group's H / Hk query heads over the query
//   tiles that can see its keys, recomputing P from LSE: dv += P^T . dO,
//   dk += dS^T . Q.  No atomics: every output element has one writer, so
//   the result is deterministic.
// Key tiles wholly above the diagonal or before the window of every row
// (and query tiles that see none of a block's keys) are skipped; the
// ragged edges at T and S are masked, so T and S take any value.
//
// What bounds it on an H100: the five products (s twice, dP twice, dq,
// dk, dv) are 2 * 5 * dh * H * B FLOPs for each (query, key) pair the
// mask leaves; at MiniCPM-2B's training shape (B = 8, T = 64, H = Hk =
// 36, dh = 64) that is 0.38 GFLOP, 0.39 us at the bf16 tensor-core rate,
// against 18.9 MB of q, k, v, out, dout, dq, dk, dv in bf16 (5.6 us at
// HBM bandwidth): bytes bound the function.  This design runs the
// products on the CUDA cores (67 TFLOP/s in fp32 at best), reads each
// tile into shared memory element by element and recomputes s in both
// kernels; moving the products to wgmma, loading tiles by TMA and
// emitting LSE from the forward are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;      // query rows a tile
constexpr int kBK = 64;      // keys a tile
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Whether query row t (of T) sees key j (of S).
__device__ __forceinline__ bool sees(int t, int j, int t_len, int s_len,
                                     int causal, int window) {
  if (t >= t_len || j >= s_len) return false;
  if (!causal) return true;
  const int pos = t + s_len - t_len;
  return j <= pos && (window == 0 || j > pos - window);
}

// Loads rows [row0, row0 + 64) of one head of x ([B, L, heads, DH]) into
// a padded fp32 tile; rows at or past L are zero.
template <int DH, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* x, int b,
                                          int row0, int len, int heads,
                                          int head) {
  constexpr int LD = DH + 1;
  for (int i = threadIdx.x; i < 64 * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, row = row0 + r;
    float val = 0.f;
    if (row < len)
      val = widen(x[((static_cast<size_t>(b) * len + row) * heads + head) *
                        DH + d]);
    dst[r * LD + d] = val;
  }
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (DH + 1) + kBQ * (kBK + 1) + 2 * kBQ);
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (DH + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, T* __restrict__ dq,
              float* __restrict__ lse_out, float* __restrict__ dsum_out,
              int t_len, int s_len, int heads, int kv_heads, int causal,
              int window, float scale) {
  constexpr int LD = DH + 1;
  constexpr int SLD = kBK + 1;
  constexpr int ROWS = kBQ * DH / kThreads;  // dq rows a thread
  constexpr int RSTEP = kThreads / DH;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sS = sV + kBK * LD;
  float* sLse = sS + kBQ * SLD;
  float* sD = sLse + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x;

  load_tile<DH>(sQ, q, b, q0, t_len, heads, h);
  load_tile<DH>(sdO, dout, b, q0, t_len, heads, h);
  load_tile<DH>(sV, o, b, q0, t_len, heads, h);  // O, for D only
  __syncthreads();
  if (tid < kBQ) {
    float acc = 0.f;
    for (int d = 0; d < DH; ++d) acc += sdO[tid * LD + d] * sV[tid * LD + d];
    sD[tid] = acc;
  }

  // the keys some row of the tile sees
  int k_lo = 0, k_hi = s_len;
  if (causal) {
    const int off = s_len - t_len;
    k_hi = min(s_len, min(q0 + kBQ, t_len) + off);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }
  const int k_first = (k_lo / kBK) * kBK;

  const int c = tid % kBK;   // this thread's key column of a tile
  const int rb = tid / kBK;  // and its first row (rows rb + 4 i)

  // pass 1: each row's log-sum-exp
  float m_run = -INFINITY, l_run = 0.f;
  for (int kt = k_first; kt < k_hi; kt += kBK) {
    __syncthreads();
    load_tile<DH>(sK, k, b, kt, s_len, kv_heads, hk);
    __syncthreads();
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float kv = sK[c * LD + d];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += sQ[(rb + 4 * i) * LD + d] * kv;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = rb + 4 * i;
      sS[r * SLD + c] = sees(q0 + r, kt + c, t_len, s_len, causal, window)
                            ? acc[i] * scale
                            : -INFINITY;
    }
    __syncthreads();
    if (tid < kBQ) {
      float mx = -INFINITY;
      for (int j = 0; j < kBK; ++j) mx = fmaxf(mx, sS[tid * SLD + j]);
      if (mx > -INFINITY) {
        const float m_new = fmaxf(m_run, mx);
        float sum = 0.f;
        for (int j = 0; j < kBK; ++j) sum += expf(sS[tid * SLD + j] - m_new);
        l_run = l_run * expf(m_run - m_new) + sum;
        m_run = m_new;
      }
    }
  }
  if (tid < kBQ) sLse[tid] = l_run > 0.f ? m_run + logf(l_run) : INFINITY;

  // pass 2: dS tile by tile, dq += dS . K
  const int dcol = tid % DH, rfirst = tid / DH;
  float dq_acc[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) dq_acc[j] = 0.f;
  for (int kt = k_first; kt < k_hi; kt += kBK) {
    __syncthreads();
    load_tile<DH>(sK, k, b, kt, s_len, kv_heads, hk);
    load_tile<DH>(sV, v, b, kt, s_len, kv_heads, hk);
    __syncthreads();
    float s_acc[16], dp_acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s_acc[i] = dp_acc[i] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float kv = sK[c * LD + d], vv = sV[c * LD + d];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = rb + 4 * i;
        s_acc[i] += sQ[r * LD + d] * kv;
        dp_acc[i] += sdO[r * LD + d] * vv;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = rb + 4 * i;
      float ds = 0.f;
      if (sees(q0 + r, kt + c, t_len, s_len, causal, window)) {
        const float p = expf(s_acc[i] * scale - sLse[r]);
        ds = p * (dp_acc[i] - sD[r]);
      }
      sS[r * SLD + c] = ds;
    }
    __syncthreads();
    for (int j = 0; j < kBK; ++j) {
      const float kv = sK[j * LD + dcol];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        dq_acc[i] += sS[(rfirst + RSTEP * i) * SLD + j] * kv;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = q0 + rfirst + RSTEP * i;
    if (t < t_len)
      dq[((static_cast<size_t>(b) * t_len + t) * heads + h) * DH + dcol] =
          narrow<T>(dq_acc[i] * scale);
  }
  if (tid < kBQ && q0 + tid < t_len) {
    const size_t at = (static_cast<size_t>(b) * heads + h) * t_len + q0 + tid;
    lse_out[at] = sLse[tid];
    dsum_out[at] = sD[tid];
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len,
               int heads, int kv_heads, int causal, int window, float scale) {
  constexpr int LD = DH + 1;
  constexpr int PLD = kBQ + 1;
  constexpr int COLS = kBK * DH / kThreads;  // dk, dv keys a thread
  constexpr int CSTEP = kThreads / DH;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;
  float* sdS = sP + kBK * PLD;
  float* sLse = sdS + kBK * PLD;
  float* sD = sLse + kBQ;

  const int c0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int group = heads / kv_heads;
  const int tid = threadIdx.x;

  load_tile<DH>(sK, k, b, c0, s_len, kv_heads, hk);
  load_tile<DH>(sV, v, b, c0, s_len, kv_heads, hk);

  // the query rows that see some key of the tile
  int i_lo = 0, i_hi = t_len;
  if (causal) {
    const int off = s_len - t_len;
    i_lo = max(0, c0 - off);
    if (window > 0) i_hi = min(t_len, min(c0 + kBK, s_len) - 1 + window - off);
  }
  const int i_first = (i_lo / kBQ) * kBQ;

  const int r = tid % kBQ;   // this thread's query row of a tile
  const int cb = tid / kBQ;  // and its first key (keys cb + 4 i)
  const int dcol = tid % DH, cfirst = tid / DH;
  float dk_acc[COLS], dv_acc[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = i_first; qt < i_hi; qt += kBQ) {
      __syncthreads();
      load_tile<DH>(sQ, q, b, qt, t_len, heads, h);
      load_tile<DH>(sdO, dout, b, qt, t_len, heads, h);
      if (tid < kBQ) {
        const int t = qt + tid;
        const size_t at = (static_cast<size_t>(b) * heads + h) * t_len + t;
        sLse[tid] = t < t_len ? lse[at] : INFINITY;
        sD[tid] = t < t_len ? dsum[at] : 0.f;
      }
      __syncthreads();
      float s_acc[16], dp_acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s_acc[i] = dp_acc[i] = 0.f;
      for (int d = 0; d < DH; ++d) {
        const float qv = sQ[r * LD + d], dov = sdO[r * LD + d];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int cc = cb + 4 * i;
          s_acc[i] += sK[cc * LD + d] * qv;
          dp_acc[i] += sV[cc * LD + d] * dov;
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int cc = cb + 4 * i;
        float p = 0.f, ds = 0.f;
        if (sees(qt + r, c0 + cc, t_len, s_len, causal, window)) {
          p = expf(s_acc[i] * scale - sLse[r]);
          ds = p * (dp_acc[i] - sD[r]);
        }
        sP[cc * PLD + r] = p;
        sdS[cc * PLD + r] = ds;
      }
      __syncthreads();
      for (int j = 0; j < kBQ; ++j) {
        const float qv = sQ[j * LD + dcol], dov = sdO[j * LD + dcol];
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
          const int cc = cfirst + CSTEP * i;
          dv_acc[i] += sP[cc * PLD + j] * dov;
          dk_acc[i] += sdS[cc * PLD + j] * qv;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    const int j = c0 + cfirst + CSTEP * i;
    if (j < s_len) {
      const size_t at =
          ((static_cast<size_t>(b) * s_len + j) * kv_heads + hk) * DH + dcol;
      dk[at] = narrow<T>(dk_acc[i] * scale);
      dv[at] = narrow<T>(dv_acc[i]);
    }
  }
}

template <int DH, typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, void* dq, void* dk, void* dv, float* lse,
                 float* dsum, int batch, int t_len, int s_len, int heads,
                 int kv_heads, int causal, int window, float scale,
                 cudaStream_t stream) {
  constexpr size_t a_bytes = dq_smem_bytes<DH>();
  constexpr size_t b_bytes = dkv_smem_bytes<DH>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(dkv_kernel<DH, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(b_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid_a((t_len + kBQ - 1) / kBQ, heads, batch);
  dq_kernel<DH, T><<<grid_a, kThreads, a_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq), lse, dsum, t_len,
      s_len, heads, kv_heads, causal, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b((s_len + kBK - 1) / kBK, kv_heads, batch);
  dkv_kernel<DH, T><<<grid_b, kThreads, b_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), t_len, s_len, heads,
      kv_heads, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* dsum, int batch, int t_len, int s_len, int heads,
           int kv_heads, int causal, int window, int dtype, float scale,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_typed<DH, float>(q, k, v, o, dout, dq, dk, dv, lse, dsum,
                                   batch, t_len, s_len, heads, kv_heads,
                                   causal, window, scale, stream);
  if (dtype == 1)
    return launch_typed<DH, __nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse,
                                           dsum, batch, t_len, s_len, heads,
                                           kv_heads, causal, window, scale,
                                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dq [B, T, H, dh] and dk, dv [B, S, Hk, dh] in the inputs' dtype (0:
// float32, 1: bfloat16); lse and dsum are fp32 scratch of B * H * T
// floats.  Launches two kernels on ``stream``; returns a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* dsum, int batch,
                                   int t_len, int s_len, int heads,
                                   int kv_heads, int head_dim, int causal,
                                   int window, int dtype, float scale,
                                   void* stream) {
  if (batch <= 0 || t_len <= 0 || s_len <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || heads > 65535 ||
      batch > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* ds = static_cast<float*>(dsum);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, out, dout, dq, dk, dv, l, ds, batch, t_len,
                        s_len, heads, kv_heads, causal, window, dtype, scale,
                        s);
    case 64:
      return launch<64>(q, k, v, out, dout, dq, dk, dv, l, ds, batch, t_len,
                        s_len, heads, kv_heads, causal, window, dtype, scale,
                        s);
    case 128:
      return launch<128>(q, k, v, out, dout, dq, dk, dv, l, ds, batch, t_len,
                         s_len, heads, kv_heads, causal, window, dtype, scale,
                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
