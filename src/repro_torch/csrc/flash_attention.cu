// Causal / sliding-window attention forward (prefill), online softmax
// over tiles of keys.
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
//   * q, k, v are read exactly; scores s = (q . k) * scale in fp32;
//     softmax and the P.V product in fp32; the output is stored in q's
//     dtype;
//   * causal: query row i sits at position i + S - T (right-aligned) and
//     sees key j iff j <= pos, and with a window w also j > pos - w; the
//     window applies only with causal, as in the TPU kernel;
//   * out = acc / max(l, 1e-30): a row that sees no key (T > S) is 0.
//   Tiles of keys that lie wholly above the diagonal or before the window
//   of every row of the block are never loaded.
//
// What bounds it on an H100: at the prefill shapes of Qwen2-0.5B (H = 14,
// Hk = 2, dh = 64, T = S = 256-512) a layer's attention is
// 2 * 2 * T^2 * dh * H / 2 FLOPs, 0.47 GFLOP at T = 512 (0.47 us at the
// bf16 tensor-core rate), against 2.1 MB of q, k, v and output in bf16
// (0.63 us at HBM bandwidth).  Only the tensor cores reach that FLOP
// rate, so the bf16 kernel does both products there; fp32 inputs take
// the CUDA cores (see below).
//
// Two kernels, chosen by the dtype argument of the C interface:
//
// bfloat16 (the model's path): warpgroup MMA fed by TMA.  A block owns 64
// query rows of one (batch, head); 128 threads (one warpgroup) compute,
// and one more warp loads.  The producer warp's first lane loads the q
// tile once and then each 64-key tile of k and v by TMA (3-D tensor maps
// [B, T, H*dh] and [B, S, Hk*dh], box (1, 64, dh), so rows past T or S
// are zero-filled and never the next batch's) into a ring of kStages
// stages, each guarded by a "full" mbarrier (transaction bytes) and an
// "empty" one (the 128 consumers arrive when done with it).  Tiles are
// 128-byte swizzled (64-byte at dh = 32; dh = 128 is two 64-column
// blocks), the layout the wgmma descriptors name.  For each key tile the
// warpgroup issues S = Q.K^T as wgmma m64n64k16 with both operands in
// shared memory (K rows are dh-contiguous: K-major B), then runs the
// online softmax in the accumulator's register layout (each thread holds
// two rows; row max and row sum take two quad shuffles; exp2 of scores
// pre-scaled by log2 e), and issues O += P.V as wgmma m64n{dh}k16 with P
// from registers and V read transposed from shared memory.  P stays at
// fp32 precision: it goes in as P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// two products into the same fp32 accumulator (about 16 bits of P, one
// more product per tile); a P rounded once to bf16 would be a different
// function from the TPU kernel's fp32 P.V.  Row max starts at -1e30, not
// -inf, so a row that sees no key gives 0, not NaN.  Only live rows are
// stored.
//
// float32: the CUDA cores, 128 threads per 32 query rows, 4 threads per
// row.  Thread r of a row owns the columns c = r + 4 i of q and of the
// accumulator; a tile of 64 keys (32 when dh = 128) is staged in shared
// memory; each row's four threads form each score with two shuffles.
// TF32 tensor cores would keep about three digits, and fp32 callers
// (the card tests, the fp32 card-vs-CPU checks) hold the kernel to
// 1e-5, so fp32 stays exact fp32.
//
// What bounds it now: at T = 512 the longest block (the last 64 rows)
// walks 8 key tiles one after another, each a Q.K^T, a softmax and a
// P.V that wait on one another; the grid is 112 blocks on 132 SMs.
// Issuing the next tile's Q.K^T before this tile's softmax (two score
// buffers) gained nothing at T = 512 on an H100 and lost at T = 2048,
// so the loop stays serial.  Left for later: a second consumer
// warpgroup (two 64-row tiles taking turns on the tensor cores), and a
// persistent grid that balances the causal triangle's long and short
// rows.

#include <cuda.h>  // CUtensorMap and its enums; the CUDA driver via dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;

// ---- float32: CUDA cores ------------------------------------------------

constexpr int kRows = 32;    // query rows per block
constexpr int kLanes = 4;    // threads per query row
constexpr int kSimtThreads = kRows * kLanes;

template <int kDh>
__global__ void __launch_bounds__(kSimtThreads)
simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out, int t_len,
            int s_len, int heads, int kv_heads, int causal, int window,
            float scale) {
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
    qr[c] = live ? q[qbase + lane + kLanes * c] : 0.f;
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
    for (int i = threadIdx.x; i < kKeys * kDh; i += kSimtThreads) {
      const int j = i / kDh;
      const int c = i - j * kDh;
      const int s = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < s_len) {
        const int64_t o = kv_base + s * kv_row + c;
        kv = k[o];
        vv = v[o];
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
      out[qbase + lane + kLanes * c] = acc[c] * inv;
  }
}

template <int kDh>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int batch, int t_len, int s_len, int heads, int kv_heads,
                int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((t_len + kRows - 1) / kRows, batch * heads);
  simt_kernel<kDh><<<grid, kSimtThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), t_len, s_len,
      heads, kv_heads, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16: wgmma fed by TMA -----------------------------------------

constexpr int kTile = 64;       // query rows of a block; keys of a stage
constexpr int kStages = 3;      // ring of k/v stages
constexpr int kConsumers = 128;  // one warpgroup computes
constexpr int kTcThreads = kConsumers + 32;  // and one warp loads

// The shared-memory layout of one [64, dh] bf16 tile, as TMA writes it
// and the wgmma descriptors read it: kAtoms column blocks of kCols
// columns, each 64 rows of kRowBytes, swizzled at kRowBytes.
template <int kDh>
struct Tile {
  static constexpr int kCols = kDh < 64 ? kDh : 64;
  static constexpr int kRowBytes = 2 * kCols;  // 64 or 128
  static constexpr int kAtoms = kDh / kCols;
  static constexpr int kBlockBytes = kTile * kRowBytes;
  static constexpr int kBytes = kAtoms * kBlockBytes;
  // descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  // q, kStages k and v tiles, 1024-byte aligned; the barriers; and the
  // slack to align the dynamic shared memory's base
  static constexpr int kSmem =
      (1 + 2 * kStages) * kBytes + (2 * kStages + 1) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one TMA box of `map` at (c0, c1, c2), innermost first, into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator above the wait
template <int kN>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout type
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// K-major operand (q as A, k as B of Q.K^T), dh columns 16 kk .. 16 kk + 15
template <int kDh>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using L = Tile<kDh>;
  const int col = 16 * kk;
  return make_desc(tile + (col / L::kCols) * L::kBlockBytes +
                       (col % L::kCols) * 2,
                   16, 8 * L::kRowBytes, L::kLayout);
}

// MN-major operand (v as B of P.V), keys 16 kk .. 16 kk + 15: 8-key
// groups kRowBytes * 8 apart, column blocks kBlockBytes apart
template <int kDh>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using L = Tile<kDh>;
  return make_desc(tile + 16 * kk * L::kRowBytes, L::kBlockBytes,
                   8 * L::kRowBytes, L::kLayout);
}

// d (+)= A . B^T over k = 16: A [64 x 16] and B [64 x 16] K-major in
// shared memory (descriptors a, b); d is 32 fp32 registers a thread
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A . B over k = 16: A [64 x 16] bf16 in registers (4 a thread), B
// [16 x 32] MN-major in shared memory (descriptor b, transposed)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A . B over k = 16: A [64 x 16] bf16 in registers (4 a thread), B
// [16 x 64] MN-major in shared memory (descriptor b, transposed)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A . B over k = 16: A [64 x 16] bf16 in registers (4 a thread), B
// [16 x 128] MN-major in shared memory (descriptor b, transposed)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int kDh>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (kDh == 32) {
    wgmma_rs_n32(o, a, b);
  } else if constexpr (kDh == 64) {
    wgmma_rs_n64(o, a, b);
  } else {
    wgmma_rs_n128(o, a, b);
  }
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi, y - hi),
// the low half holding x
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int s_len,
                                        int causal, int window) {
  return kpos < s_len &&
         (!causal || (kpos <= qpos && (window <= 0 || kpos > qpos - window)));
}

template <int kDh>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          __nv_bfloat16* __restrict__ out, int t_len, int s_len, int heads,
          int kv_heads, int causal, int window, float scale_log2) {
  using L = Tile<kDh>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kBytes;  // k stages, then v stages
  const uint32_t bars = base + (1 + 2 * kStages) * L::kBytes;
  const uint32_t qbar = bars + 16 * kStages;
  // full[st] at bars + 8 st, empty[st] at bars + 8 (kStages + st)

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int off = s_len - t_len;

  // keys any row of this block can see, in whole tiles
  int kv_lo = 0, kv_hi = s_len;
  if (causal) {
    const int last_row = min(q0 + kTile, t_len) - 1;
    kv_hi = min(s_len, last_row + off + 1);
    if (window > 0) kv_lo = max(0, q0 + off - window + 1);
  }
  const int t_first = (kv_lo / kTile) * kTile;
  const int n_tiles = kv_hi > t_first ? (kv_hi - t_first + kTile - 1) / kTile
                                      : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer: one lane keeps the ring of stages full
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(qbar, L::kBytes);
#pragma unroll
      for (int a = 0; a < L::kAtoms; ++a)
        tma_load(q_s + a * L::kBlockBytes, &qmap, qbar,
                 h * kDh + a * L::kCols, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(bars + 8 * (kStages + st),
                                    (i / kStages - 1) & 1);
        const uint32_t full = bars + 8 * st;
        mbar_expect_tx(full, 2 * L::kBytes);
        const int t0 = t_first + i * kTile;
        const uint32_t ks = kv_s + st * L::kBytes;
        const uint32_t vs = kv_s + (kStages + st) * L::kBytes;
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(ks + a * L::kBlockBytes, &kmap, full,
                   hk * kDh + a * L::kCols, t0, b);
          tma_load(vs + a * L::kBlockBytes, &vmap, full,
                   hk * kDh + a * L::kCols, t0, b);
        }
      }
    }
    return;
  }

  // the consumers: thread t holds rows r0 = 16 (t / 32) + (t % 32) / 4
  // and r1 = r0 + 8 of the tile, columns 8 j + cq and 8 j + cq + 1
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int pos0 = q0 + r0 + off;
  const int pos1 = pos0 + 8;
  float o[kDh / 2];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) o[i] = 0.f;
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int t0 = t_first + i * kTile;
    const uint32_t ks = kv_s + st * L::kBytes;
    const uint32_t vs = kv_s + (kStages + st) * L::kBytes;
    mbar_wait(bars + 8 * st, (i / kStages) & 1);

    // S = Q . K^T
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<kDh>(q_s, kk), kmajor_desc<kDh>(ks, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(s);

    // scores in log2 units, masked where some row of the tile may not
    // see some key of it
    const bool whole =
        t0 + kTile <= s_len &&
        (!causal || (t0 + kTile - 1 <= q0 + off &&
                     (window <= 0 || t0 > q0 + kTile - 1 + off - window)));
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * j + e] * scale_log2;
        float x1 = s[4 * j + 2 + e] * scale_log2;
        if (!whole) {
          const int kpos = t0 + 8 * j + cq + e;
          if (!visible(kpos, pos0, s_len, causal, window)) x0 = -INFINITY;
          if (!visible(kpos, pos1, s_len, causal, window)) x1 = -INFINITY;
        }
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0);
    const float a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp2(S - m) as hi and lo bf16 A fragments: register 4 kk + q
    // of each holds the pair the A layout wants for keys 16 kk .. + 15
    uint32_t hi[16], lo[16];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = exp2f(s[4 * j] - mn0);  // a masked key gives 0
      const float p01 = exp2f(s[4 * j + 1] - mn0);
      const float p10 = exp2f(s[4 * j + 2] - mn1);
      const float p11 = exp2f(s[4 * j + 3] - mn1);
      ps0 += p00 + p01;
      ps1 += p10 + p11;
      split_bf16(p00, p01, hi[2 * j], lo[2 * j]);
      split_bf16(p10, p11, hi[2 * j + 1], lo[2 * j + 1]);
    }
    l0 = l0 * a0 + ps0;  // this thread's columns; summed over the quad
    l1 = l1 * a1 + ps1;  // at the end
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P_hi . V + P_lo . V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t vd = mnmajor_desc<kDh>(vs, kk);
      wgmma_pv<kDh>(o, &hi[4 * kk], vd);
      wgmma_pv<kDh>(o, &lo[4 * kk], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kDh / 2>(o);
    mbar_arrive(bars + 8 * (kStages + st));  // the stage may be refilled
  }

#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  const int64_t stride = static_cast<int64_t>(heads) * kDh;
  __nv_bfloat16* base0 = out + (static_cast<int64_t>(b) * t_len + row0) *
                                   stride + static_cast<int64_t>(h) * kDh;
  __nv_bfloat16* base1 = base0 + 8 * stride;
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    if (row0 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(base0 + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row1 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(base1 + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled, from the libcuda the process has
// loaded, so that the library needs no -lcuda at build time
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// a bf16 [batch, rows, width] tensor map with a box of (1, 64, cols)
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base,
              int width, int rows, int batch, int cols,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {2ull * width, 2ull * width * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(kTile), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kDh>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              int batch, int t_len, int s_len, int heads, int kv_heads,
              int causal, int window, float scale, cudaStream_t stream) {
  using L = Tile<kDh>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const CUtensorMapSwizzle swizzle = L::kRowBytes == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  // with no keys no k/v tile is loaded: the maps then describe a part
  // of q, so that they are valid
  const int rows = s_len > 0 ? s_len : 1;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(encode, &qmap, q, heads * kDh, t_len, batch, L::kCols,
                swizzle) ||
      !make_map(encode, &kmap, s_len > 0 ? k : q, kv_heads * kDh, rows,
                batch, L::kCols, swizzle) ||
      !make_map(encode, &vmap, s_len > 0 ? v : q, kv_heads * kDh, rows,
                batch, L::kCols, swizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      tc_kernel<kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((t_len + kTile - 1) / kTile, batch * heads);
  tc_kernel<kDh><<<grid, kTcThreads, L::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), t_len, s_len,
      heads, kv_heads, causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int t_len, int s_len, int heads, int kv_heads, int causal,
           int window, int dtype, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_simt<kDh>(q, k, v, out, batch, t_len, s_len, heads,
                            kv_heads, causal, window, scale, stream);
  if (dtype == 1)
    return launch_tc<kDh>(q, k, v, out, batch, t_len, s_len, heads,
                          kv_heads, causal, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, loaded with ctypes.  q: [batch, t_len, heads, head_dim];
// k, v: [batch, s_len, kv_heads, head_dim]; out like q; all contiguous,
// of one dtype (0 float32: the CUDA-core kernel; 1 bfloat16: the wgmma
// kernel, whose q, k and v must be 16-byte aligned for TMA).  window <= 0
// means none.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// dim other than 32, 64 or 128, another dtype, heads not a multiple of
// kv_heads, or a tensor map the CUDA driver refuses).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int t_len, int s_len,
                               int heads, int kv_heads, int head_dim,
                               int causal, int window, int dtype, float scale,
                               void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || batch * heads > 65535 ||
      s_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, out, batch, t_len, s_len, heads, kv_heads,
                        causal, window, dtype, scale, s);
    case 64:
      return launch<64>(q, k, v, out, batch, t_len, s_len, heads, kv_heads,
                        causal, window, dtype, scale, s);
    case 128:
      return launch<128>(q, k, v, out, batch, t_len, s_len, heads, kv_heads,
                         causal, window, dtype, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
