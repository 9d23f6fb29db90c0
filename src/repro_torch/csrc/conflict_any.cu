// Plan-conflict admission: for every candidate op of a set A, does it
// conflict with ANY op of a reference set B.
//
// Replaces, in the JAX package, src/repro/kernels/conflict/kernel.py
// conflict_any_kernel (_conflict_any_kernel).  The TPU form lays a block
// of 512 candidates down the sublanes and the whole of B along the lanes,
// compares [512, B] int32 key halves in one step, and pads both sets with
// a NONE kind.  Here keys are native 64-bit words, exactly A candidates
// run against exactly B references, and B is read in slices and chunks,
// so a tick's reference set may grow past what one block holds.
//
// The pairwise rule (kernels/conflict/ref.py conflict_matrix_ref), with
// W = PUT | UPDATE | DELETE:
//   same key and (GET a, W b  or  W a, GET b);
//   SCAN a, W b and key_b >= key_a   (b's write lands in a's window);
//   W a, SCAN b and key_a >= key_b;
//   with writes_conflict, same key and W a, W b.
// The order test is SIGNED 64-bit: the TPU kernel compares the high half
// as a signed int32 and the low half unsigned, which is long long order,
// the order numpy's int64 >= gives the oracle.  A key of 2^63 or above
// (negative as int64) is below every other key.
//
// Layout: a block holds kTile candidates, one a thread, and covers one
// slice of kSlice references (blockIdx.y).  The slice is staged through
// shared memory kChunk ops at a time (kind plus 64-bit key, 6 KB); every
// thread reads the same staged op at once, so the reads are broadcasts.
// A thread stops at its first conflict, and the block stops staging
// once every candidate in it has conflicted (__syncthreads_or).  The
// output is zeroed by the caller and a block writes 1 only where it
// found a conflict, so blocks of different slices never need to agree.
//
// What bounds it on an H100: A * B pair tests of about 12 integer
// operations each (50 M pairs at A = 4096, B = 12288), over 12 bytes an
// op of input.  The bytes are a few hundred KB; the pair tests are the
// work, so the grid is cut in both A and B to put all SMs on them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGet = 0, kPut = 1, kUpdate = 2, kDelete = 3, kScan = 4;
constexpr int kTile = 128;   // candidates per block, one a thread
constexpr int kChunk = 512;  // references staged in shared memory at once
constexpr int kSlice = 1024; // references per block (blockIdx.y)

__device__ __forceinline__ bool is_write(int kind) {
  return kind == kPut || kind == kUpdate || kind == kDelete;
}

__global__ void __launch_bounds__(kTile)
conflict_any_kernel(const int32_t* __restrict__ a_kinds,
                    const int64_t* __restrict__ a_keys, int64_t n_a,
                    const int32_t* __restrict__ b_kinds,
                    const int64_t* __restrict__ b_keys, int64_t n_b,
                    bool writes_conflict, bool* __restrict__ out) {
  __shared__ int32_t s_kind[kChunk];
  __shared__ long long s_key[kChunk];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const bool live = i < n_a;
  const int ka = live ? a_kinds[i] : -1;
  const long long key = live ? static_cast<long long>(a_keys[i]) : 0;
  const bool wa = is_write(ka), ga = ka == kGet, sa = ka == kScan;
  const long long begin = static_cast<long long>(blockIdx.y) * kSlice;
  const long long end = begin + kSlice < n_b ? begin + kSlice : n_b;
  bool conf = false;
  for (long long base = begin; base < end; base += kChunk) {
    // also the barrier before the chunk is overwritten
    if (!__syncthreads_or(live && !conf)) break;
    const int m = static_cast<int>(end - base < kChunk ? end - base
                                                       : kChunk);
    for (int j = threadIdx.x; j < m; j += kTile) {
      s_kind[j] = b_kinds[base + j];
      s_key[j] = static_cast<long long>(b_keys[base + j]);
    }
    __syncthreads();
    if (live && !conf) {
      for (int j = 0; j < m; ++j) {
        const int kb = s_kind[j];
        const long long kk = s_key[j];
        const bool wb = is_write(kb);
        const bool same = kk == key;
        bool c = same && ((ga && wb) || (wa && kb == kGet));
        c |= sa && wb && kk >= key;
        c |= wa && kb == kScan && key >= kk;
        c |= writes_conflict && same && wa && wb;
        if (c) {
          conf = true;
          break;
        }
      }
    }
  }
  if (conf) out[i] = true;
}

}  // namespace

// C interface, loaded with ctypes.  `out` must hold n_a zero bytes.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int conflict_any(const void* a_kinds, const void* a_keys,
                            long long n_a, const void* b_kinds,
                            const void* b_keys, long long n_b,
                            int writes_conflict, void* out, void* stream) {
  if (n_a <= 0 || n_b <= 0) return 0;
  const long long slices = (n_b + kSlice - 1) / kSlice;
  if (slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_a + kTile - 1) / kTile),
                  static_cast<unsigned>(slices));
  conflict_any_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_kinds),
      static_cast<const int64_t*>(a_keys), n_a,
      static_cast<const int32_t*>(b_kinds),
      static_cast<const int64_t*>(b_keys), n_b, writes_conflict != 0,
      static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conflict_any_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
