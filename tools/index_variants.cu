// Latency probes for tools/index_variants.py: the fixed cost of a launch
// and the latency of one round of dependent loads on the card.
//
//   * empty_kernel: n threads in blocks of `block`, doing nothing;
//   * chase_kernel: n threads in blocks of `block`, each following its
//     own chain of `hops` dependent 8-byte loads (p = table[p], read
//     through the non-coherent path as the index kernels read) from
//     starts[i], and storing where it ended so no load is dead.
//
// Built by the tool with src/repro_torch/build.py's flags and loaded with
// ctypes; each entry point launches on `stream`, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void empty_kernel() {}

__global__ void chase_kernel(const int64_t* __restrict__ table,
                             const int64_t* __restrict__ starts, int64_t n,
                             int hops, int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  int64_t p = __ldg(starts + i);
  for (int h = 0; h < hops; ++h) p = __ldg(table + p);
  out[i] = p;
}

unsigned blocks(long long n, int block) {
  return static_cast<unsigned>((n + block - 1) / block);
}

}  // namespace

extern "C" int empty(long long n, int block, void* stream) {
  empty_kernel<<<blocks(n, block), block, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chase(const void* table, const void* starts, long long n,
                     int hops, int block, void* out, void* stream) {
  chase_kernel<<<blocks(n, block), block, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<const int64_t*>(starts),
      n, hops, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
