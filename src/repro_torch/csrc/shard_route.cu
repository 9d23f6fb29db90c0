// Shard routing: the shard id of every key, one thread per key.
//
// Replaces, in the JAX package, src/repro/kernels/partition/kernel.py
// shard_route (_route_kernel).  The TPU form carries each key as (lo, hi)
// int32 halves, runs splitmix64 on 16-bit limbs with explicit carries,
// splits `prefix@<m>` into three cases by where the routed bits fall
// among the halves, and pads the batch to whole blocks of 4096.  Here
// 64-bit words are native: splitmix64 is three xor-shifts and two
// wrapping multiplies on `unsigned long long`, and a prefix route is one
// shift and mask of the whole word.  Exactly Q threads run.
//
// Semantics, bit for bit those of the TPU kernel and of the numpy
// route_ref:
//   * bits == 0 (one shard): 0 for every key;
//   * hash (shift < 0): the top `bits` of splitmix64(key);
//   * prefix (shift >= 0): key bits [shift, shift + bits), shift being
//     msb + 1 - bits for `prefix` (msb 62) or `prefix@<msb>`.  The shift
//     is logical; the routed bits lie at or below bit 62, so an
//     arithmetic shift would give the same ids.
//
// What bounds it on an H100: 12 bytes a key (read 8, write 4) and about
// 15 integer operations, so at the main path's Q = 4096 it moves 48 KB,
// about 0.015 us at 3.35 TB/s.  A launch costs a few microseconds
// whatever it does, so it is launch-bound; the design keeps it to one
// launch a plan, with no padding of the batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

__global__ void __launch_bounds__(kBlock)
shard_route_kernel(const int64_t* __restrict__ keys, int64_t n, int bits,
                   int shift, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  if (bits == 0) {
    out[i] = 0;
    return;
  }
  const uint64_t key = static_cast<uint64_t>(keys[i]);
  const uint64_t shard = shift < 0
      ? mix64(key) >> (64 - bits)
      : (key >> shift) & ((1ull << bits) - 1);
  out[i] = static_cast<int32_t>(shard);
}

}  // namespace

// C interface, loaded with ctypes.  `shift` < 0 selects the hash route.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int shard_route(const void* keys, long long n, int bits,
                           int shift, void* out, void* stream) {
  if (n <= 0) return 0;
  if (bits < 0 || bits > 31 || shift > 63 || (shift >= 0 && shift + bits > 63))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kBlock - 1) / kBlock));
  shard_route_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n, bits, shift,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* shard_route_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
