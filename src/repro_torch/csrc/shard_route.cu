// Shard routing, and the stable partition of a batch by shard.
//
// shard_route: the shard id of every key, one thread per key.
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
// about 0.015 us at 3.35 TB/s.  A launch costs about a microsecond
// whatever it does, so it is launch-bound; the design keeps it to one
// launch a call, with no padding of the batch.
//
// shard_partition: the route of every key (the same `route` as
// shard_route), the stable sort-by-shard permutation `order` and the
// per-shard run offsets, bit for bit the JAX package's
// kernels/partition/ref.py partition_ref (order as int32).  The JAX
// package computes it on the host (route, np.argsort(kind="stable"),
// bincount, cumsum); the sharded plan path used to route on the card,
// copy the ids back and split the plan with S masked passes on the host.
// Here the whole of it runs where the keys already are.
//
// The ranking.  A warp owns kKeys * 32 consecutive keys and holds them in
// registers: in round j, lane l holds key first + 32 * j + l.  A key's
// rank among the warp's keys of its shard, in key order, is the warp's
// count of that shard in earlier rounds plus its peers in lower lanes
// (__match_any_sync over the shard id); the lowest peer then adds the
// peers to the warp's count, a cell of a shared table [S][warps].  An
// exclusive scan in shard-major, then warp order gives every warp its
// base for every shard; each key writes its index to order[base + rank].
// Two forms:
//   * one cluster (Q <= kClusterKeys = 4096 and S <= kClusterMaxShards =
//     128, the sharded path's plans: Q = 4096, S = 8): one launch of a
//     cluster of 8 blocks of 128 threads, 512 keys a block.  Each block
//     ranks its keys over its own table [S][4 warps], scans each shard's
//     row over its warps and leaves its count of each shard in shared
//     memory; after a cluster barrier a thread a shard reads the 8
//     blocks' counts (distributed shared memory): the shard's run starts
//     after every key of a lower shard (a block-wide scan over the
//     shards, which block 0 writes out as the offsets), and this block's
//     keys of it after the earlier blocks' ones.  A second cluster barrier
//     keeps each block's counts alive until every block has read them;
//   * tiles (any other Q or S): kernel 1 routes each tile of kTileKeys =
//     1024 keys, writes the ids and the tile's count per shard into
//     scratch [S][tiles]; kernel 2, one block, scans that in place,
//     shard-major then tile order, and writes the offsets; kernel 3 ranks
//     each tile's keys as above over a table [S][8 warps] in dynamic
//     shared memory (32 * S bytes) and adds its tile's base.  S is at most
//     2^kMaxShardBits = 4096, a table of 128 KB (the port's limit P2:
//     every shard is a host PMem, and no path runs more than 8).
// On an H100 at Q = 4096, S = 8 (tools/route_tag_variants.py, PERF.md row
// 5p) one block of 1024 threads doing all of it took 0.0054-0.0067 ms in
// every form tried: routing 4096 keys, ranking them and storing their
// places on one SM took some 11,000 cycles.  A cluster spreads that over
// 8 SMs.
//
// What bounds it on an H100: 16 bytes a key (the key in, its id and its
// place out) and the offsets, 64 KB at Q = 4096: 0.02 us at 3.35 TB/s.
// The cluster form is latency-bound: a launch, the keys' load, the
// ranking's rounds and the block and cluster barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;     // shard_route's threads a block
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kKeys = 4;        // keys a lane holds in the partition
constexpr int kClusterKeys = 4096;  // the cluster form: Q <= 4096
constexpr int kClusterMaxShards = 128;  // and S <= 128
constexpr int kClusterBlocks = 8;   // one cluster of 8 blocks
constexpr int kClusterThreads = kClusterKeys / kClusterBlocks / kKeys;
constexpr int kClusterWarps = kClusterThreads / kWarp;
static_assert(kClusterMaxShards <= kClusterThreads, "a thread a shard");
constexpr int kTileWarps = 8;   // the tiled form: blocks of 256 threads
constexpr int kTileKeys = kTileWarps * kWarp * kKeys;  // 1024
constexpr int kScanThreads = 1024;
constexpr int kMaxShardBits = 12;
constexpr int kDefaultShared = 48 * 1024;

__device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// A key's shard: 0 with one shard, the top `bits` of splitmix64 when
// shift < 0, else key bits [shift, shift + bits).
__device__ __forceinline__ int route(uint64_t key, int bits, int shift) {
  if (bits == 0) return 0;
  return static_cast<int>(shift < 0 ? mix64(key) >> (64 - bits)
                                    : (key >> shift) & ((1ull << bits) - 1));
}

__global__ void __launch_bounds__(kBlock)
shard_route_kernel(const int64_t* __restrict__ keys, int64_t n, int bits,
                   int shift, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  out[i] = route(static_cast<uint64_t>(keys[i]), bits, shift);
}

// The lane's kKeys keys from `first` (key first + 32 * j in round j),
// routed; -1 past the batch's end.
__device__ __forceinline__ void route_lane(const int64_t* __restrict__ keys,
                                           int64_t first, int n, int bits,
                                           int shift, int (&shard)[kKeys]) {
  uint64_t key[kKeys];
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int64_t i = first + j * kWarp;
    key[j] = i < n ? static_cast<uint64_t>(__ldg(keys + i)) : 0;
  }
#pragma unroll
  for (int j = 0; j < kKeys; ++j)
    shard[j] = first + j * kWarp < n ? route(key[j], bits, shift) : -1;
}

// Each key's rank among the warp's keys of its shard, in key order; the
// warp's count of each shard is kept in cnt[s * stride] (zero before).
__device__ __forceinline__ void warp_ranks(const int (&shard)[kKeys],
                                           int (&rank)[kKeys], int* cnt,
                                           int stride, int lane) {
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int s = shard[j];
    const unsigned peers = __match_any_sync(kFull, s);
    if (s >= 0) rank[j] = cnt[s * stride] + __popc(peers & below);
    __syncwarp();
    if (s >= 0 && !(peers & below)) cnt[s * stride] += __popc(peers);
    __syncwarp();
  }
}

// The exclusive prefix of v over the block's threads; `sums` holds one
// int a warp.  Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive(int v, int* sums) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  int x = v;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == kWarp - 1) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < warps ? sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += y;
    }
    sums[lane] = t;
  }
  __syncthreads();
  const int out = (warp ? sums[warp - 1] : 0) + x - v;
  __syncthreads();
  return out;
}

// Exclusive scan of a[0, m) in place, each thread over a contiguous
// chunk.  Call between two block barriers.
__device__ __forceinline__ void scan_in_place(int* a, int64_t m, int* sums) {
  const int64_t per = (m + blockDim.x - 1) / blockDim.x;
  const int64_t lo = min(m, threadIdx.x * per), hi = min(m, lo + per);
  int sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += a[i];
  int run = block_exclusive(sum, sums);
  for (int64_t i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// The int at the same shared-memory offset as p in block `rank` of the
// cluster.
__device__ __forceinline__ int ld_cluster(const int* p, int rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// The cluster form: the grid is one cluster of kClusterBlocks blocks,
// block r holding keys [r * 512, (r + 1) * 512).  Each block ranks its
// keys over its own table [S][warps] and leaves its count of each shard
// in shared memory; after a cluster barrier every block reads all the
// blocks' counts (distributed shared memory): a shard's run starts after
// every key of a lower shard, and this block's keys of the shard after
// the earlier blocks' ones.
__global__ void __launch_bounds__(kClusterThreads)
partition_cluster_kernel(const int64_t* __restrict__ keys, int n, int bits,
                         int shift, int32_t* __restrict__ shards,
                         int32_t* __restrict__ order,
                         int32_t* __restrict__ offsets) {
  __shared__ int table[kClusterMaxShards * kClusterWarps];  // [S][warps]
  __shared__ int total[kClusterMaxShards];  // this block's keys of each shard
  __shared__ int base[kClusterMaxShards];   // where they go
  __shared__ int sums[kWarp];
  const int n_shards = 1 << bits, cells = n_shards * kClusterWarps;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int first = blockIdx.x * kClusterThreads * kKeys +
                    warp * kWarp * kKeys + lane;
  int shard[kKeys], rank[kKeys];
  route_lane(keys, first, n, bits, shift, shard);
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0;
  __syncthreads();
  warp_ranks(shard, rank, table + warp, kClusterWarps, lane);
  __syncthreads();
  const int s = threadIdx.x;  // a thread a shard: S <= the block
  if (s < n_shards) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kClusterWarps; ++w) {
      const int c = table[s * kClusterWarps + w];
      table[s * kClusterWarps + w] = run;
      run += c;
    }
    total[s] = run;
  }
  cluster_sync();  // every block's counts are in place
  int before = 0, all = 0;
  if (s < n_shards) {
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r) {
      const int c = ld_cluster(total + s, r);
      all += c;
      if (r < static_cast<int>(blockIdx.x)) before += c;
    }
  }
  cluster_arrive();  // done with the other blocks' shared memory
  const int below = block_exclusive(s < n_shards ? all : 0, sums);
  if (s < n_shards) {
    base[s] = below + before;
    if (blockIdx.x == 0) offsets[s] = below;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) offsets[n_shards] = n;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int sj = shard[j], i = first + j * kWarp;
    if (sj < 0) continue;
    shards[i] = sj;
    order[base[sj] + table[sj * kClusterWarps + warp] + rank[j]] = i;
  }
  cluster_wait();  // no block leaves while another may read its counts
}

// Tiled form, kernel 1: each tile's ids, and its count of each shard at
// counts[s * tiles + tile].
__global__ void __launch_bounds__(kTileWarps * kWarp)
partition_count_kernel(const int64_t* __restrict__ keys, int n, int bits,
                       int shift, int32_t* __restrict__ shards,
                       int32_t* __restrict__ counts) {
  extern __shared__ int cnt[];  // [S]
  const int n_shards = 1 << bits, tiles = gridDim.x;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTileKeys +
                        warp * kWarp * kKeys + lane;
  int shard[kKeys];
  route_lane(keys, first, n, bits, shift, shard);
  for (int c = threadIdx.x; c < n_shards; c += blockDim.x) cnt[c] = 0;
  __syncthreads();
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int s = shard[j];
    if (s >= 0) shards[first + j * kWarp] = s;
    const unsigned peers = __match_any_sync(kFull, s);
    if (s >= 0 && !(peers & below)) atomicAdd(cnt + s, __popc(peers));
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_shards; s += blockDim.x)
    counts[static_cast<int64_t>(s) * tiles + blockIdx.x] = cnt[s];
}

// Tiled form, kernel 2 (one block): every tile's base for every shard,
// in place, and the offsets.  With no tiles (an empty batch), the
// offsets alone.
__global__ void __launch_bounds__(kScanThreads)
partition_scan_kernel(int32_t* __restrict__ counts, int tiles, int bits,
                      int n, int32_t* __restrict__ offsets) {
  __shared__ int sums[kWarp];
  const int n_shards = 1 << bits;
  scan_in_place(counts, static_cast<int64_t>(n_shards) * tiles, sums);
  __syncthreads();
  for (int s = threadIdx.x; s < n_shards; s += blockDim.x)
    offsets[s] = tiles ? counts[static_cast<int64_t>(s) * tiles] : 0;
  if (threadIdx.x == 0) offsets[n_shards] = n;
}

// Tiled form, kernel 3: each key's place, its tile's base plus its
// warp's base within the tile plus its rank.
__global__ void __launch_bounds__(kTileWarps * kWarp)
partition_scatter_kernel(const int32_t* __restrict__ shards, int n,
                         int bits, const int32_t* __restrict__ bases,
                         int32_t* __restrict__ order) {
  extern __shared__ int table[];  // [S][warps of the tile]
  const int n_shards = 1 << bits, tiles = gridDim.x;
  const int cells = n_shards * kTileWarps;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTileKeys +
                        warp * kWarp * kKeys + lane;
  int shard[kKeys], rank[kKeys];
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int64_t i = first + j * kWarp;
    shard[j] = i < n ? __ldg(shards + i) : -1;
  }
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0;
  __syncthreads();
  warp_ranks(shard, rank, table + warp, kTileWarps, lane);
  __syncthreads();
  for (int s = threadIdx.x; s < n_shards; s += blockDim.x) {
    int run = __ldg(bases + static_cast<int64_t>(s) * tiles + blockIdx.x);
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const int c = table[s * kTileWarps + w];
      table[s * kTileWarps + w] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int s = shard[j];
    if (s >= 0)
      order[table[s * kTileWarps + warp] + rank[j]] =
          static_cast<int32_t>(first + j * kWarp);
  }
}

bool bad_route(int bits, int shift) {
  return bits < 0 || bits > 31 || shift > 63 ||
         (shift >= 0 && shift + bits > 63);
}

bool one_cluster(long long n, int bits) {
  return n <= kClusterKeys && (1 << bits) <= kClusterMaxShards;
}

long long tiles_of(long long n) { return (n + kTileKeys - 1) / kTileKeys; }

}  // namespace

// C interface, loaded with ctypes.  `shift` < 0 selects the hash route.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int shard_route(const void* keys, long long n, int bits,
                           int shift, void* out, void* stream) {
  if (n <= 0) return 0;
  if (bad_route(bits, shift)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kBlock - 1) / kBlock));
  shard_route_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n, bits, shift,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of device scratch shard_partition needs: 0 in the one-block
// form, the tiles' counts [S][tiles] otherwise.
extern "C" long long shard_partition_scratch_bytes(long long n, int bits) {
  if (n < 0 || bits < 0 || bits > kMaxShardBits) return -1;
  return one_cluster(n, bits) ? 0 : (tiles_of(n) << bits) * 4;
}

// keys: [n] int64; shards, order: [n] int32; offsets: [2^bits + 1] int32;
// scratch: shard_partition_scratch_bytes(n, bits) bytes (null when 0).
// n < 2^31.  One kernel launch, or three in the tiled form (one for an
// empty batch), on `stream`;
// does not synchronise; returns cudaGetLastError() after the last.
extern "C" int shard_partition(const void* keys, long long n, int bits,
                               int shift, void* shards, void* order,
                               void* offsets, void* scratch, void* stream) {
  if (n < 0 || n > 0x7fffffffll || bad_route(bits, shift) ||
      bits > kMaxShardBits)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int64_t*>(keys);
  auto* ids = static_cast<int32_t*>(shards);
  auto* pos = static_cast<int32_t*>(order);
  auto* off = static_cast<int32_t*>(offsets);
  const int nn = static_cast<int>(n);
  if (one_cluster(n, bits)) {
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = kClusterBlocks;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(kClusterBlocks);
    config.blockDim = dim3(kClusterThreads);
    config.stream = s;
    config.attrs = &cluster;
    config.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&config, partition_cluster_kernel,
                                             k, nn, bits, shift, ids, pos,
                                             off);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = static_cast<int>(tiles_of(n));
  auto* counts = static_cast<int32_t*>(scratch);
  if (tiles == 0) {
    partition_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, 0, bits, 0, off);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t table = static_cast<size_t>(4) * (1 << bits);
  partition_count_kernel<<<tiles, kTileWarps * kWarp, table, s>>>(
      k, nn, bits, shift, ids, counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  partition_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, tiles, bits, nn,
                                                   off);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t tile_table = table * kTileWarps;
  if (tile_table > kDefaultShared) {
    e = cudaFuncSetAttribute(partition_scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tile_table));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  partition_scatter_kernel<<<tiles, kTileWarps * kWarp, tile_table, s>>>(
      ids, nn, bits, counts, pos);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* shard_route_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
