#!/usr/bin/env python3
"""Time the partition and tag-probe kernels' designs on one card, against
the parent's, and the floors under them.

    python3 tools/route_tag_variants.py [--parent DIR] [--n-route N]
                                        [--route-plans P] [--seed S]

Builds, from ``csrc/clht_probe.cu`` and edited copies of it (and
``tools/index_variants.cu`` for the latency probes), and times with
``chip_smoke.time_calls`` (device time a call, its CUDA kernels and
copies timed by events around calls queued behind a sleep kernel):

* ``tag_probe`` on ``chip_smoke.py``'s tag path (2^19 tags in 2^18
  buckets, 8 waves of 4096 queries), which reads the table's three
  arrays (keys and values [R, 3], the next row [R]), against the same
  walk over one packed 32-byte line a row (the lines built here from the
  table), in turns (source, variant, variant, source),
  held bit-identical first; and the floor: an empty kernel plus the
  longest walk's rounds (the query's load and a round a row), at the
  latency of a round of dependent loads over 8 MB (in L2) measured here;
* ``shard_partition`` at the sharded path's shape (Q = 4096, S = 8,
  hash), and at S = 4096 and Q = 65536 (the tiled form), against edited
  copies: the first form of the one-launch design (one block of 1024
  threads; its phases also read from the SM's clock), clusters of 4 and
  2 blocks in place of 8, and each lane its own peer in place of
  ``__match_any_sync`` (no ranking: the result is wrong, the time is
  what ranking costs); and the floors: one
  block of 1024 threads crossing six barriers and nothing else, and one
  cluster of 8 blocks of 128 crossing six block barriers and two cluster
  barriers, each plus a round for the keys;
* with ``--parent DIR`` (a checkout of the commit before this design,
  e.g. ``git archive HEAD~1 src/repro_torch | tar -x -C DIR``), in turns
  on the same inputs: the parent's tag wave (``tag_windows`` and the
  parent's window kernel) against ``tag_probe``, each with its device
  operations counted; the parent's ``shard_route`` launch against
  ``shard_partition``; and, in child processes that import each tree's
  ``repro_torch`` (parent, this tree, the tiled form alone, the tiled
  form alone, this tree, parent; the tiled form alone is a copy of this
  tree's port whose partition never takes its one-cluster form), P-CLHT
  in 8 shards with mesh reads at ``--n-route`` keys: the mean
  ``route_ns`` and wall time of ``--route-plans`` YCSB-C plans on the
  mesh path and on the per-shard path (after one untimed plan each,
  which exports the shards' runs), and the device operations and copies
  of one plan of each.

Prints the card's name and power limit first.  Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
P, I, U, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
PLAN_OPS = 4096
BLOCK = 64  # the latency probes' blocks

# the walk over one packed 32-byte line a row (the row's 3 keys, its 3
# values, its next row and a zero), two 16-byte loads a round: faster
# than the source's three arrays, but it needs the lines built from the
# table and kept in step with it
PACKED_KERNEL = """
__global__ void __launch_bounds__(kTagThreads)
tag_probe_packed_kernel(const int32_t* __restrict__ queries,
                        const int4* __restrict__ lines, int n_queries,
                        unsigned n_buckets, bool* __restrict__ found,
                        int32_t* __restrict__ values) {
  const int i = blockIdx.x * kTagThreads + threadIdx.x;
  if (i >= n_queries) return;
  const int32_t q = __ldg(queries + i);
  unsigned z = static_cast<unsigned>(q) * kHashMul;
  z ^= z >> 16;
  int row = static_cast<int>(z % n_buckets);
  for (int d = 0; d < kChainDepth && row >= 0; ++d) {
    // keys in a.x, a.y, a.z; values in a.w, b.x, b.y; the next row b.z
    const int4 a = __ldg(lines + 2 * static_cast<size_t>(row));
    const int4 b = __ldg(lines + 2 * static_cast<size_t>(row) + 1);
    const int hit = first_hit(static_cast<unsigned>(a.x == q) |
                              static_cast<unsigned>(a.y == q) << 1 |
                              static_cast<unsigned>(a.z == q) << 2);
    if (hit >= 0) {
      found[i] = true;
      values[i] = hit == 0 ? a.w : hit == 1 ? b.x : b.y;
      return;
    }
    row = b.z;
  }
  found[i] = q == 0;
  values[i] = 0;
}
"""
PACKED_ENTRY = """
extern "C" int tag_probe_packed(const void* queries, const void* lines,
                                int n_queries, unsigned n_buckets,
                                void* found, void* values, void* stream) {
  tag_probe_packed_kernel<<<(n_queries + kTagThreads - 1) / kTagThreads,
                            kTagThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(queries), static_cast<const int4*>(lines),
      n_queries, n_buckets, static_cast<bool*>(found),
      static_cast<int32_t*>(values));
  return static_cast<int>(cudaGetLastError());
}
"""
# the partition with its one-cluster form switched off: every shape takes
# the tiled form (three kernels and a scan)
ONE_CLUSTER = "return n <= kClusterKeys && (1 << bits) <= kClusterMaxShards;"
MATCH_PEERS = "__match_any_sync(kFull, s)"


def edited(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"route_tag_variants: an edit no longer "
                             f"applies: {old[:60]!r}")
        src = src.replace(old, new)
    return src


# the first form, the one-launch design before the cluster: one block of
# 1024 threads, four keys a thread, the ranks through one table [S][32
# warps], a block-wide scan, each key's place stored straight from it;
# launched in place of the cluster (Q <= 4096, S <= 128).  @k marks where
# the timeline copy has thread 0 read the SM's clock after a barrier.
FIRST_FORM = """
__global__ void __launch_bounds__(1024)
partition_one_kernel(const int64_t* __restrict__ keys, int n, int bits,
                     int shift, int32_t* __restrict__ shards,
                     int32_t* __restrict__ order,
                     int32_t* __restrict__ offsets) {
  __shared__ int table[kClusterMaxShards * 32];  // [S][warps]
  __shared__ int sums[kWarp];
  const int n_shards = 1 << bits, cells = n_shards * 32;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int first = warp * kWarp * kKeys + lane;
  int shard[kKeys], rank[kKeys];
  @0
  route_lane(keys, first, n, bits, shift, shard);
  @1
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0;
  __syncthreads();
  @2
  warp_ranks(shard, rank, table + warp, 32, lane);
  __syncthreads();
  @3
  scan_in_place(table, cells, sums);
  __syncthreads();
  @4
  for (int s = threadIdx.x; s < n_shards; s += blockDim.x)
    offsets[s] = table[s * 32];
  if (threadIdx.x == 0) offsets[n_shards] = n;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int s = shard[j], i = first + j * kWarp;
    if (s < 0) continue;
    shards[i] = s;
    order[table[s * 32 + warp] + rank[j]] = i;
  }
  @5
}
"""
FIRST_LAUNCH = [(
    "  if (one_cluster(n, bits)) {\n    cudaLaunchAttribute cluster;",
    "  if (one_cluster(n, bits)) {\n"
    "    partition_one_kernel<<<1, 1024, 0, s>>>(k, nn, bits, shift, ids,\n"
    "                                            pos, off);\n"
    "    return static_cast<int>(cudaGetLastError());\n  }\n"
    "  if (one_cluster(n, bits)) {\n    cudaLaunchAttribute cluster;")]


def first_form(src: str, timeline: bool) -> str:
    kernel = FIRST_FORM
    for k in range(6):
        kernel = kernel.replace(
            f"  @{k}\n", "  __syncthreads();\n"
            f"  if (threadIdx.x == 0) g_clk[{k}] = clock64();\n"
            if timeline else "")
    if timeline:
        kernel = "__device__ long long g_clk[8];\n" + kernel
    return edited(src, FIRST_LAUNCH + [
        ("}  // namespace\n", kernel + "}  // namespace\n")]) + (
            READ_CLK if timeline else "")


READ_CLK = """
extern "C" int read_clk(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk)));
}
extern "C" int clock_khz() {
  int khz = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  return khz;
}
"""


# one block of 1024 threads crossing `rounds` block barriers, no loads
BARRIERS = """
#include <cuda_runtime.h>
__global__ void __launch_bounds__(1024) barriers_kernel(int rounds,
                                                        int* out) {
  int x = threadIdx.x;
  for (int r = 0; r < rounds; ++r) {
    __syncthreads();
    x = x * 3 + r;
  }
  if (x == -1) *out = x;
}
extern "C" int barriers(int rounds, void* out, void* stream) {
  barriers_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      rounds, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
// one cluster of 8 blocks of 128 threads: `rounds` block barriers, then
// two cluster barriers, the cluster form's skeleton
__global__ void __launch_bounds__(128) cluster_barriers_kernel(int rounds,
                                                               int* out) {
  int x = threadIdx.x;
  for (int r = 0; r < rounds; ++r) {
    __syncthreads();
    x = x * 3 + r;
  }
  for (int r = 0; r < 2; ++r)
    asm volatile("barrier.cluster.arrive.release;\\n"
                 "barrier.cluster.wait.acquire;\\n" ::: "memory");
  if (x == -1) *out = x;
}
extern "C" int cluster_barriers(int rounds, void* out, void* stream) {
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 8;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(8);
  config.blockDim = dim3(128);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, cluster_barriers_kernel,
                                           rounds, static_cast<int*>(out));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
"""


def route_cell(tree: Path, n_keys: int, n_plans: int, seed: int) -> dict:
    """With ``tree``'s port: P-CLHT x8 with mesh reads, loaded with
    ``n_keys`` keys; the mean route_ns and wall ns of ``n_plans``
    YCSB-C plans on each path, and one plan's device operations."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.api import Plan, open_index
    from repro_torch.core.ycsb import PhaseExecutor, generate

    session = open_index("clht", shards=8, mesh_reads=True)
    idx = session.index
    load = generate("C", n_keys, (n_plans + 1) * PLAN_OPS, seed=seed)
    done = PhaseExecutor(idx, batch_lookups=True,
                         max_batch=PLAN_OPS).run(load.load_ops)
    if done["acked"] != n_keys:
        raise SystemExit("route_cell: an insert was not acknowledged")
    keys = np.fromiter((k for _, k, _ in load.run_ops), np.int64)
    out = {}
    for path, mesh in (("mesh", True), ("per-shard", False)):
        route, wall = [], []
        for p in range(n_plans + 1):
            chunk = keys[p * PLAN_OPS:(p + 1) * PLAN_OPS]
            plan = Plan.from_arrays(np.zeros(chunk.size, np.int32), chunk,
                                    np.zeros(chunk.size, np.int64))
            t0 = time.perf_counter_ns()
            res = idx.execute(plan, force_kernel=p == 0, mesh=mesh)
            torch.cuda.synchronize()
            dt = time.perf_counter_ns() - t0
            if res.found != chunk.size or res.mesh != mesh:
                raise SystemExit(f"route_cell: a {path} plan missed")
            if p:
                route.append(res.route_ns)
                wall.append(dt)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for n in (2, 8):  # a warm-up window, then the counted one
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(n):
                    idx.execute(plan, mesh=mesh)
                torch.cuda.synchronize()
        ops = {"kernels": 0, "HtoD": 0, "DtoH": 0, "other copies": 0}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or \
                    e.key.startswith("ProfilerStep"):
                continue
            kind = ("HtoD" if "HtoD" in e.key else "DtoH" if "DtoH" in
                    e.key else "other copies" if "Mem" in e.key
                    else "kernels")
            ops[kind] += e.count / n
        out[path] = {"route_ns": float(np.mean(route)),
                     "wall_ns": float(np.mean(wall)), "ops": ops}
    return out


def compile_all(workdir: Path, variants, say) -> dict:
    from repro_torch import build
    import chip_smoke as cs
    procs = {}
    for i, (name, src) in enumerate(variants):
        cu = workdir / f"v{i}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            say(f"route_tag_variants: nvcc failed on {name}:\n{log}")
            continue
        for line in cs.ptxas_lines(log):
            say(f"  {name}: {line}")
        lib = libs[name] = ctypes.CDLL(str(so))
        if name == "tag packed line":
            lib.tag_probe_packed.argtypes = [P, P, I, U, P, P, P]
        elif name == "parent clht_probe":
            lib.clht_probe.argtypes = [P] * 5 + [I, I, P]
        elif name == "parent shard_route":
            lib.shard_route.argtypes = [P, L, I, I, P, P]
        elif name == "barriers":
            lib.barriers.argtypes = [I, P, P]
            lib.cluster_barriers.argtypes = [I, P, P]
        elif name.startswith("partition"):
            lib.shard_partition.argtypes = [P, L, I, I] + [P] * 5
            lib.shard_partition_scratch_bytes.argtypes = [L, I]
            lib.shard_partition_scratch_bytes.restype = L
            if name == "partition timeline":
                lib.read_clk.argtypes = [P]
        else:
            lib.empty.argtypes = [L, I, P]
            lib.chase.argtypes = [P, P, L, I, I, P, P]
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--n-route", type=int, default=1 << 18)
    ap.add_argument("--route-plans", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--route-cell", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.route_cell is not None:
        print(json.dumps(route_cell(args.route_cell.resolve(), args.n_route,
                                    args.route_plans, args.seed)),
              flush=True)
        return 0

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import clht_probe as ktag
    from repro_torch.kernels import partition as kpart

    say = cs.say
    cs.check(torch.cuda.is_available(), "no CUDA device")
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    Q = cs.Q
    tag_src = (ROOT / "src/repro_torch/csrc/clht_probe.cu").read_text()
    route_src = (ROOT / "src/repro_torch/csrc/shard_route.cu").read_text()
    variants = [
        ("tag packed line", tag_src.replace(
            "}  // namespace\n", PACKED_KERNEL + "}  // namespace\n")
         + PACKED_ENTRY),
        ("partition own lane only", edited(route_src, [
            (MATCH_PEERS, "(1u << (threadIdx.x % kWarp))")])),
        ("partition first form", first_form(route_src, False)),
        ("partition cluster of 4", edited(route_src, [(
            "constexpr int kClusterBlocks = 8;",
            "constexpr int kClusterBlocks = 4;")])),
        ("partition cluster of 2", edited(route_src, [(
            "constexpr int kClusterBlocks = 8;",
            "constexpr int kClusterBlocks = 2;")])),
        ("partition timeline", first_form(route_src, True)),
        ("barriers", BARRIERS),
        ("latency", (ROOT / "tools/index_variants.cu").read_text())]
    if args.parent is not None:
        pc = args.parent / "src/repro_torch/csrc"
        variants += [("parent clht_probe", (pc / "clht_probe.cu").read_text()),
                     ("parent shard_route",
                      (pc / "shard_route.cu").read_text())]

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def dev_ms(fn, batches, reps: int = 640) -> float:
        ms, call_ms = cs.time_calls(fn, batches, reps)
        return ms if ms is not None else call_ms

    def turns(name: str, a, b, batches, what: str, same: bool = True):
        if same:
            for g, r in zip(b(*batches[0]), a(*batches[0])):
                cs.check(torch.equal(g, r), f"{name} {what}: differs")
        ms = [dev_ms(f, batches) for f in (a, b, b, a)]
        say(f"{name} vs {what}: " + ", ".join(f"{m:.6f}" for m in ms)
            + " ms (this tree, other, other, this tree)")

    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp), variants, say)
        lat = libs["latency"]
        empty_ms = dev_ms(lambda: cs.check(
            lat.empty(Q, BLOCK, stream()) == 0, "empty launch failed"), [()])
        n_words = 1 << 20  # 8 MB, in L2
        table = torch.empty(n_words, dtype=torch.int64, device=dev)
        perm = torch.randperm(n_words, device=dev)
        table[perm] = perm.roll(-1)
        starts = [torch.randint(0, n_words, (Q,), device=dev)
                  for _ in range(64)]
        out = torch.empty(Q, dtype=torch.int64, device=dev)
        ks = list(range(9))
        ms = [dev_ms(lambda s, k=k: cs.check(lat.chase(
            table.data_ptr(), s.data_ptr(), Q, k, BLOCK, out.data_ptr(),
            stream()) == 0, "chase launch failed"), [(s,) for s in starts])
            for k in ks]
        round_ms = float(np.polyfit(ks[1:], ms[1:], 1)[0])
        say(f"empty kernel ({Q} threads): {empty_ms:.6f} ms; chase over 8 MB"
            ": " + ", ".join(f"k={k} {m:.6f}" for k, m in zip(ks, ms))
            + f" ms; {round_ms:.6f} ms a round")

        # -- tag_probe ---------------------------------------------------
        tag = cs.tag_path(args.seed)
        tables = tag["table"]
        waves = [tag["q"]] + [torch.from_numpy(cs.tag_queries(
            tag["tags"], tag["rng"])).to(dev) for _ in range(7)]
        batches = [(q,) for q in waves]
        keys, vals, nxt = tables

        def source_tag(q):
            return ktag.tag_probe(q, *tables, n_buckets=cs.TAG_BUCKETS)

        lines = torch.cat([keys, vals, nxt[:, None],
                           torch.zeros_like(nxt)[:, None]], dim=1)
        cs.check(lines.is_contiguous() and lines.data_ptr() % 32 == 0,
                 "the packed tag lines are not 32-byte aligned")

        def packed_line(q):
            found = torch.empty(Q, dtype=torch.bool, device=dev)
            values = torch.empty(Q, dtype=torch.int32, device=dev)
            cs.check(libs["tag packed line"].tag_probe_packed(
                q.data_ptr(), lines.data_ptr(), q.numel(), cs.TAG_BUCKETS,
                found.data_ptr(), values.data_ptr(), stream()) == 0,
                "packed-line tag launch failed")
            return found, values

        if "tag packed line" in libs:
            turns("tag_probe (Q=4096)", source_tag, packed_line, batches,
                  "one packed 32-byte line a row")
        read, _ = cs.tag_walks(waves[0].cpu().numpy(), tag["host"])
        rounds = int(read.max()) + 1
        say(f"tag_probe floor: 1 x {empty_ms:.6f} + {rounds} rounds x "
            f"{round_ms:.6f} ms = {empty_ms + rounds * round_ms:.6f} ms "
            f"(rows a query reads: mean {read.mean():.4f}, max "
            f"{int(read.max())})")
        if args.parent is not None:
            plib = libs["parent clht_probe"]

            def parent_wave(q):
                bk, bv = ktag.tag_windows(q, *tables,
                                          n_buckets=cs.TAG_BUCKETS)
                found = torch.empty(Q, dtype=torch.bool, device=dev)
                values = torch.empty(Q, dtype=torch.int32, device=dev)
                cs.check(plib.clht_probe(
                    q.data_ptr(), bk.data_ptr(), bv.data_ptr(),
                    found.data_ptr(), values.data_ptr(), Q, bk.shape[1],
                    stream()) == 0, "parent clht_probe launch failed")
                return found, values

            turns("the tag wave (Q=4096)", source_tag, parent_wave, batches,
                  "the parent's tag_windows + clht_probe")
            say(f"the tag wave's device operations: this tree "
                f"{cs.device_ops(lambda: source_tag(waves[0]))}; the "
                f"parent's {cs.device_ops(lambda: parent_wave(waves[0]))}")

        # -- shard_partition ---------------------------------------------
        load = cs.generate("C", 1 << 16, 16 * PLAN_OPS, seed=args.seed)
        c_keys = cs.op_keys(load.run_ops)
        key_batches = [(torch.from_numpy(c_keys[i * Q:(i + 1) * Q]).to(dev),)
                       for i in range(16)]
        b, shift = kpart.route_params(cs.SHARDS, "hash")

        def partition(k):
            return kpart.shard_partition(k, bits=b, shift=shift)

        say(f"shard_partition (Q={Q}, S={cs.SHARDS}): "
            f"{dev_ms(partition, key_batches):.6f} ms")

        def part_call(lib, bits, shift_):
            def call(k):
                n = k.numel()
                out = (torch.empty(n, dtype=torch.int32, device=dev),
                       torch.empty(n, dtype=torch.int32, device=dev),
                       torch.empty((1 << bits) + 1, dtype=torch.int32,
                                   device=dev))
                n_scratch = lib.shard_partition_scratch_bytes(n, bits)
                scratch = torch.empty(max(n_scratch, 1), dtype=torch.uint8,
                                      device=dev)
                cs.check(lib.shard_partition(
                    k.data_ptr(), n, bits, shift_,
                    *(o.data_ptr() for o in out), scratch.data_ptr(),
                    stream()) == 0, "partition variant launch failed")
                return out
            return call

        big = [(torch.from_numpy(np.resize(c_keys, 1 << 16)).to(dev),)]
        for n_bits, batches_, what in (
                (3, key_batches, f"Q={Q}, S=8"),
                (12, key_batches, f"Q={Q}, S=4096 (tiled)"),
                (3, big, "Q=65536, S=8 (tiled)")):
            b_, s_ = kpart.route_params(1 << n_bits, "hash")

            def source(k, b_=b_, s_=s_):
                return kpart.shard_partition(k, bits=b_, shift=s_)

            for name in ("partition own lane only", "partition first form",
                         "partition cluster of 4", "partition cluster of 2"):
                one_cluster = n_bits == 3 and len(batches_) > 1
                if name in libs and (one_cluster or "own lane" in name):
                    turns(f"shard_partition ({what})", source,
                          part_call(libs[name], b_, s_), batches_,
                          name[len("partition "):],
                          same="own lane" not in name)
        if "partition timeline" in libs:
            tl = libs["partition timeline"]
            clk = np.zeros(8, np.int64)
            call = part_call(tl, b, shift)
            for k in key_batches:
                call(*k)
            torch.cuda.synchronize()
            cs.check(tl.read_clk(clk.ctypes.data) == 0, "read_clk failed")
            khz = tl.clock_khz()
            say(f"shard_partition's first form (Q={Q}, S=8) phases, thread "
                f"0's SM clock "
                f"after a barrier ({khz} kHz): " + ", ".join(
                    f"{name} {int(c)} cycles" for name, c in zip(
                        ("keys and routes", "table cleared", "ranks",
                         "scan", "places stored"), np.diff(clk[:6]))))
        blib = libs["barriers"]
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        one = [dev_ms(lambda r=r: cs.check(blib.barriers(
            r, flag.data_ptr(), stream()) == 0, "barriers launch failed"),
            [()]) for r in (0, 6)]
        grouped = [dev_ms(lambda r=r: cs.check(blib.cluster_barriers(
            r, flag.data_ptr(), stream()) == 0, "cluster launch failed"),
            [()]) for r in (0, 6)]
        say(f"one block of 1024 threads: {one[0]:.6f} ms, with 6 barriers "
            f"{one[1]:.6f} ms (the first form's floor: {one[1]:.6f} + 1 "
            f"round x {round_ms:.6f} = {one[1] + round_ms:.6f} ms); a "
            f"cluster of 8 blocks of 128 threads with 2 cluster barriers: "
            f"{grouped[0]:.6f} ms, and 6 block barriers {grouped[1]:.6f} ms "
            f"(shard_partition's floor: {grouped[1]:.6f} + 1 round = "
            f"{grouped[1] + round_ms:.6f} ms)")
        if args.parent is not None:
            rlib = libs["parent shard_route"]

            def parent_route(k):
                ids = torch.empty(Q, dtype=torch.int32, device=dev)
                cs.check(rlib.shard_route(k.data_ptr(), Q, b, shift,
                                          ids.data_ptr(), stream()) == 0,
                         "parent shard_route launch failed")
                return (ids,)

            turns(f"shard_partition (Q={Q}, S={cs.SHARDS})", partition,
                  parent_route, key_batches,
                  "the parent's shard_route (ids only)", same=False)

    if args.parent is None:
        return 0
    # -- route_ns on the sharded path, each tree in a child process -------
    with tempfile.TemporaryDirectory() as tmp:
        tiled = Path(tmp) / "tiled"
        shutil.copytree(ROOT / "src/repro_torch", tiled / "src/repro_torch",
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        cu = tiled / "src/repro_torch/csrc/shard_route.cu"
        cu.write_text(edited(cu.read_text(), [(ONE_CLUSTER,
                                               "return false;")]))
        route_cells(args, (args.parent.resolve(), ROOT, tiled), say)
    return 0


def route_cells(args, trees, say) -> None:
    """The route cell of each tree in turns: parent, this tree, the
    tiled form alone, the tiled form alone, this tree, parent."""
    names = ("parent", "this tree", "tiled form alone")
    for i in (0, 1, 2, 2, 1, 0):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--route-cell",
             str(trees[i]), "--n-route", str(args.n_route),
             "--route-plans", str(args.route_plans), "--seed",
             str(args.seed)], capture_output=True, text=True, cwd=trees[i])
        if proc.returncode:
            raise SystemExit(f"route_tag_variants: a route cell failed:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        name = names[i]
        for path, r in got.items():
            say(f"P-CLHT x8 ({args.n_route} keys) {path} YCSB-C, {name}: "
                f"route_ns {r['route_ns']:.1f}, wall {r['wall_ns']:.1f} ns "
                f"a plan (mean of {args.route_plans}); one plan's device "
                f"operations {r['ops']}")


if __name__ == "__main__":
    sys.exit(main())
