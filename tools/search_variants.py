#!/usr/bin/env python3
"""Time the conflict-admission and sorted-run search kernels' designs on
one card, and the latency floor under them.

    python3 tools/search_variants.py [--parent DIR] [--n-run N]

Builds, from edited copies of ``csrc/conflict_any.cu`` and
``csrc/scan_window.cu`` (and ``tools/index_variants.cu`` for the
latency probes), and times with ``chip_smoke.time_calls`` (device time
a call, its kernels and memsets timed by events around queued calls), each variant
in turns with the source (source, variant, variant, source), each held
bit-identical to the source first:

* ``conflict_any`` at A = 4096, B = 12288 on admission sets shaped like
  the stream phase's (YCSB-A plans of lookups and fresh inserts,
  neighbouring plans overlapping by half): the source (a clear of the
  table's counts, an insert kernel, a probe kernel) against a clear of
  the whole table (so no sector the probe reads is partly written),
  against one cooperative launch that clears, inserts and probes with
  grid-wide barriers between, against blocks of 64 and 256 threads, and
  against a probe of one thread a candidate (the source's takes 8 lanes
  a candidate, a slot a lane); and the source at B = 65536;
* ``scan_window`` on a sorted run of ``--n-run`` YCSB keys (2^18, the
  size of P-Masstree's run) at C = 1 and C = 128, Q = 4096: the source's
  window copy (one entry a lane) against four entries a lane with their
  valid bytes stored as one word and keys and values as 16-byte pairs;
  the pivots computed in 64-bit arithmetic throughout (the source takes
  32-bit arithmetic under 2^26 entries) and the sub-range's ends
  recomputed instead of shuffled; at C = 1 the entry
  loaded after the lower bound, not taken by shuffle from the last
  round's lanes (which read values beside keys); and the first round's
  32 pivots read from global memory against the same pivots staged in
  shared memory once a block;
* ``scan_window_rows`` at C = 1 on 8 hash-sharded runs of the same keys
  (the mesh path's shape);
* with ``--parent DIR`` (a checkout of the commit before this design,
  e.g. ``git archive HEAD~1 src/repro_torch | tar -x -C DIR``), the
  parent's pair-test ``conflict_any`` and binary-search ``scan_window``
  in turns with the sources, on the same inputs;
* an empty kernel over Q = 4096 threads, and 4096 chains of k = 0-8
  dependent loads over an 8 MB table (in L2): the fixed cost of a
  launch and a round's latency, from which each design's floor is
  printed (the empty kernel for each launch, plus the slowest query's
  dependent rounds).

Prints the card's name and power limit first.  Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch import build  # noqa: E402
from repro_torch.core.ycsb import generate  # noqa: E402
from repro_torch.kernels import conflict as kconf  # noqa: E402
from repro_torch.kernels import partition as kpart  # noqa: E402
from repro_torch.kernels import scan as kscan  # noqa: E402

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
Q = cs.Q
BLOCK = 64  # the latency probes' blocks
CSRC = ROOT / "src/repro_torch/csrc"
CONFLICT = (CSRC / "conflict_any.cu").read_text()
SCAN = (CSRC / "scan_window.cu").read_text()


# the probe as one thread a candidate, reading its bucket as 4 16-byte
# loads and comparing the 8 slots itself
THREAD_PROBE = """
// The classes of B's ops on this key ORed (0 when it is not in B): a
// bucket's count, keys and classes a round, on while the count shows
// that some op went past the bucket.
__device__ __forceinline__ unsigned lookup(const Table& t, long long key) {
  const unsigned long long k = static_cast<unsigned long long>(key);
  const unsigned mask = (1u << (t.log_slots - kBucketLog)) - 1;
  unsigned g = home_bucket(k, t.log_slots);
  unsigned found = 0;
  for (;;) {
    const size_t first = static_cast<size_t>(g) << kBucketLog;
    const unsigned n = __ldg(t.counts + g);
    const auto* keys = reinterpret_cast<const ulonglong2*>(t.keys + first);
    const unsigned long long cls =
        __ldg(reinterpret_cast<const unsigned long long*>(t.cls + first));
#pragma unroll
    for (int j = 0; j < kBucket / 2; ++j) {
      const ulonglong2 two = __ldg(keys + j);
      if (2 * j < n && two.x == k) found |= (cls >> (16 * j)) & 0xff;
      if (2 * j + 1 < n && two.y == k) found |= (cls >> (16 * j + 8)) & 0xff;
    }
    if (n <= kBucket) return found;
    g = (g + 1) & mask;
  }
}

__device__ __forceinline__ bool conflicts(const Table& t, const Scalars& s,
                                          int kind, long long key,
                                          bool writes_conflict) {
  const unsigned long long ord = static_cast<unsigned long long>(key) ^ kSign;
  const unsigned c = op_class(kind);
  if (c == kGetBit) return lookup(t, key) & kWriteBit;
  if (c == kScanClass) return (s.has & kHasWrite) && ord <= s.max_w;
  if (c != kWriteBit) return false;
  if ((s.has & kHasScan) && ord >= ~s.max_ns) return true;
  const unsigned f = lookup(t, key);
  return (f & kGetBit) || (writes_conflict && (f & kWriteBit));
}

__global__ void __launch_bounds__(kThreads)
conflict_probe1_kernel(const int32_t* __restrict__ a_kinds,
                      const int64_t* __restrict__ a_keys, int64_t n_a,
                      const Scalars* scalars, Table t, bool writes_conflict,
                      bool* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n_a)
    out[i] = conflicts(t, *scalars, __ldg(a_kinds + i), __ldg(a_keys + i),
                       writes_conflict);
}
"""
# one cooperative launch in place of the clear and the two kernels: the
# grid clears the table, inserts B and probes A (a thread a candidate,
# the table read through L2: it was written in the same kernel), with
# grid.sync() between
FUSED_KERNEL = THREAD_PROBE.split("__global__")[0].replace(
    "__ldg(t.", "__ldcg(t.").replace("__ldg(keys", "__ldcg(keys").replace(
    "__ldg(reinterpret_cast", "__ldcg(reinterpret_cast") + """
__global__ void __launch_bounds__(kThreads)
conflict_fused_kernel(const int32_t* __restrict__ a_kinds,
                      const int64_t* __restrict__ a_keys, int64_t n_a,
                      const int32_t* __restrict__ b_kinds,
                      const int64_t* __restrict__ b_keys, int64_t n_b,
                      Scalars* scalars, Table t, bool writes_conflict,
                      bool* __restrict__ out) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = first; j < (1ll << (t.log_slots - kBucketLog));
       j += stride)
    t.counts[j] = 0;
  if (first == 0) *scalars = Scalars{};
  grid.sync();
  Scalars s{};
  for (int64_t j = first; j < n_b; j += stride)
    insert(t, op_class(__ldg(b_kinds + j)), __ldg(b_keys + j), s);
  s = block_merge(s);
  if (threadIdx.x == 0 && s.has) {
    atomicOr(&scalars->has, s.has);
    if (s.has & kHasWrite) atomicMax(&scalars->max_w, s.max_w);
    if (s.has & kHasScan) atomicMax(&scalars->max_ns, s.max_ns);
  }
  grid.sync();
  Scalars all;
  all.max_w = __ldcg(&scalars->max_w);
  all.max_ns = __ldcg(&scalars->max_ns);
  all.has = __ldcg(&scalars->has);
  for (int64_t i = first; i < n_a; i += stride)
    out[i] = conflicts(t, all, __ldg(a_kinds + i), __ldg(a_keys + i),
                       writes_conflict);
}
"""
FUSED_LAUNCH = """  {
    int per_sm = 0, sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conflict_fused_kernel, kThreads, 0);
    const long long most = static_cast<long long>(per_sm) * sms;
    const long long want = blocks(n_a > n_b ? n_a : n_b);
    auto* sc = static_cast<Scalars*>(scratch);
    Table tt = table_at(static_cast<unsigned char*>(scratch) + 32, lg);
    const int32_t* ak = static_cast<const int32_t*>(a_kinds);
    const int64_t* ax = static_cast<const int64_t*>(a_keys);
    const int32_t* bk = static_cast<const int32_t*>(b_kinds);
    const int64_t* bx = static_cast<const int64_t*>(b_keys);
    int64_t na = n_a, nb = n_b;
    bool wc = writes_conflict != 0;
    bool* o = static_cast<bool*>(out);
    void* args[] = {&ak, &ax, &na, &bk, &bx, &nb, &sc, &tt, &wc, &o};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(conflict_fused_kernel),
        dim3(static_cast<unsigned>(want < most ? want : most)),
        dim3(kThreads), args, 0, s);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
"""


def edited(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"search_variants: an edit no longer applies: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


VARIANTS = [
    ("conflict full clear", edited(CONFLICT, [
        ("      scratch, 0, static_cast<size_t>(32 + counts_bytes(lg)), s);",
         "      scratch, 0, static_cast<size_t>(32 + table_bytes(lg)), s);"),
    ])),
    ("conflict fused", edited(CONFLICT, [
        ("#include <cuda_runtime.h>\n",
         "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n"),
        ("}  // namespace\n", FUSED_KERNEL + "}  // namespace\n"),
        ("  const cudaError_t e = cudaMemsetAsync(\n"
         "      scratch, 0, static_cast<size_t>(32 + counts_bytes(lg)), s);\n"
         "  if (e != cudaSuccess) return static_cast<int>(e);\n",
         FUSED_LAUNCH),
    ])),
    *((f"conflict threads {n}", edited(CONFLICT, [
        ("constexpr int kThreads = 128;", f"constexpr int kThreads = {n};")]))
      for n in (64, 256)),
    ("conflict probe a thread a candidate", edited(CONFLICT, [
        ("}  // namespace\n", THREAD_PROBE + "}  // namespace\n"),
        ("  conflict_probe_kernel<<<blocks(kBucket * n_a), kThreads, 0, s>>>(",
         "  conflict_probe1_kernel<<<blocks(n_a), kThreads, 0, s>>>(")])),
    ("scan packed stores", edited(SCAN, [
        ("  const int64_t row = i * max_count;\n",
         "  const int64_t row = i * max_count;\n"
         "  if (max_count % 4 == 0) {\n"
         "    for (int j0 = 4 * lane; j0 < max_count; j0 += 4 * kWarp) {\n"
         "      unsigned ok4 = 0;\n"
         "      long long k[4], v[4];\n"
         "#pragma unroll\n"
         "      for (int t = 0; t < 4; ++t) {\n"
         "        const long long pos = lb + j0 + t;\n"
         "        const bool ok = j0 + t < count && pos < end;\n"
         "        ok4 |= static_cast<unsigned>(ok) << (8 * t);\n"
         "        k[t] = ok ? __ldg(keys + pos) : 0;\n"
         "        v[t] = ok ? __ldg(vals + pos) : 0;\n"
         "      }\n"
         "      *reinterpret_cast<unsigned*>(valid + row + j0) = ok4;\n"
         "      auto* kp = reinterpret_cast<longlong2*>(okeys + row + j0);\n"
         "      auto* vp = reinterpret_cast<longlong2*>(ovals + row + j0);\n"
         "      kp[0] = make_longlong2(k[0], k[1]);\n"
         "      kp[1] = make_longlong2(k[2], k[3]);\n"
         "      vp[0] = make_longlong2(v[0], v[1]);\n"
         "      vp[1] = make_longlong2(v[2], v[3]);\n"
         "    }\n"
         "    return;\n"
         "  }\n")])),
    ("scan 64-bit pivots", edited(SCAN, [
        ("    const long long p =\n"
         "        lo + (len < (1ll << 26)\n"
         "                  ? static_cast<long long>(static_cast<unsigned>"
         "(lane + 1) *\n"
         "                                           static_cast<unsigned>"
         "(len) /\n"
         "                                           static_cast<unsigned>"
         "(kWays))\n"
         "                  : (lane + 1) * len / kWays);",
         "    const long long p = lo + (lane + 1) * len / kWays;")])),
    ("scan no shuffles", edited(SCAN, [
        ("    const long long below = "
         "__shfl_sync(kFull, p, c > 0 ? c - 1 : 0);\n"
         "    const long long above = "
         "__shfl_sync(kFull, p, c < kWarp ? c : 0);",
         "    const long long below = lo + c * (hi - lo) / kWays;\n"
         "    const long long above = lo + (c + 1) * (hi - lo) / kWays;")])),
    ("scan point lookups by loads", edited(SCAN, [
        ("  if (max_count == 1) {  // the entry comes from lane",
         "  if (false) {  // the entry comes from lane")])),
    ("scan staged pivots", edited(SCAN, [
        ("                                       long long q, int lane) {\n"
         "  while (hi - lo > kWarp) {",
         "                                       long long q, int lane,\n"
         "                                       const long long* first) {\n"
         "  bool staged = first != nullptr;\n"
         "  while (hi - lo > kWarp) {"),
        ("    const int c = __popc(__ballot_sync(\n"
         "        kFull, static_cast<long long>(__ldg(keys + p)) < q));",
         "    const long long kp = staged ? first[lane]\n"
         "        : static_cast<long long>(__ldg(keys + p));\n"
         "    staged = false;\n"
         "    const int c = __popc(__ballot_sync(kFull, kp < q));"),
        ("  const int lane = threadIdx.x % kWarp;\n"
         "  if (i >= n_queries) return;",
         "  const int lane = threadIdx.x % kWarp;\n"
         "  __shared__ long long s_first[kWarp];\n"
         "  if (!kRows && threadIdx.x < kWarp && n > kWarp)\n"
         "    s_first[threadIdx.x] =\n"
         "        __ldg(keys + (threadIdx.x + 1) * n / kWays);\n"
         "  __syncthreads();\n"
         "  if (i >= n_queries) return;"),
        ("  narrow(keys, lo, hi, q, lane);",
         "  narrow(keys, lo, hi, q, lane,\n"
         "         kRows || n <= kWarp ? nullptr : s_first);"),
    ])),
    ("latency", (ROOT / "tools/index_variants.cu").read_text()),
]


def compile_all(workdir: Path, variants) -> dict:
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
        if proc.returncode:  # the variant is left out, and said so
            cs.say(f"search_variants: nvcc failed on {name}:\n{log}")
            continue
        for line in cs.ptxas_lines(log):
            cs.say(f"  {name}: {line}")
        lib = libs[name] = ctypes.CDLL(str(so))
        if name == "parent conflict":
            lib.conflict_any.argtypes = [P, P, L, P, P, L, I, P, P]
        elif "conflict" in name:
            lib.conflict_any.argtypes = [P, P, L, P, P, L, I, P, P, P]
            lib.conflict_any_scratch_bytes.argtypes = [L]
            lib.conflict_any_scratch_bytes.restype = L
        elif "scan" in name:
            lib.scan_window.argtypes = [P] * 4 + [L, L, I] + [P] * 4
            lib.scan_window_rows.argtypes = [P] * 6 + [L, L, I] + [P] * 4
        else:
            lib.empty.argtypes = [L, I, P]
            lib.chase.argtypes = [P, P, L, I, I, P, P]
    return libs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def conflict_call(lib, parent: bool = False):
    def call(ka, xa, kb, xb):
        n_a, n_b = ka.numel(), kb.numel()
        if parent:  # the pair-test design wrote only the conflicts
            out = torch.zeros(n_a, dtype=torch.bool, device=ka.device)
            err = lib.conflict_any(ka.data_ptr(), xa.data_ptr(), n_a,
                                   kb.data_ptr(), xb.data_ptr(), n_b, 1,
                                   out.data_ptr(), stream())
        else:
            out = torch.empty(n_a, dtype=torch.bool, device=ka.device)
            scratch = torch.empty(lib.conflict_any_scratch_bytes(n_b),
                                  dtype=torch.uint8, device=ka.device)
            err = lib.conflict_any(
                ka.data_ptr(), xa.data_ptr(), n_a, kb.data_ptr(),
                xb.data_ptr(), n_b, 1, out.data_ptr(), scratch.data_ptr(),
                stream())
        cs.check(err == 0, f"conflict_any variant launch failed ({err})")
        return out
    return call


def scan_call(lib, keys, vals, width: int):
    def call(q, c):
        n = q.numel()
        out = (torch.empty((n, width), dtype=torch.bool, device=q.device),
               torch.empty((n, width), dtype=torch.int64, device=q.device),
               torch.empty((n, width), dtype=torch.int64, device=q.device))
        err = lib.scan_window(q.data_ptr(), c.data_ptr(), keys.data_ptr(),
                              vals.data_ptr(), n, keys.numel(), width,
                              *(o.data_ptr() for o in out), stream())
        cs.check(err == 0, f"scan_window variant launch failed ({err})")
        return out
    return call


def rows_call(lib, keys, vals):
    def call(q, c, b, n_rows):
        n = q.numel()
        out = (torch.empty((n, 1), dtype=torch.bool, device=q.device),
               torch.empty((n, 1), dtype=torch.int64, device=q.device),
               torch.empty((n, 1), dtype=torch.int64, device=q.device))
        err = lib.scan_window_rows(
            q.data_ptr(), c.data_ptr(), b.data_ptr(), n_rows.data_ptr(),
            keys.data_ptr(), vals.data_ptr(), n, keys.numel(), 1,
            *(o.data_ptr() for o in out), stream())
        cs.check(err == 0, f"scan_window_rows variant launch failed ({err})")
        return out
    return call


def dev_ms(fn, batches, reps: int = 640) -> float:
    ms, call_ms = cs.time_calls(fn, batches, reps)
    return ms if ms is not None else call_ms


def turns(name: str, source, variant, batches, what: str) -> list:
    """Bit-identical on the first batch, then timed source, variant,
    variant, source."""
    for g, r in zip(variant(*batches[0]), source(*batches[0])):
        cs.check(torch.equal(g, r), f"{name} {what}: differs from the "
                 "source")
    ms = [dev_ms(f, batches) for f in (source, variant, variant, source)]
    cs.say(f"{name} source vs {what}: " + ", ".join(f"{m:.6f}" for m in ms)
           + " ms (source, variant, variant, source)")
    return ms


def admission_sets(loaded: np.ndarray, rng, n_b: int, n: int = 8) -> list:
    """``n`` admission checks shaped like the stream phase's: a plan of
    PLAN_OPS YCSB-A ops (lookups of loaded keys, inserts of fresh keys
    in [2^61, 2^62)) against the n_b ops of the plans admitted before it
    in the tick, neighbouring plans overlapping by half."""
    plan = cs.PLAN_OPS
    out = []
    for _ in range(n):
        n_ops = n_b + plan
        is_get = rng.random(n_ops) < 0.5
        keys = np.where(is_get, rng.choice(loaded, n_ops),
                        rng.integers(1 << 61, 1 << 62, size=n_ops))
        kinds = np.where(is_get, 0, 1).astype(np.int32)
        kb, xb = kinds[:n_b], keys[:n_b]
        # the candidate plan shares half its ops with the last plan of B
        lo = n_b - plan // 2
        ka, xa = kinds[lo:lo + plan], keys[lo:lo + plan]
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                         for a in (ka, xa, kb, xb)))
    return out


def floor(name: str, empty_ms: float, launches: int, rounds: int,
          round_ms: float) -> None:
    cs.say(f"{name} floor: {launches} x {empty_ms:.6f} + {rounds} rounds x "
           f"{round_ms:.6f} ms = {launches * empty_ms + rounds * round_ms:.6f}"
           " ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--n-run", type=int, default=1 << 18)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cs.check(torch.cuda.is_available(), "no CUDA device")
    say = cs.say
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    variants = list(VARIANTS)
    if args.parent is not None:
        pc = args.parent / "src/repro_torch/csrc"
        variants += [("parent conflict", (pc / "conflict_any.cu").read_text()),
                     ("parent scan", (pc / "scan_window.cu").read_text())]

    load = generate("C", args.n_run, args.n_run, seed=args.seed)
    keys_np = np.unique(cs.op_keys(load.load_ops)).astype(np.int64)
    vals_np = cs.value_of(keys_np).astype(np.int64)
    keys, vals = kscan.prepare_sorted(keys_np, vals_np, device=dev)
    say(f"sorted run: {keys_np.size} YCSB keys")
    rng = np.random.default_rng(args.seed + 4)

    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp), variants)
        lat = libs["latency"]
        empty_ms = dev_ms(lambda: cs.check(
            lat.empty(Q, BLOCK, stream()) == 0, "empty launch failed"),
            [()])
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

        # -- conflict_any -------------------------------------------------
        def source_conflict(*t):
            return (kconf.kernel.conflict_any(*t, writes_conflict=True),)

        def wrap(fn):
            return lambda *t: (fn(*t),)

        sets = admission_sets(keys_np, rng, 12288)
        for what in ("full clear", "fused", "threads 64", "threads 256",
                     "probe a thread a candidate"):
            if f"conflict {what}" in libs:
                turns("conflict_any (A=4096, B=12288)", source_conflict,
                      wrap(conflict_call(libs[f"conflict {what}"])), sets,
                      what)
        if args.parent is not None:
            turns("conflict_any (A=4096, B=12288)", source_conflict,
                  wrap(conflict_call(libs["parent conflict"], parent=True)),
                  sets, "the parent's pair tests")
        big = admission_sets(keys_np, rng, 65536, n=4)
        say(f"conflict_any (A=4096, B=65536): "
            f"{dev_ms(source_conflict, big):.6f} ms")
        # three device operations (the clear costs about as much as an
        # empty kernel); an op's loads and its atomicAdd, a candidate's
        # loads and its bucket
        floor("conflict_any", empty_ms, 3, 4, round_ms)

        # -- scan_window --------------------------------------------------
        timing_q = [torch.from_numpy(np.concatenate([
            rng.choice(keys_np, Q // 2),
            rng.integers(1, 1 << 62, size=Q // 2)])).to(dev)
            for _ in range(64)]
        _, rounds = kscan.ref.ways_lower_bound(
            keys_np, np.concatenate([t.cpu().numpy() for t in timing_q]))
        say(f"scan_window rounds a query: max {int(rounds.max())}, mean "
            f"{rounds.mean():.4f} (binary search: "
            f"{keys_np.size.bit_length()})")
        for width in (1, 128):
            batches = [(t, torch.from_numpy(
                rng.integers(1, 101, size=Q).astype(np.int32) if width > 1
                else np.ones(Q, np.int32)).to(dev)) for t in timing_q]

            def source(a, c, w=width):
                return kscan.scan_window(a, c, keys, vals, max_count=w)

            tag = f"scan_window (C={width}, n={keys_np.size})"
            if width > 1:
                turns(tag, source, scan_call(libs["scan packed stores"],
                                             keys, vals, width), batches,
                      "four entries a lane, packed stores")
            for what in ("64-bit pivots", "no shuffles") + (
                    ("point lookups by loads",) if width == 1 else ()):
                turns(tag, source, scan_call(libs[f"scan {what}"], keys,
                                             vals, width), batches, what)
            turns(tag, source, scan_call(libs["scan staged pivots"], keys,
                                         vals, width), batches,
                  "the first round's pivots staged in shared memory")
            if args.parent is not None:
                turns(tag, source, scan_call(libs["parent scan"], keys, vals,
                                             width), batches,
                      "the parent's binary search")
            n_rounds = int(rounds.max())
            floor(f"scan_window (C={width})", empty_ms, 1, n_rounds + 2,
                  round_ms)

        # -- scan_window_rows, the mesh path's shape ----------------------
        shard = kpart.route_ref(keys_np, 8, "hash")
        runs = [keys_np[shard == s] for s in range(8)]
        offsets = np.concatenate([[0], np.cumsum([r.size for r in runs])])
        stacked = torch.from_numpy(np.concatenate(runs)).to(dev)
        svals = torch.from_numpy(cs.value_of(stacked.cpu().numpy())
                                 .astype(np.int64)).to(dev)
        ones = torch.ones(Q, dtype=torch.int32, device=dev)
        batches, all_q, all_b, all_n = [], [], [], []
        for t in timing_q:
            q = t.cpu().numpy()
            s = kpart.route_ref(q, 8, "hash")
            b, n = offsets[:-1][s], offsets[1:][s] - offsets[:-1][s]
            all_q.append(q)
            all_b.append(b)
            all_n.append(n)
            batches.append((t, ones, torch.from_numpy(b).to(dev),
                            torch.from_numpy(n).to(dev)))
        _, rrounds = kscan.ref.ways_lower_bound(
            stacked.cpu().numpy(), np.concatenate(all_q),
            np.concatenate(all_b), np.concatenate(all_n))
        say(f"scan_window_rows rounds a query: max {int(rrounds.max())}, "
            f"mean {rrounds.mean():.4f} (runs of {min(r.size for r in runs)}"
            f"-{max(r.size for r in runs)})")

        def rows_source(a, c, b, n):
            return kscan.scan_window_rows(a, c, b, n, stacked, svals,
                                          max_count=1)

        say(f"scan_window_rows (C=1, 8 runs): "
            f"{dev_ms(rows_source, batches):.6f} ms")
        if args.parent is not None:
            turns("scan_window_rows (C=1, 8 runs)", rows_source,
                  rows_call(libs["parent scan"], stacked, svals), batches,
                  "the parent's binary search")
        floor("scan_window_rows (C=1)", empty_ms, 1, int(rrounds.max()) + 2,
              round_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
