#!/usr/bin/env python3
"""Time the two pointer-chasing index kernels' designs on one card, and
the latency floor under them.

    python3 tools/index_variants.py [--n-clht N] [--n-art N] [--n-hot N]

Loads P-CLHT (2^20 keys), P-ART (2^19) and P-HOT (2^18) on the card as
``chip_smoke.py`` does, reads once through each so the snapshot's
per-epoch tables are on the card, and then times, with
``chip_smoke.time_calls`` (device time a call) on the query batches
``chip_smoke.py`` times:

* an empty kernel over Q = 4096 threads: the fixed cost of a launch;
* 4096 independent chains of k = 0-8 dependent 8-byte loads
  (``tools/index_variants.cu``) over an 8 MB table (in L2) and over
  tables the size of the P-HOT child table, the P-CLHT line table and
  the P-ART child table: the latency of a round is the slope over k;
* ``probe64_fp`` and ``probe64`` as ``csrc/probe.cu`` stands (the chain
  copies, kGroup = 4) against the same source walking lines linked only
  by w6 = nxt (one round a hop) and against kGroup = 8, in turns
  (source, variant, variant, source), each held bit-identical to the
  source's outputs;
* both kernels at blocks of 32 and 128 threads against the sources'
  64, in turns;
* ``art_descend`` on P-ART and P-HOT against the same source with the
  root's row staged in shared memory, so the first step makes no round
  of its own;
* ``_prepare``'s per-epoch time for P-CLHT and P-ART, the layout before
  this design (four and seven arrays uploaded, copied here) against the
  line table and the packed child entries, host clock around each call
  and a device synchronise, in turns.

and prints each design's floor: the empty kernel's time plus its
dependent load rounds on the timed batch (the slowest query's) times the
round latency, from every round an L2 hit (the 8 MB table) to every
round a miss (the P-ART-size table).  Prints the card's name and power
limit first.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch import build  # noqa: E402
from repro_torch.api import open_index  # noqa: E402
from repro_torch.core.ycsb import generate  # noqa: E402
from repro_torch.kernels import art_probe as kart  # noqa: E402
from repro_torch.kernels import probe as kprobe  # noqa: E402
from repro_torch.kernels.art_probe import ops as art_ops  # noqa: E402
from repro_torch.kernels.art_probe.ref import leaf_fp_lane  # noqa: E402
from repro_torch.kernels.clht_probe import ops as clht_ops  # noqa: E402
from repro_torch.kernels.probe.layout import chain_walk  # noqa: E402

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
Q = cs.Q
BLOCK = 64  # the tool's own kernels


def edited(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"index_variants: an edit no longer applies: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


PROBE = (ROOT / "src/repro_torch/csrc/probe.cu").read_text()
ART = (ROOT / "src/repro_torch/csrc/art_descend.cu").read_text()
# (name, source); the linked variant reads a table whose w6 is the next
# row's own line, so it walks one line a round
VARIANTS = [
    ("probe linked", edited(PROBE, [
        ("    if (next < 0 || next + rest > n_lines) rest = 0;\n"
         "    for (int g = 0; g < rest; g += kGroup) {",
         "    int64_t at = next;\n"
         "    for (int h = 0; h < rest; ++h) {\n"
         "      if (at < 0 || at >= n_lines) { rest = h; break; }\n"
         "      const Line l = load_line(lines, at);\n"
         "      visit<kUseFp>(l, q, qfp, p);\n"
         "      at = l.nx.x;\n"
         "    }\n"
         "    for (int g = 0; g < 0; g += kGroup) {"),
    ])),
    ("probe kGroup 8", edited(PROBE, [("constexpr int kGroup = 4;",
                                       "constexpr int kGroup = 8;")])),
    ("art_descend staged root", edited(ART, [
        ("  if (i >= n_queries) return;\n"
         "  const int64_t q = __ldg(queries + i);\n",
         "  __shared__ int32_t root_row[kFan];\n"
         "  const int64_t q = i < n_queries ? __ldg(queries + i) : 0;\n"
         "  for (int j = threadIdx.x; j < kFan; j += kBlock)\n"
         "    root_row[j] = __ldg(children + j);\n"
         "  __syncthreads();\n"
         "  if (i >= n_queries) return;\n"),
        ("  for (int step = 0; step <= kUnits; ++step) {",
         "  int step = 0;\n"
         "  if (!(hdr & kLeafBit)) {\n"
         "    const int32_t e = root_row[unit_at<kUnitBits>(uq, hdr)];\n"
         "    step = e >= 0 && (e & kRowMask) < n_nodes ? 1 : kUnits + 1;\n"
         "    node = e & kRowMask;\n"
         "    hdr = e >> kRowBits;\n"
         "  }\n"
         "  for (; step <= kUnits; ++step) {"),
    ])),
    *((f"{kind} block {b}", edited(src, [
        ("constexpr int kBlock = 64;", f"constexpr int kBlock = {b};")]))
      for kind, src in (("probe", PROBE), ("art_descend", ART))
      for b in (32, 128)),
    ("latency", (ROOT / "tools/index_variants.cu").read_text()),
]


def compile_all(workdir: Path) -> dict:
    procs = {}
    for i, (name, src) in enumerate(VARIANTS):
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
            raise SystemExit(f"index_variants: nvcc failed on {name}:\n{log}")
        for line in cs.ptxas_lines(log):
            cs.say(f"  {name}: {line}")
        lib = libs[name] = ctypes.CDLL(str(so))
        if name.startswith("probe"):
            lib.probe_chain.argtypes = [P] * 3 + [L] * 2 + [I] * 2 + [P] * 5
        elif name.startswith("art_descend"):
            lib.art_descend.argtypes = [P] * 2 + [I] + [P] * 3 + [L] * 2 + [
                I] + [P] * 6
        else:
            lib.empty.argtypes = [L, I, P]
            lib.chase.argtypes = [P, P, L, I, I, P, P]
    return libs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def probe_call(lib, lines, depth: int, use_fp: bool):
    def call(q, b):
        n = q.numel()
        found = torch.empty(n, dtype=torch.bool, device=q.device)
        values = torch.empty(n, dtype=torch.int64, device=q.device)
        nfp, nfalse = (torch.empty(n, dtype=torch.int32, device=q.device)
                       for _ in range(2))
        err = lib.probe_chain(q.data_ptr(), b.data_ptr(), lines.data_ptr(),
                              n, lines.shape[0], depth, int(use_fp),
                              found.data_ptr(), values.data_ptr(),
                              nfp.data_ptr(), nfalse.data_ptr(), stream())
        cs.check(err == 0, f"probe variant launch failed ({err})")
        return (found, values) + ((nfp, nfalse) if use_fp else (None, None))
    return call


def art_call(lib, pages, unit_bits: int):
    children, root, lfp, key, val = pages

    def call(q):
        n = q.numel()
        found = torch.empty(n, dtype=torch.bool, device=q.device)
        values = torch.empty(n, dtype=torch.int64, device=q.device)
        counts = [torch.empty(n, dtype=torch.int32, device=q.device)
                  for _ in range(3)]
        err = lib.art_descend(q.data_ptr(), children.data_ptr(), root,
                              lfp.data_ptr(), key.data_ptr(), val.data_ptr(),
                              n, children.shape[0], unit_bits,
                              found.data_ptr(), values.data_ptr(),
                              *(c.data_ptr() for c in counts), stream())
        cs.check(err == 0, f"art_descend variant launch failed ({err})")
        return (found, values, *counts)
    return call


def dev_ms(fn, batches, reps: int = 640) -> float:
    ms, call_ms = cs.time_calls(fn, batches, reps)
    return ms if ms is not None else call_ms


def loaded(kind: str, n: int, seed: int):
    """A session of ``kind`` on the card holding ``n`` YCSB keys, read
    once through the kernel path, and its snapshot."""
    session = open_index(kind)
    load = generate("C", n, n, seed=seed)
    done, secs = cs.timed_run(session.index, load.load_ops)
    cs.check(done["acked"] == n, f"{kind}: an insert was not acknowledged")
    cs.read_back(session, cs.op_keys(load.load_ops)[:cs.PLAN_OPS],
                 f"{kind} read")
    cs.say(f"{kind}: {n} keys loaded in {secs:.3f} s")
    return session, session.index.snapshot()


# -- the per-epoch uploads before this design, for the comparison --------

def old_clht_prepare(snap, device):
    """Four arrays uploaded, and the longest chain measured."""
    keys, vals, nxt, n, fps = snap.arrays
    nxt = np.asarray(nxt, np.int64)
    n_rows = nxt.shape[0]
    if not 0 < n <= n_rows or ((nxt < -1) | (nxt >= n_rows)).any():
        raise ValueError("snapshot chain pointers or bucket count out of "
                         "range")
    depth, cur = 1, nxt[nxt >= 0]
    while cur.size and depth < 64:
        depth += 1
        hops = nxt[cur]
        cur = hops[hops >= 0]
    table = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (np.asarray(keys, np.int64),
                            np.asarray(vals, np.int64),
                            np.asarray(fps, np.uint8), nxt))
    return table, depth, int(n)


def old_art_prepare(arrays, device):
    """Seven arrays uploaded as the export holds them."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return (int(arrays.get("unit_bits", 8)),
            put(arrays["children"], np.int32),
            put(arrays["level"], np.int32),
            put(np.asarray(arrays["is_leaf"]) != 0, np.uint8),
            put(leaf_fp_lane(arrays), np.uint8),
            put(arrays["leaf_key"], np.int64),
            put(arrays["leaf_val"], np.int64))


def epoch_ms(pairs, reps: int = 5) -> None:
    """Host ms a per-epoch build, old and new in turns."""
    for tag, old, new in pairs:
        times = {"before": [], "now": []}
        for r in range(reps):
            for side in (("before", "now") if r % 2 == 0 else
                         ("now", "before")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = (old if side == "before" else new)()
                torch.cuda.synchronize()
                times[side].append((time.perf_counter() - t0) * 1e3)
                del out
        cs.say(f"{tag} per-epoch build: before {times['before']} ms "
               f"(median {statistics.median(times['before']):.3f}), now "
               f"{times['now']} ms (median "
               f"{statistics.median(times['now']):.3f})")


# -- rounds on the timed batch -------------------------------------------

def probe_rounds(arrays, depth: int, bucket: np.ndarray, group: int):
    """Dependent rounds of each query: the query and its bucket, the
    start line, then the rest of its chain ``group`` lines a round."""
    chain, pos, length = (t.numpy() for t in chain_walk(
        torch.from_numpy(np.asarray(arrays[2], np.int64))))
    rest = np.minimum(length[chain[bucket]] - 1 - pos[bucket], depth - 1)
    return 2 + -(-rest // group)


def radix_rounds(arrays, q: np.ndarray):
    """Dependent rounds of each query: the query, one a step (the root's
    entry too, an L1 hit after an SM's first warp), and one at a leaf."""
    children, level = arrays["children"], arrays["level"]
    is_leaf = np.asarray(arrays["is_leaf"]) != 0
    unit_bits = int(arrays.get("unit_bits", 8))
    n_units, fan = 64 // unit_bits, 1 << unit_bits
    uq = q.astype(np.uint64)
    node = np.zeros(q.size, np.int64)
    active = np.ones(q.size, bool)
    rounds = np.ones(q.size, np.int64)
    for _ in range(n_units + 1):
        idx = np.nonzero(active)[0]
        at = node[idx]
        rounds[idx] += 1   # an entry, or a leaf's words
        leaf = is_leaf[at]
        active[idx[leaf]] = False
        idx, at = idx[~leaf], at[~leaf]
        lvl = np.clip(level[at], 0, n_units - 1).astype(np.uint64)
        shift = np.uint64(unit_bits) * (np.uint64(n_units - 1) - lvl)
        unit = ((uq[idx] >> shift) & np.uint64(fan - 1)).astype(np.int64)
        child = children[at, unit].astype(np.int64)
        stop = child < 0
        active[idx[stop]] = False
        node[idx[~stop]] = child[~stop]
    return rounds


def floor(name, empty_ms, rounds, lo_ms, hi_ms) -> None:
    """The slowest query's rounds, each an L2 hit (``lo_ms``) or each a
    round over a table larger than L2 (``hi_ms``)."""
    n = int(rounds.max())
    cs.say(f"{name} floor: {empty_ms:.6f} + {n} rounds (mean "
           f"{rounds.mean():.3f}) x {lo_ms:.6f}-{hi_ms:.6f} ms = "
           f"{empty_ms + n * lo_ms:.6f}-{empty_ms + n * hi_ms:.6f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-clht", type=int, default=1 << 20)
    ap.add_argument("--n-art", type=int, default=1 << 19)
    ap.add_argument("--n-hot", type=int, default=1 << 18)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cs.check(torch.cuda.is_available(), "no CUDA device")
    say = cs.say
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    clht, clht_snap = loaded("clht", args.n_clht, args.seed)
    art, art_snap = loaded("art", args.n_art, args.seed)
    hot, hot_snap = loaded("hot", args.n_hot, args.seed)
    lines, depth, n = clht_snap.cache["clht_probe"]
    arrays = clht_snap.arrays
    rng = np.random.default_rng(args.seed + 2)
    resident = arrays[0][arrays[0] != 0]

    def on_card(qs):
        b = (cs.mix64(qs) % np.uint64(n)).astype(np.int64)
        return torch.from_numpy(qs).to(dev), torch.from_numpy(b).to(dev)

    probe_batches = [on_card(np.concatenate([
        rng.choice(resident, Q // 2), rng.integers(1, 1 << 62, Q // 2)]))
        for _ in range(64)]
    radix = {}
    for tag, snap in (("P-ART", art_snap), ("P-HOT", hot_snap)):
        leaves = snap.arrays["leaf_key"][
            np.asarray(snap.arrays["is_leaf"]) != 0]
        radix[tag] = (snap, [(torch.from_numpy(np.concatenate([
            rng.choice(leaves, Q // 2),
            rng.integers(1, 1 << 62, Q // 2)])).to(dev),)
            for _ in range(64)])
    art_pages = art_snap.cache["art_probe"]

    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp))
        lat = libs["latency"]
        empty_ms = dev_ms(lambda: cs.check(
            lat.empty(Q, BLOCK, stream()) == 0, "empty launch failed"),
            [()])
        say(f"empty kernel ({Q} threads, blocks of {BLOCK}): {empty_ms:.6f} "
            "ms")
        slopes = {}
        for lat_name, n_words in (
                ("8 MB, in L2", 1 << 20),
                ("P-HOT child table", hot_snap.cache["art_probe"][1].numel()
                 // 2),
                ("P-CLHT line table", lines.numel()),
                ("P-ART child table", art_pages[1].numel() // 2)):
            table = torch.empty(n_words, dtype=torch.int64, device=dev)
            perm = torch.randperm(n_words, device=dev)
            table[perm] = perm.roll(-1)  # one cycle through every word
            starts = [torch.randint(0, n_words, (Q,), device=dev)
                      for _ in range(64)]
            out = torch.empty(Q, dtype=torch.int64, device=dev)
            ks, ms = list(range(9)), []
            for k in ks:
                ms.append(dev_ms(lambda s, k=k: cs.check(lat.chase(
                    table.data_ptr(), s.data_ptr(), Q, k, BLOCK,
                    out.data_ptr(), stream()) == 0, "chase launch failed"),
                    [(s,) for s in starts]))
            slope = float(np.polyfit(ks[1:], ms[1:], 1)[0])
            slopes[lat_name] = slope
            say(f"chase over {n_words * 8} bytes ({lat_name}): "
                + ", ".join(f"k={k} {m:.6f}" for k, m in zip(ks, ms))
                + f" ms; {slope:.6f} ms a round")
            del table, perm
        lo, hi = slopes["8 MB, in L2"], slopes["P-ART child table"]

        # probe64_fp / probe64: the copies, the linked lines, kGroup 8
        linked = lines[:arrays[0].shape[0]].clone()
        linked[:, 6] = torch.from_numpy(np.asarray(arrays[2], np.int64)).to(
            dev)
        qt, bt = probe_batches[0]
        for name, use_fp in (("probe64_fp", True), ("probe64", False)):
            source = lambda a, b, u=use_fp: kprobe.probe_chain(  # noqa: E731
                a, b, lines, depth, use_fp=u)
            ref = source(qt, bt)
            variants = {
                "linked lines": probe_call(libs["probe linked"], linked,
                                           depth, use_fp),
                "kGroup 8": probe_call(libs["probe kGroup 8"], lines, depth,
                                       use_fp)}
            for vname, fn in variants.items():
                got = fn(qt, bt)
                for g, r in zip(got, ref):
                    cs.check(g is None or torch.equal(g, r),
                             f"{name} {vname}: differs from the source")
                turns = [dev_ms(f, probe_batches)
                         for f in (source, fn, fn, source)]
                say(f"{name} copies vs {vname}: {turns[0]:.6f}, "
                    f"{turns[1]:.6f}, {turns[2]:.6f}, {turns[3]:.6f} ms "
                    "(source, variant, variant, source)")
            blocks = {b: probe_call(libs[f"probe block {b}"], lines, depth,
                                    use_fp) for b in (32, 128)}
            for b, fn in blocks.items():
                for g, r in zip(fn(qt, bt), ref):
                    cs.check(g is None or torch.equal(g, r),
                             f"{name} block {b}: differs from the source")
            turns = [dev_ms(f, probe_batches) for f in (
                source, blocks[32], blocks[128], blocks[128], blocks[32],
                source)]
            say(f"{name} blocks of 64, 32, 128, 128, 32, 64: " + ", ".join(
                f"{ms:.6f}" for ms in turns) + " ms")
        for group, what in ((4, "probe64_fp"), (1, "linked lines")):
            floor(what, empty_ms,
                  probe_rounds(arrays, depth, bt.cpu().numpy(), group),
                  lo, hi)

        for tag, (snap, batches) in radix.items():
            unit_bits, *pages = snap.cache["art_probe"]
            source = lambda a, p=pages, u=unit_bits: kart.art_descend(  # noqa
                a, *p, unit_bits=u)
            fn = art_call(libs["art_descend staged root"], pages, unit_bits)
            blocks = {b: art_call(libs[f"art_descend block {b}"], pages,
                                  unit_bits) for b in (32, 128)}
            (q,) = batches[0]
            for vname, f in (("staged root", fn), ("block 32", blocks[32]),
                             ("block 128", blocks[128])):
                for g, r in zip(f(q), source(q)):
                    cs.check(torch.equal(g, r), f"art_descend ({tag}) "
                             f"{vname}: differs from the source")
            turns = [dev_ms(f, batches) for f in (source, fn, fn, source)]
            say(f"art_descend ({tag}) root from global vs staged root: "
                f"{turns[0]:.6f}, {turns[1]:.6f}, {turns[2]:.6f}, "
                f"{turns[3]:.6f} ms (source, variant, variant, source)")
            turns = [dev_ms(f, batches) for f in (
                source, blocks[32], blocks[128], blocks[128], blocks[32],
                source)]
            say(f"art_descend ({tag}) blocks of 64, 32, 128, 128, 32, 64: "
                + ", ".join(f"{ms:.6f}" for ms in turns) + " ms")
            floor(f"art_descend ({tag})", empty_ms,
                  radix_rounds(snap.arrays, q.cpu().numpy()), lo, hi)

    epoch_ms([
        ("P-CLHT", lambda: old_clht_prepare(clht_snap, dev),
         lambda: clht_ops._prepare(clht_snap, dev)),
        ("P-ART", lambda: old_art_prepare(art_snap.arrays, dev),
         lambda: art_ops._prepare(art_snap.arrays, dev))])
    del clht, art, hot
    return 0


if __name__ == "__main__":
    sys.exit(main())
