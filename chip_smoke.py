#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py [--n-clht 1048576] [--n-art 1048576]
                          [--n-hot 262144] [--n-masstree 262144]
                          [--n-bwtree 32768] [--n-cceh 32768]
                          [--n-fastfair 65536] [--n-level 16384]
                          [--seed 0]

Each path is a YCSB workload of 4096-op plans through
``repro_torch.api.open_index``.  Five paths drive one of RECIPE's
converted indexes each:

* P-CLHT, whose read waves run the chained probe kernel
  (``src/repro_torch/csrc/probe.cu``), and P-ART and P-HOT, whose read
  waves run the radix-descent kernel (``csrc/art_descend.cu``, 8-bit
  and 4-bit units): Load A, a powerfail crash after which every loaded
  key reads back, YCSB-C (every lookup found with ``value_of(key)``),
  YCSB-A (acked writes and found reads as the mix implies), 8 YCSB-C
  plans with fingerprints off, and 4096 sampled keys through the kernel
  path against scalar lookups (for the radix trees with key 0 and keys
  of 2^63 and above);
* P-Masstree and P-BwTree, whose lookups and range scans run the
  sorted-run search kernel (``csrc/scan_window.cu``): Load A, powerfail
  and read-back, YCSB-C (windows of 1), YCSB-E0 (pure scans, windows of
  128, every result equal to the scalar ``scan``), and for P-Masstree a
  short YCSB-E (5% inserts; its scan waves mostly run scalar, below the
  stale-snapshot floor).

The sixth, the scale-out path, drives ``open_index(kind, shards=S)``:
every plan is routed by the shard-routing kernel
(``csrc/shard_route.cu``):

* P-CLHT in 8 shards (``--n-clht`` keys, hash routing): Load A, YCSB-C
  through the mesh read path (all 8 shards' sorted runs searched in one
  launch of ``csrc/scan_window.cu`` with a shard axis) and through the
  per-shard path, the same plans on the unsharded P-CLHT of the first
  path, YCSB-A, a crash injected inside one shard's group commit (the
  siblings serve the plan's new values with no replay; the shard is
  power-failed and its sub-plan replayed; every acknowledged key reads
  back), and 4 client streams of overlapping YCSB-A plans through
  ``StreamDriver``, whose admission runs the conflict kernel
  (``csrc/conflict_any.cu``): some plans defer, and every ticket's
  results equal a sequential oracle applied in tick order;
* CCEH unsharded and in 8 shards (``--n-cceh``): Load A, YCSB-C and
  YCSB-A, with the reference's two columns for P-CLHT and CCEH
  (modeled ``critical_ns`` and wall kops/s, and 8-shard / 1-shard);
* FAST&FAIR in 4 shards (``--n-fastfair``, prefix routing on key bits
  59-58, since YCSB keys lie below 2^60): YCSB-E0 scans merged across
  shards, each equal to the merge of every shard's scalar ``scan``;
  Level hashing unsharded (``--n-level``): YCSB-C.

Phases, each of which exits non-zero on failure:

1. card check: a CUDA device, its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, compiled in parallel;
3. the six paths, each with every kernel's launch count set to 0 just
   before it and read just after; a path fails if a kernel it runs was
   not launched;
4. each kernel against its plain PyTorch version on the card, on 4096
   queries made from ``--seed`` over a table a path loaded (hits,
   misses, fingerprint near-misses, key 0, and keys of 2^63 and above
   where the index takes them): outputs must be bit-identical; then
   per-launch times at the main path's shape (device time from the
   profiler, call time from CUDA events), beside the plain version's,
   a library call's where one computes the same function, and the
   least time the card could take (``bound_ms``).

The last two lines are the ``kernels`` JSON and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, the script fails before printing
either.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import build  # noqa: E402
from repro_torch.api import Plan, open_index  # noqa: E402
from repro_torch.core import CrashPoint  # noqa: E402
from repro_torch.core.ycsb import PhaseExecutor, generate  # noqa: E402
from repro_torch.distributed import streams as dstreams  # noqa: E402
from repro_torch.kernels import art_probe as kart  # noqa: E402
from repro_torch.kernels import conflict as kconf  # noqa: E402
from repro_torch.kernels import partition as kpart  # noqa: E402
from repro_torch.kernels import probe as kprobe  # noqa: E402
from repro_torch.kernels import scan as kscan  # noqa: E402
from repro_torch.obs import Histogram  # noqa: E402
from repro_torch.kernels.clht_probe import mix64  # noqa: E402
from repro_torch.kernels.probe import fp64, fp_partial  # noqa: E402

PLAN_OPS = 4096
Q = 4096  # queries per launch on the main path (one full read wave)
SLOTS = 3
HIGH = -(1 << 63)  # 2^63 as an int64 bit pattern
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the float32 rate
# outside the tensor cores standing in for 32-bit integer lanes
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12
SOURCES = {"probe64_fp": "src/repro_torch/csrc/probe.cu",
           "probe64": "src/repro_torch/csrc/probe.cu",
           "art_descend": "src/repro_torch/csrc/art_descend.cu",
           "scan_window": "src/repro_torch/csrc/scan_window.cu",
           "scan_window_sharded": "src/repro_torch/csrc/scan_window.cu",
           "shard_route": "src/repro_torch/csrc/shard_route.cu",
           "conflict_any": "src/repro_torch/csrc/conflict_any.cu"}
# the sharded search is scan_window with a shard axis; on the JAX
# package's mesh path it takes the place of a vmapped lower bound
# (src/repro/distributed/mesh.py:84), which is not a Pallas kernel
REPLACES = {"probe64_fp": "src/repro/kernels/probe/kernel.py:76",
            "probe64": "src/repro/kernels/probe/kernel.py:108",
            "art_descend": "src/repro/kernels/art_probe/kernel.py:96",
            "scan_window": "src/repro/kernels/scan/kernel.py:79",
            "scan_window_sharded": "src/repro/kernels/scan/kernel.py:79",
            "shard_route": "src/repro/kernels/partition/kernel.py:102",
            "conflict_any": "src/repro/kernels/conflict/kernel.py:64"}
COUNTERS = (kprobe.LAUNCHES, kart.LAUNCHES, kscan.LAUNCHES, kpart.LAUNCHES,
            kconf.LAUNCHES)
SHARDS = 8
STREAMS = 4
STREAM_PLANS = 4  # plans per stream on the scale-out path
C_PLANS = 64  # timed YCSB-C plans per column of the reporting model


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def say(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for counts in COUNTERS:
        for name in counts:
            counts[name] = 0


def read_counts() -> dict:
    return {name: n for counts in COUNTERS for name, n in counts.items()}


def value_of(keys: np.ndarray) -> np.ndarray:
    """Vectorized ``core.ycsb.value_of``."""
    return (keys ^ 0x5DEECE66D) & ((1 << 62) - 1) | 1


def get_plan(keys: np.ndarray) -> Plan:
    n = keys.shape[0]
    return Plan.from_arrays(np.zeros(n, np.int32), keys, np.zeros(n, np.int64))


def op_keys(ops, kind=None) -> np.ndarray:
    return np.fromiter((k for o, k, _ in ops if kind in (None, o)), np.int64)


def read_back(session, keys: np.ndarray, what: str) -> None:
    """Every key must read back through plans with ``value_of(key)``.
    The first plan forces the kernel path, so a stale snapshot is
    re-exported once (an index whose rebuild floor scales with its size
    would otherwise answer these plans with scalar lookups)."""
    for lo in range(0, keys.shape[0], PLAN_OPS):
        chunk = keys[lo:lo + PLAN_OPS]
        res = session.execute(get_plan(chunk), force_kernel=lo == 0).results
        check(None not in res, f"{what}: a key did not read back")
        check(np.array_equal(np.asarray(res, np.int64), value_of(chunk)),
              f"{what}: a value differs from value_of(key)")


def timed_run(index, ops) -> tuple:
    ex = PhaseExecutor(index, batch_lookups=True, max_batch=PLAN_OPS)
    t0 = time.perf_counter()
    done = ex.run(ops)
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0


def rate(n: int, secs: float) -> str:
    return f"{n} ops in {secs:.3f} s ({n / secs / 1e3:.3f} kops/s)"


def load_and_crash(session, n_load: int, seed: int, tag: str):
    """Load A, then a powerfail after which every key reads back."""
    load = generate("C", n_load, n_load, seed=seed)
    loaded = op_keys(load.load_ops)
    done, secs = timed_run(session.index, load.load_ops)
    check(done["acked"] == len(load.load_ops), f"{tag} Load A: an insert "
          "was not acknowledged")
    say(f"{tag} load: {rate(len(load.load_ops), secs)}")
    session.crash()
    t0 = time.perf_counter()
    read_back(session, loaded, f"{tag} after powerfail")
    say(f"{tag} crash: powerfail after the load; all {loaded.size} acked "
        f"keys read back in {time.perf_counter() - t0:.3f} s")
    return load, loaded


def ycsb_c(session, load, tag: str) -> None:
    done, secs = timed_run(session.index, load.run_ops)
    check(done["found"] == len(load.run_ops), f"{tag} YCSB-C: a lookup "
          "missed")
    say(f"{tag} YCSB-C: {rate(len(load.run_ops), secs)}, all found")
    read_back(session, op_keys(load.run_ops), f"{tag} YCSB-C")
    say(f"{tag} YCSB-C: every value equals value_of(key)")


def point_path(session, n_load: int, seed: int, tag: str, *,
               edge_keys: bool) -> None:
    """P-CLHT, P-ART, P-HOT: load, crash, C, A, C without fingerprints
    and a sample through the kernel path against scalar lookups."""
    index = session.index
    load, loaded = load_and_crash(session, n_load, seed, tag)
    ycsb_c(session, load, tag)

    mix_a = generate("A", n_load, max(n_load // 4, PLAN_OPS), seed=seed)
    done, secs = timed_run(index, mix_a.run_ops)
    check(done["acked"] == done["insert"], f"{tag} YCSB-A: an insert of a "
          "fresh key was not acknowledged")
    check(done["found"] == done["lookup"], f"{tag} YCSB-A: a lookup of a "
          "loaded key missed")
    say(f"{tag} YCSB-A: {rate(len(mix_a.run_ops), secs)}, {done['acked']} "
        f"acked of {done['insert']} inserts, {done['found']} found of "
        f"{done['lookup']} lookups")

    index.fingerprints = False
    c_off = op_keys(load.run_ops[:8 * PLAN_OPS])
    t0 = time.perf_counter()
    found = sum(session.execute(get_plan(c_off[lo:lo + PLAN_OPS]),
                                force_kernel=lo == 0).found
                for lo in range(0, c_off.size, PLAN_OPS))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    index.fingerprints = True
    check(found == c_off.size, f"{tag} YCSB-C, fingerprints off: a lookup "
          "missed")
    say(f"{tag} YCSB-C, fingerprints off: {rate(c_off.size, secs)} (the "
        "first plan re-exports), all found")

    rng = np.random.default_rng(seed + 1)
    edge = np.array([0, HIGH, -1, loaded[0] | HIGH] if edge_keys else [],
                    np.int64)
    sample = np.concatenate([
        rng.choice(loaded, PLAN_OPS // 2),
        rng.choice(op_keys(mix_a.run_ops, "insert"), PLAN_OPS // 4),
        rng.integers(1, 1 << 62, size=PLAN_OPS // 4 - edge.size), edge])
    res = session.execute(get_plan(sample), force_kernel=True).results
    check(res == [index.lookup(int(k)) for k in sample],
          f"{tag} sampled keys: the kernel path differs from scalar lookup")
    say(f"{tag} sample: {sample.size} keys through the kernel path equal "
        "scalar lookup" + (" (key 0 and keys >= 2^63 included)"
                           if edge_keys else ""))


def scan_phase(session, ops, tag: str, *, check_all: bool) -> None:
    """Scan plans; with ``check_all`` every scan result must equal the
    scalar ``scan`` of the same (start, count)."""
    t0 = time.perf_counter()
    results = []
    for lo in range(0, len(ops), PLAN_OPS):
        res = session.execute(Plan.from_ops(ops[lo:lo + PLAN_OPS]))
        results.extend(res.results)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    scans = [(i, k, n) for i, (o, k, n) in enumerate(ops) if o == "scan"]
    scanned = sum(len(results[i]) for i, _, _ in scans)
    say(f"{tag}: {rate(len(ops), secs)}, {len(scans)} scans returned "
        f"{scanned} records")
    if check_all:
        index = session.index
        check(all(results[i] == index.scan(k, n) for i, k, n in scans),
              f"{tag}: a batched scan differs from the scalar scan")
        say(f"{tag}: every scan equals the scalar scan")


def sorted_path(session, n_load: int, seed: int, tag: str, *,
                n_e0: int, n_e: int) -> None:
    """P-Masstree, P-BwTree: load, crash, C, E0 and a short E."""
    load, _ = load_and_crash(session, n_load, seed, tag)
    ycsb_c(session, load, tag)
    before = kscan.LAUNCHES["scan_window"]
    scan_phase(session, generate("E0", n_load, n_e0, seed=seed).run_ops,
               f"{tag} YCSB-E0", check_all=True)
    check(kscan.LAUNCHES["scan_window"] > before, f"{tag} YCSB-E0: no scan "
          "wave ran the kernel")
    if n_e:
        before = kscan.LAUNCHES["scan_window"]
        scan_phase(session, generate("E", n_load, n_e, seed=seed).run_ops,
                   f"{tag} YCSB-E", check_all=False)
        say(f"{tag} YCSB-E: scan_window launches "
            f"{kscan.LAUNCHES['scan_window'] - before}")


# -- the scale-out path -----------------------------------------------------

def checked_results(res, want: np.ndarray, what: str) -> None:
    check(None not in res.results, f"{what}: a key did not read back")
    check(np.array_equal(np.asarray(res.results, np.int64), want),
          f"{what}: a value differs from the acknowledged one")


def c_columns(index, keys: np.ndarray, tag: str, **kw) -> tuple:
    """YCSB-C plans of ``keys`` (every result must be ``value_of(key)``):
    (wall kops/s, modeled kops/s) over all plans but the first, which
    is forced onto the kernel path (a stale snapshot is re-exported)
    and not timed.  Modeled is ``critical_ns`` (routing + the slowest
    shard + merge) for a sharded index, the wall time otherwise."""
    wall = crit = n = 0
    for lo in range(0, keys.size, PLAN_OPS):
        chunk = keys[lo:lo + PLAN_OPS]
        t0 = time.perf_counter_ns()
        res = index.execute(get_plan(chunk), force_kernel=lo == 0, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter_ns() - t0
        checked_results(res, value_of(chunk), f"{tag} YCSB-C")
        if lo:
            wall += dt
            crit += getattr(res, "critical_ns", dt)
            n += chunk.size
    check(n > 0, f"{tag} YCSB-C: fewer than two plans to time")
    return n / wall * 1e6, n / crit * 1e6


def report_columns(tag: str, one: tuple, many: tuple, shards: int) -> None:
    say(f"{tag} YCSB-C, reporting model: 1 shard wall {one[0]:.3f} / "
        f"modeled {one[1]:.3f} kops/s; {shards} shards wall "
        f"{many[0]:.3f} / modeled {many[1]:.3f} kops/s; {shards}-shard / "
        f"1-shard wall {many[0] / one[0]:.3f}x, modeled "
        f"{many[1] / one[1]:.3f}x")


def ycsb_a(index, n_load: int, seed: int, tag: str) -> np.ndarray:
    """YCSB-A (a quarter of the load); returns the inserted keys."""
    mix_a = generate("A", n_load, max(n_load // 4, PLAN_OPS), seed=seed)
    done, secs = timed_run(index, mix_a.run_ops)
    check(done["acked"] == done["insert"], f"{tag} YCSB-A: an insert of a "
          "fresh key was not acknowledged")
    check(done["found"] == done["lookup"], f"{tag} YCSB-A: a lookup of a "
          "loaded key missed")
    say(f"{tag} YCSB-A: {rate(len(mix_a.run_ops), secs)}, {done['acked']} "
        f"acked of {done['insert']} inserts, {done['found']} found of "
        f"{done['lookup']} lookups")
    return op_keys(mix_a.run_ops, "insert")


def shard_crash(session, loaded: np.ndarray, inserted: np.ndarray,
                rng, tag: str) -> dict:
    """A crash inside one shard's group commit during a cross-shard
    update plan: the siblings finish and serve the new values with no
    replay; the shard is power-failed, its sub-plan replayed, and then
    every acknowledged key reads back.  Returns the updated values."""
    idx = session.index
    keys = rng.choice(loaded, PLAN_OPS, replace=False)
    new = value_of(keys) ^ 2
    routes = idx.route(keys)
    victim = int(routes[0])
    mine = routes == victim
    idx.pmems[victim].arm_crash(after_stores=int(mine.sum()) // 2)
    try:
        session.execute(Plan.from_arrays(np.full(keys.size, 2, np.int32),
                                         keys, new))
        crashed = False
    except CrashPoint:
        crashed = True
    check(crashed and idx.last_crashed_shard == victim,
          f"{tag} crash: the armed shard did not crash")
    check(all(pm.crashes == 0 for s, pm in enumerate(idx.pmems)
              if s != victim), f"{tag} crash: a sibling shard crashed")
    sib = idx.execute(get_plan(keys[~mine]), mesh=False)
    checked_results(sib, new[~mine], f"{tag} crash: a sibling shard")
    check(idx.stats["replayed_ops"] == 0, f"{tag} crash: a replay ran "
          "before recovery")
    t0 = time.perf_counter()
    idx.crash_shard(victim)
    replayed = idx.recover_shard(victim, replay=True)
    check(replayed == int(mine.sum()), f"{tag} crash: the replay ran "
          f"{replayed} ops, not the shard's {int(mine.sum())}")
    acked = np.concatenate([loaded, inserted])
    want = value_of(acked)
    order = np.argsort(loaded)
    want[order[np.searchsorted(loaded, keys, sorter=order)]] = new
    for lo in range(0, acked.size, PLAN_OPS):
        res = idx.execute(get_plan(acked[lo:lo + PLAN_OPS]),
                          force_kernel=lo == 0, mesh=False)
        checked_results(res, want[lo:lo + PLAN_OPS],
                        f"{tag} crash: after the replay")
    say(f"{tag} crash: shard {victim} crashed inside its group commit; "
        f"{int((~mine).sum())} sibling ops served their new values with "
        f"no replay; {replayed} ops replayed; all {acked.size} acked keys "
        f"read back in {time.perf_counter() - t0:.3f} s")
    return dict(zip(keys.tolist(), new.tolist()))


def stream_phase(session, loaded: np.ndarray, updated: dict, rng,
                 tag: str) -> dict:
    """4 client streams of YCSB-A plans (lookups of loaded keys, inserts
    of fresh keys above 2^61) over one shared op list, neighbouring
    plans overlapping by half, so duplicate inserts conflict and some
    plans defer.  Every ticket's results must equal a sequential oracle
    applied in tick order (plans admitted in one tick are conflict-free,
    so their order within it does not matter).  Returns the admission
    checks' inputs, the largest reference set last."""
    n_ops = (STREAMS * STREAM_PLANS + 1) * PLAN_OPS // 2
    is_get = rng.random(n_ops) < 0.5
    keys = np.where(is_get, rng.choice(loaded, n_ops),
                    rng.integers(1 << 61, 1 << 62, size=n_ops))
    ops = [("lookup", int(k), 0) if g else ("insert", int(k),
                                            int(value_of(k)))
           for g, k in zip(is_get, keys)]
    hist = Histogram("streams")
    drv = session.streams(STREAMS, lat_hist=hist)
    tickets = []
    for i in range(STREAMS * STREAM_PLANS):
        lo = i * PLAN_OPS // 2
        tickets.append(drv.streams[i % STREAMS].submit(
            Plan.from_ops(ops[lo:lo + PLAN_OPS])))
    checks = []
    real = dstreams.conflict_any

    def recorded(kinds_a, keys_a, kinds_b, keys_b, **kw):
        checks.append((kinds_a, keys_a, kinds_b, keys_b))
        return real(kinds_a, keys_a, kinds_b, keys_b, **kw)

    dstreams.conflict_any = recorded
    t0 = time.perf_counter()
    try:
        ticks = drv.run()
    finally:
        dstreams.conflict_any = real
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(not drv.pending(), f"{tag} streams: a plan was never admitted")
    check(drv.stats["deferred_plans"] > 0, f"{tag} streams: no plan "
          "deferred")
    inserted = set()
    for t in sorted(tickets, key=lambda t: t.tick):
        want = []
        for kind, k, _ in plan_ops(t.plan):
            if kind == "lookup":
                want.append(value_of(k) if k in inserted
                            else updated.get(k, int(value_of(k))))
            else:
                want.append(k not in inserted)
                inserted.add(k)
        check(t.result == want, f"{tag} streams: a ticket's results "
              "differ from the sequential oracle")
    p50, p99 = (hist.percentile(q) / 1e3 for q in (50, 99))
    say(f"{tag} streams: {STREAMS} streams, {len(tickets)} plans of "
        f"{PLAN_OPS} YCSB-A ops in {ticks} ticks, {secs:.3f} s "
        f"({len(tickets) * PLAN_OPS / secs / 1e3:.3f} kops/s wall); "
        f"deferred_plans {drv.stats['deferred_plans']}, multi-stream "
        f"ticks {drv.stats['multi_stream_ticks']}; tick-amortized "
        f"latency p50 {p50:.3f} us, p99 {p99:.3f} us per op; "
        f"{len(checks)} admission checks, reference sets of "
        f"{min(c[2].size for c in checks)}-"
        f"{max(c[2].size for c in checks)} ops; every ticket equals the "
        "sequential oracle")
    checks.sort(key=lambda c: c[2].size)
    return checks


def plan_ops(plan):
    names = {0: "lookup", 1: "insert", 2: "update", 3: "delete", 4: "scan"}
    kinds, keys, aux = plan.arrays()
    return [(names[int(o)], int(k), int(a))
            for o, k, a in zip(kinds, keys, aux)]


def clht_scale_out(sessions, n_load: int, seed: int) -> dict:
    tag = f"P-CLHT x{SHARDS}"
    session = open_index("clht", shards=SHARDS, mesh_reads=True)
    idx = session.index
    check(session.device.type == "cuda" and all(
        sh.device.type == "cuda" for sh in idx.shards),
        f"{tag}: the shards are not on the card")
    load = generate("C", n_load, n_load, seed=seed)
    loaded = op_keys(load.load_ops)
    done, secs = timed_run(idx, load.load_ops)
    check(done["acked"] == loaded.size, f"{tag} Load A: an insert was not "
          "acknowledged")
    say(f"{tag} load: {rate(loaded.size, secs)}")
    c_keys = op_keys(load.run_ops[:(C_PLANS + 1) * PLAN_OPS])
    before = idx.stats["mesh_plans"]
    t0 = time.perf_counter()
    mesh = c_columns(idx, c_keys, f"{tag} mesh", mesh=True)
    n_plans = -(-c_keys.size // PLAN_OPS)
    check(idx.stats["mesh_plans"] - before == n_plans,
          f"{tag}: a YCSB-C plan did not take the mesh path")
    say(f"{tag} YCSB-C, mesh path: wall {mesh[0]:.3f} kops/s, modeled "
        f"{mesh[1]:.3f} kops/s, all found ({n_plans} plans, the "
        f"first re-exporting every shard's run; "
        f"{time.perf_counter() - t0:.3f} s)")
    per_shard = c_columns(idx, c_keys, f"{tag} per-shard", mesh=False)
    one = c_columns(sessions["P-CLHT"].index, c_keys, "P-CLHT")
    report_columns("P-CLHT", one, per_shard, SHARDS)
    inserted = ycsb_a(idx, n_load, seed, tag)
    rng = np.random.default_rng(seed + 7)
    updated = shard_crash(session, loaded, inserted, rng, tag)
    checks = stream_phase(session, loaded, updated, rng, tag)
    return {"session": session, "c_keys": c_keys, "checks": checks}


def cceh_columns(n_load: int, seed: int) -> None:
    cols = {}
    for shards in (1, SHARDS):
        tag = "CCEH" if shards == 1 else f"CCEH x{shards}"
        session = open_index("cceh", shards=shards)
        load = generate("C", n_load, n_load, seed=seed)
        done, secs = timed_run(session.index, load.load_ops)
        check(done["acked"] == len(load.load_ops), f"{tag} Load A: an "
              "insert was not acknowledged")
        say(f"{tag} load: {rate(len(load.load_ops), secs)}")
        kw = {"mesh": False} if shards > 1 else {}
        cols[shards] = c_columns(session.index, op_keys(
            load.run_ops[:(C_PLANS + 1) * PLAN_OPS]), tag, **kw)
        say(f"{tag} YCSB-C: wall {cols[shards][0]:.3f} kops/s, modeled "
            f"{cols[shards][1]:.3f} kops/s, all found")
        ycsb_a(session.index, n_load, seed, tag)
    report_columns("CCEH", cols[1], cols[SHARDS], SHARDS)


def fastfair_scans(n_load: int, seed: int) -> None:
    tag = "FAST&FAIR x4"
    session = open_index("fastfair", shards=4, scheme="prefix@59")
    idx = session.index
    load = generate("E0", n_load, 2 * PLAN_OPS, seed=seed)
    done, secs = timed_run(idx, load.load_ops)
    check(done["acked"] == len(load.load_ops), f"{tag} Load A: an insert "
          "was not acknowledged")
    loaded = op_keys(load.load_ops)
    per_shard = np.bincount(idx.route(loaded), minlength=4)
    check((per_shard > 0).all(), f"{tag}: a shard holds no key")
    say(f"{tag} load: {rate(loaded.size, secs)}; keys per shard "
        f"{per_shard.tolist()}")
    read_back(session, loaded[:PLAN_OPS], f"{tag} YCSB-C")
    merges, launched = idx.stats["scan_merges"], kscan.LAUNCHES["scan_window"]
    ops = load.run_ops
    t0 = time.perf_counter()
    results = []
    for lo in range(0, len(ops), PLAN_OPS):
        results.extend(session.execute(Plan.from_ops(
            ops[lo:lo + PLAN_OPS])).results)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(idx.stats["scan_merges"] - merges == len(ops), f"{tag} YCSB-E0: "
          "a scan was not merged across shards")
    check(kscan.LAUNCHES["scan_window"] > launched, f"{tag} YCSB-E0: no "
          "scan wave ran the kernel")
    # the scalar walk of every shard's leaves, merged
    items = sorted(kv for sh in idx.shards for kv in sh.items())
    starts = np.fromiter((k for k, _ in items), np.int64, len(items))
    for (_, k, n), got in zip(ops, results):
        lo = int(np.searchsorted(starts, k))
        check(got == items[lo:lo + n], f"{tag} YCSB-E0: a merged scan "
              "differs from the shards' scalar items")
    say(f"{tag} YCSB-E0: {rate(len(ops), secs)}, {len(ops)} scans merged "
        "across shards, each equal to the scalar walk of every shard's "
        "items")


def level_reads(n_load: int, seed: int) -> None:
    tag = "Level hashing"
    session = open_index("level")
    load = generate("C", n_load, n_load, seed=seed)
    done, secs = timed_run(session.index, load.load_ops)
    check(done["acked"] == len(load.load_ops), f"{tag} Load A: an insert "
          "was not acknowledged")
    say(f"{tag} load: {rate(len(load.load_ops), secs)}")
    wall, _ = c_columns(session.index, op_keys(load.run_ops), tag)
    say(f"{tag} YCSB-C: {wall:.3f} kops/s (the first plan re-exports), "
        "every value equals value_of(key)")


def scale_out_path(sessions, args) -> dict:
    out = clht_scale_out(sessions, args.n_clht, args.seed)
    cceh_columns(args.n_cceh, args.seed)
    fastfair_scans(args.n_fastfair, args.seed)
    level_reads(args.n_level, args.seed)
    return out


# -- kernels against their plain versions ---------------------------------

def time_calls(fn, batches, reps: int):
    """(device ms, call ms) per call, cycling through ``batches`` so
    most rows the batches touch are not in L2 (the main path's plans
    probe different keys each time).  Call ms: CUDA events around
    ``reps`` back-to-back calls, host launch cost included.  Device ms:
    the summed duration of the CUDA kernels the profiler records over
    ``reps`` calls, or None when it records none."""
    for b in batches[-4:]:
        fn(*b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*batches[i % len(batches)])
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(reps):
            fn(*batches[i % len(batches)])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in kernels)
    names = sorted(kernels, key=lambda e: -e.device_time_total)[:3]
    say("  profiler: " + ("; ".join(
        f"{e.key[:60]} x{e.count} {e.device_time_total:.1f} us"
        for e in names) or "no device kernels recorded"))
    return (dev_us / 1e3 / reps if dev_us > 0 else None), call_ms


def bound(n_bytes: float, ops: float):
    """Least time in ms: bytes over HBM bandwidth against lane
    operations over the lane rate, and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / LANE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got, plain) -> int:
    """Bit-identical or fail; the max abs error (0) over all outputs."""
    err = 0
    for g, p in zip(got, plain):
        if p is None:
            continue
        check(torch.equal(g, p), f"{name}: kernel differs from its plain "
              "version")
        err = max(err, int((g.to(torch.int64) - p.to(torch.int64))
                           .abs().max()))
    return err


def row(name: str, launches: dict, err: int, timed: dict, bms: float,
        by: str, library_ms, shape: str) -> dict:
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": float(err), "ms": timed["ms"],
            "plain_ms": timed["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": shape}


def time_kernel(name: str, fn, plain_fn, batches, reps: int = 640) -> dict:
    """The kernel's and the plain version's time per call: the card's
    time where the profiler saw the kernels, else the event time per
    call (which then includes the host's launch cost)."""
    dev_ms, call_ms = time_calls(fn, batches, reps)
    plain_dev, plain_call = time_calls(plain_fn, batches, 32)
    say(f"{name}: device {dev_ms} ms, call {call_ms:.6f} ms per launch; "
        f"plain: device {plain_dev} ms, call {plain_call:.6f} ms")
    return {"ms": dev_ms if dev_ms is not None else call_ms,
            "plain_ms": plain_dev if plain_dev is not None else plain_call}


def probe_table(index):
    """The table the P-CLHT path's last read wave probed: (keys, vals,
    fps, nxt) on the card, the longest chain, the bucket count, and the
    host export it was uploaded from."""
    snap = index.snapshot()
    check("clht_probe" in snap.cache, "the P-CLHT path left no table on "
          "the card")
    return snap.cache["clht_probe"], snap.arrays


def probe_queries(arrays, depth: int, n: int, rng) -> np.ndarray:
    """Hits, misses, fingerprint near-misses (a fresh key whose
    fingerprint equals a slot's in its own chain), values of 2^32 and
    above, and key 0."""
    keys, _, nxt, n_buckets, fps = arrays
    resident = keys[keys != 0]
    hits = rng.choice(resident, n // 2)
    misses = rng.integers(1, 1 << 62, size=n // 4)
    pool = rng.integers(1, 1 << 62, size=1 << 21)
    pool = pool[~np.isin(pool, resident)]
    row_ = (mix64(pool) % np.uint64(n_buckets)).astype(np.int64)
    pfp = fp64(pool)
    near = np.zeros(pool.size, bool)
    for _ in range(depth):
        live = row_ >= 0
        safe = np.where(live, row_, 0)
        near |= live & (fps[safe] == pfp[:, None]).any(axis=1)
        row_ = np.where(live, nxt[safe], -1)
    n_near = n - hits.size - misses.size - 4
    check(int(near.sum()) >= n_near, "too few fingerprint near-misses")
    q = np.concatenate([hits, misses, pool[near][:n_near],
                        np.zeros(4, np.int64)])
    rng.shuffle(q)
    return q


def probe_bound(arrays, depth: int, q: np.ndarray, use_fp: bool):
    """Least time for one probe launch: the bytes this batch's data
    needs (each input byte read once, each output written once) over
    HBM bandwidth, against its lane operations over the lane rate."""
    keys, vals, nxt, n_buckets, fps = arrays
    row_ = (mix64(q) % np.uint64(n_buckets)).astype(np.int64)
    qfp = fp64(q)
    rows, cand, found = set(), set(), set()
    n_cand = 0
    got = np.zeros(q.size, bool)
    for _ in range(depth):
        live = row_ >= 0
        safe = np.where(live, row_, 0)
        rows.update(row_[live].tolist())
        match = fps[safe] == qfp[:, None] if use_fp else np.ones(
            (q.size, SLOTS), bool)
        match &= live[:, None]
        hit = match & (keys[safe] == q[:, None])
        for i, s in zip(*np.nonzero(match)):
            cand.add((int(safe[i]), int(s)))
        first = hit & ~got[:, None]
        first &= np.cumsum(first, axis=1) == 1
        for i, s in zip(*np.nonzero(first)):
            found.add((int(safe[i]), int(s)))
        got |= hit.any(axis=1)
        n_cand += int(match.sum())
        row_ = np.where(live, nxt[safe], -1)
    per_row = (SLOTS + 8) if use_fp else (SLOTS * 8 + 8)
    n_bytes = (q.size * 16 + len(rows) * per_row
               + (len(cand) * 8 if use_fp else 0) + len(found) * 8
               + q.size * (1 + 8 + (8 if use_fp else 0)))
    lanes = q.size * depth * SLOTS
    return bound(n_bytes, q.size * 30 + lanes + 2 * n_cand)


def probe_vs_plain(index, seed: int, launches: dict) -> list:
    (table, depth, n), arrays = probe_table(index)
    dev = table[0].device
    keys, vals, fps, nxt = table
    n_bytes = sum(t.numel() * t.element_size() for t in table)
    say(f"P-CLHT table: {keys.shape[0]} rows, {n} buckets, longest chain "
        f"{depth}, {n_bytes} bytes on {dev}")
    rng = np.random.default_rng(seed + 2)
    q = probe_queries(arrays, depth, Q, rng)

    def on_card(qs):
        b = (mix64(qs) % np.uint64(n)).astype(np.int64)
        return torch.from_numpy(qs).to(dev), torch.from_numpy(b).to(dev)

    qt, bt = on_card(q)
    resident = arrays[0][arrays[0] != 0]
    timing = [on_card(np.concatenate([rng.choice(resident, Q // 2),
                                      rng.integers(1, 1 << 62, Q // 2)]))
              for _ in range(64)]
    rows = []
    for name, use_fp in (("probe64_fp", True), ("probe64", False)):
        got = kprobe.probe_chain(qt, bt, keys, vals, fps, nxt, depth,
                                 use_fp=use_fp)
        torch.cuda.synchronize()
        plain = kprobe.probe_chain_plain(qt, bt, keys, vals, fps, nxt, depth,
                                         use_fp=use_fp)
        err = compare(name, got, plain)
        found = got[0].cpu().numpy()
        check(found.sum() >= Q // 2, f"{name}: drawn hits were not found")
        check((got[1].cpu().numpy()[found] >= 1 << 32).any(),
              f"{name}: no value of 2^32 or above")
        if use_fp:
            check(int(got[3].sum()) > 0, "probe64_fp: no fingerprint "
                  "false positive reached the full compare")
        say(f"{name}: bit-identical to its plain version on {Q} queries "
            f"({int(found.sum())} found)")
        timed = time_kernel(name, lambda a, b: kprobe.probe_chain(
            a, b, keys, vals, fps, nxt, depth, use_fp=use_fp),
            lambda a, b: kprobe.probe_chain_plain(
                a, b, keys, vals, fps, nxt, depth, use_fp=use_fp), timing)
        bms, by = probe_bound(arrays, depth, q, use_fp)
        say(f"{name}: bound {bms:.9f} ms ({by}) at Q={Q}, depth {depth}; "
            f"main-path launches {launches[name]}")
        rows.append(row(name, launches, err, timed, bms, by, None,
                        f"P-CLHT, Q={Q}, depth {depth}"))
    return rows


def radix_queries(arrays, n: int, rng) -> np.ndarray:
    """Hits, misses, partial-key near-misses (a leaf's key with bit 8
    flipped: the walk, which stops at the leaf's shallow level, reaches
    the same leaf, whose low byte matches and whose key does not), key
    0 and keys of 2^63 and above."""
    leaves = arrays["leaf_key"][np.asarray(arrays["is_leaf"]) != 0]
    hits = rng.choice(leaves, n // 2)
    near = rng.choice(leaves, n // 4) ^ 0x100
    edge = np.array([0, HIGH, -1, leaves[0] | HIGH], np.int64)
    misses = rng.integers(1, 1 << 62, size=n - hits.size - near.size - 4)
    q = np.concatenate([hits, near, misses, edge]).astype(np.int64)
    rng.shuffle(q)
    return q


def radix_bound(arrays, q: np.ndarray):
    """Least time for one descent launch over this batch: each visited
    inner row's level and is_leaf bytes and the one child entry taken,
    each reached leaf's is_leaf and fingerprint bytes, key and value
    words of the leaves whose fingerprint matched, the queries, and the
    outputs (found, value, three counts)."""
    children, level = arrays["children"], arrays["level"]
    is_leaf = np.asarray(arrays["is_leaf"]) != 0
    lfp = np.asarray(arrays["leaf_fp"])
    unit_bits = int(arrays.get("unit_bits", 8))
    n_units, fan = 64 // unit_bits, 1 << unit_bits
    uq = q.astype(np.uint64)
    qfp = fp_partial(q)
    node = np.zeros(q.size, np.int64)
    active = np.ones(q.size, bool)
    inner, entries, leaves, matched = [], [], [], []
    steps = 0
    for _ in range(n_units + 1):
        idx = np.nonzero(active)[0]
        steps += idx.size
        at = node[idx]
        leaf = is_leaf[at]
        leaves.append(at[leaf])
        matched.append(at[leaf & (lfp[at] == qfp[idx])])
        active[idx[leaf]] = False
        idx, at = idx[~leaf], at[~leaf]
        inner.append(at)
        lvl = np.clip(level[at], 0, n_units - 1).astype(np.uint64)
        shift = np.uint64(unit_bits) * (np.uint64(n_units - 1) - lvl)
        unit = ((uq[idx] >> shift) & np.uint64(fan - 1)).astype(np.int64)
        entries.append(at * fan + unit)
        child = children[at, unit].astype(np.int64)
        stop = child < 0
        active[idx[stop]] = False
        node[idx[~stop]] = child[~stop]
    uniq = [np.unique(np.concatenate(a)).size
            for a in (inner, entries, leaves, matched)]
    n_bytes = (q.size * 8 + uniq[0] * 5 + uniq[1] * 4 + uniq[2] * 2
               + uniq[3] * 16 + q.size * (1 + 8 + 12))
    return bound(n_bytes, steps * 12 + q.size * 10)


def radix_vs_plain(sessions, seed: int, launches: dict) -> list:
    """art_descend at 8-bit (P-ART) and 4-bit (P-HOT) units; the row
    carries the P-ART numbers, the main path's shape."""
    rows = []
    err = 0
    for tag, session in sessions:
        snap = session.index.snapshot()
        check("art_probe" in snap.cache, f"the {tag} path left no node "
              "pages on the card")
        unit_bits, *pages = snap.cache["art_probe"]
        n_bytes = sum(t.numel() * t.element_size() for t in pages)
        say(f"{tag} node pages: {pages[0].shape[0]} rows, {unit_bits}-bit "
            f"units, {n_bytes} bytes on {pages[0].device}")
        rng = np.random.default_rng(seed + 3)
        q = radix_queries(snap.arrays, Q, rng)
        qt = torch.from_numpy(q).to(pages[0].device)
        got = kart.art_descend(qt, *pages, unit_bits=unit_bits)
        torch.cuda.synchronize()
        plain = kart.descend_plain(qt, *pages, unit_bits=unit_bits)
        err = max(err, compare(f"art_descend ({tag})", got, plain))
        found = int(got[0].sum())
        check(found >= Q // 2 - 64, f"art_descend ({tag}): drawn hits were "
              "not found")
        check(int(got[4].sum()) > 0, f"art_descend ({tag}): no fingerprint "
              "false positive reached the full compare")
        say(f"art_descend ({tag}): bit-identical to its plain version on "
            f"{Q} queries ({found} found)")
        leaves = snap.arrays["leaf_key"][
            np.asarray(snap.arrays["is_leaf"]) != 0]
        timing = [(torch.from_numpy(np.concatenate([
            rng.choice(leaves, Q // 2),
            rng.integers(1, 1 << 62, Q // 2)])).to(qt.device),)
            for _ in range(64)]
        timed = time_kernel(
            f"art_descend ({tag})",
            lambda a: kart.art_descend(a, *pages, unit_bits=unit_bits),
            lambda a: kart.descend_plain(a, *pages, unit_bits=unit_bits),
            timing)
        bms, by = radix_bound(snap.arrays, q)
        say(f"art_descend ({tag}): bound {bms:.9f} ms ({by}) at Q={Q}")
        rows.append((tag, timed, bms, by, unit_bits, pages[0].shape[0]))
    tag, timed, bms, by, unit_bits, n_rows = rows[0]
    say(f"art_descend: main-path launches {launches['art_descend']}")
    return [row("art_descend", launches, err, timed, bms, by, None,
                f"{tag}, Q={Q}, {unit_bits}-bit units, {n_rows} rows")]


def scan_bound(keys: np.ndarray, q: np.ndarray, counts: np.ndarray,
               width: int, base=None, length=None):
    """Least time for one search launch over this batch: the keys the
    lower-bound halvings visit, the window entries that are valid
    (key and value), the queries and counts (and with a shard axis each
    row's base and length), and the [Q, C] outputs."""
    n = keys.size
    rows = base is not None
    lo = base.copy() if rows else np.zeros(q.size, np.int64)
    hi = base + length if rows else np.full(q.size, n, np.int64)
    end = hi.copy()
    visited = []
    steps = 0
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) // 2
        visited.append(mid[act])
        steps += int(act.sum())
        less = keys[np.minimum(mid, n - 1)] < q
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    off = np.arange(width)
    pos = lo[:, None] + off
    ok = (off < counts[:, None]) & (pos < end[:, None])
    n_window = np.unique(pos[ok]).size
    n_bytes = (q.size * (28 if rows else 12)
               + np.unique(np.concatenate(visited)).size * 8
               + n_window * 16 + q.size * width * 17)
    return bound(n_bytes, steps * 6 + q.size * width * 3)


def scan_vs_plain(session, seed: int, launches: dict) -> list:
    """scan_window at windows of 1 (lookups) and 128 (YCSB-E scans) on
    the P-Masstree run; the row carries the scan numbers, and
    ``torch.searchsorted`` is timed as the library call for the lower
    bound."""
    snap = session.index.snapshot()
    keys_np = np.asarray(snap.arrays["keys"], np.int64)
    vals_np = np.asarray(snap.arrays["vals"], np.int64)
    dev = session.device
    keys, vals = kscan.prepare_sorted(keys_np, vals_np, device=dev)
    say(f"P-Masstree run: {keys_np.size} entries, "
        f"{2 * keys.numel() * keys.element_size()} bytes on {dev}")
    rng = np.random.default_rng(seed + 4)
    q = np.concatenate([rng.choice(keys_np, Q // 2),
                        rng.choice(keys_np, Q // 4) + 1,
                        rng.integers(1, 1 << 62, size=Q // 4 - 4),
                        [0, HIGH, -1, keys_np[-1] + 1]]).astype(np.int64)
    rng.shuffle(q)
    qt = torch.from_numpy(q).to(dev)
    timing_q = [torch.from_numpy(np.concatenate([
        rng.choice(keys_np, Q // 2),
        rng.integers(1, 1 << 62, size=Q // 2)])).to(dev) for _ in range(64)]
    out = {}
    err = 0
    for width in (1, 128):
        counts = (np.ones(Q, np.int32) if width == 1 else
                  rng.integers(1, 101, size=Q).astype(np.int32))
        counts[::97] = 0
        ct = torch.from_numpy(counts).to(dev)
        got = kscan.scan_window(qt, ct, keys, vals, max_count=width)
        torch.cuda.synchronize()
        plain = kscan.scan_window_plain(qt, ct, keys, vals, max_count=width)
        err = max(err, compare(f"scan_window (C={width})", got, plain))
        neg = int(np.nonzero(q == HIGH)[0][0])
        check(int(got[1][neg, 0]) == (int(keys_np[0]) if counts[neg] else 0),
              "scan_window: a start of 2^63 did not get lower bound 0")
        say(f"scan_window (C={width}): bit-identical to its plain version "
            f"on {Q} queries ({int(got[0].sum())} valid lanes)")
        timing = [(t, torch.from_numpy(
            rng.integers(1, 101, size=Q).astype(np.int32)
            if width > 1 else np.ones(Q, np.int32)).to(dev))
            for t in timing_q]
        timed = time_kernel(
            f"scan_window (C={width})",
            lambda a, c: kscan.scan_window(a, c, keys, vals,
                                           max_count=width),
            lambda a, c: kscan.scan_window_plain(a, c, keys, vals,
                                                 max_count=width), timing)
        bms, by = scan_bound(keys_np, q, counts, width)
        say(f"scan_window (C={width}): bound {bms:.9f} ms ({by}) at Q={Q}")
        out[width] = (timed, bms, by)
    lib_dev, lib_call = time_calls(
        lambda a, c: torch.searchsorted(keys, a), timing, 640)
    library_ms = lib_dev if lib_dev is not None else lib_call
    say(f"torch.searchsorted (the lower bound alone): device {lib_dev} ms, "
        f"call {lib_call:.6f} ms; main-path launches "
        f"{launches['scan_window']}")
    timed, bms, by = out[128]
    return [row("scan_window", launches, err, timed, bms, by, library_ms,
                f"P-Masstree, Q={Q}, C=128, n={keys_np.size}")]


def mesh_queries(stacked, c_keys: np.ndarray, n: int, rng) -> tuple:
    """A mesh plan's queries (loaded keys, misses, key 0 and keys of
    2^63 and above), each row's shard by the path's hash route, and its
    run's base and length in the stacked runs."""
    edge = np.array([0, HIGH, -1, (1 << 63) - 1], np.int64)
    q = np.concatenate([rng.choice(c_keys, n // 2),
                        rng.integers(1, 1 << 62, size=n - n // 2 - 4),
                        edge])
    rng.shuffle(q)
    shard = kpart.route_ref(q, SHARDS, "hash")
    base = stacked.offsets[:-1][shard]
    return q, shard, base, stacked.n[shard]


def sharded_scan_vs_plain(scale, seed: int, launches: dict) -> list:
    """scan_window with the shard axis on the stacked runs the P-CLHT x8
    mesh path searched, at windows of 1 (the mesh lookups) and 128;
    ``torch.searchsorted`` over the runs as a 2-D [S, N] array (padded
    to the longest run) is timed as the library call for the lower
    bound."""
    idx = scale["session"].index
    check(idx._mesh_cache is not None, "the mesh path left no stacked "
          "runs on the card")
    stacked = idx._mesh_cache[1]
    dev = stacked.keys.device
    keys_np = stacked.keys.cpu().numpy()
    say(f"P-CLHT x{SHARDS} stacked runs: {keys_np.size} entries, runs of "
        f"{int(stacked.n.min())}-{int(stacked.n.max())}, "
        f"{2 * stacked.keys.numel() * 8} bytes on {dev}")
    rng = np.random.default_rng(seed + 5)
    q, shard, base, length = mesh_queries(stacked, scale["c_keys"], Q, rng)

    def on_card(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    err = 0
    out = {}
    for width in (1, 128):
        counts = (np.ones(Q, np.int32) if width == 1 else
                  rng.integers(1, 101, size=Q).astype(np.int32))
        qt, ct, bt, lt = on_card(q, counts, base, length)
        got = kscan.scan_window_rows(qt, ct, bt, lt, stacked.keys,
                                     stacked.vals, max_count=width)
        torch.cuda.synchronize()
        plain = kscan.scan_window_rows_plain(qt, ct, bt, lt, stacked.keys,
                                             stacked.vals, max_count=width)
        err = max(err, compare(f"scan_window_sharded (C={width})", got,
                               plain))
        found = int((got[0][:, 0] & (got[1][:, 0] == qt)).sum())
        check(found >= Q // 2, "scan_window_sharded: drawn hits were not "
              "found")
        say(f"scan_window_sharded (C={width}): bit-identical to its plain "
            f"version on {Q} queries over {SHARDS} runs ({found} found)")
        if width == 1:
            timing = []
            for _ in range(64):
                tq, _, tb, tl = mesh_queries(stacked, scale["c_keys"], Q,
                                             rng)
                timing.append(on_card(tq, counts, tb, tl))
            timed = time_kernel(
                "scan_window_sharded (C=1)",
                lambda a, c, b, n: kscan.scan_window_rows(
                    a, c, b, n, stacked.keys, stacked.vals, max_count=1),
                lambda a, c, b, n: kscan.scan_window_rows_plain(
                    a, c, b, n, stacked.keys, stacked.vals, max_count=1),
                timing)
            out = (timed, *scan_bound(keys_np, q, counts, 1, base, length))
    n_max = int(stacked.n.max())
    runs2d = torch.full((SHARDS, n_max), (1 << 63) - 1, dtype=torch.int64,
                        device=dev)
    for s in range(SHARDS):
        lo, hi = stacked.offsets[s], stacked.offsets[s + 1]
        runs2d[s, :hi - lo] = stacked.keys[lo:hi]
    lib_batches = []
    for tq, _, tb, _ in timing:
        rows = torch.from_numpy(kpart.route_ref(tq.cpu().numpy(), SHARDS,
                                                "hash")).to(dev)
        width = int(torch.bincount(rows, minlength=SHARDS).max())
        grid = torch.full((SHARDS, width), 0, dtype=torch.int64, device=dev)
        order = torch.argsort(rows, stable=True)
        slot = torch.arange(Q, device=dev) - torch.searchsorted(
            rows[order], rows[order])
        grid[rows[order], slot] = tq[order]
        lib_batches.append((grid,))
    lib_dev, lib_call = time_calls(
        lambda g: torch.searchsorted(runs2d, g), lib_batches, 640)
    library_ms = lib_dev if lib_dev is not None else lib_call
    timed, bms, by = out
    say(f"scan_window_sharded (C=1): bound {bms:.9f} ms ({by}) at Q={Q}; "
        f"torch.searchsorted over [{SHARDS}, {n_max}] runs: device "
        f"{lib_dev} ms, call {lib_call:.6f} ms; main-path launches "
        f"{launches['scan_window_sharded']}")
    return [row("scan_window_sharded", launches, err, timed, bms, by,
                library_ms, f"P-CLHT x{SHARDS} mesh, Q={Q}, C=1, "
                f"{keys_np.size} entries in {SHARDS} runs")]


def route_vs_plain(scale, launches: dict) -> list:
    """shard_route against its plain version and the numpy oracle on a
    plan's keys plus key 0 and keys of 2^63 and above: hash, prefix and
    prefix@58, 1 to 32 shards; timed at the path's shape (8 shards,
    hash) on the keys of 16 YCSB-C plans."""
    dev = scale["session"].device
    c_keys = scale["c_keys"]
    edge = np.array([0, 1, HIGH, -1, (1 << 63) - 1], np.int64)
    q = np.concatenate([c_keys[:Q - edge.size], edge])
    qt = torch.from_numpy(q).to(dev)
    err = 0
    for scheme in ("hash", "prefix", "prefix@58"):
        for bits in range(6):
            b, shift = kpart.route_params(1 << bits, scheme)
            got = kpart.shard_route(qt, bits=b, shift=shift)
            torch.cuda.synchronize()
            plain = kpart.shard_route_plain(qt, bits=b, shift=shift)
            err = max(err, compare("shard_route", [got], [plain]))
            check(np.array_equal(got.cpu().numpy(), kpart.route_ref(
                q, 1 << bits, scheme)), "shard_route: differs from the "
                "numpy oracle")
    say(f"shard_route: bit-identical to its plain version and to the numpy "
        f"oracle on {Q} keys, hash, prefix and prefix@58, 1-32 shards")
    b, shift = kpart.route_params(SHARDS, "hash")
    timing = [(torch.from_numpy(c_keys[i * Q:(i + 1) * Q]).to(dev),)
              for i in range(max(1, min(16, c_keys.size // Q)))]
    timed = time_kernel(
        "shard_route", lambda k: kpart.shard_route(k, bits=b, shift=shift),
        lambda k: kpart.shard_route_plain(k, bits=b, shift=shift), timing)
    # each key read once (8 bytes), each id written once (4); splitmix64
    # and the shift are about 16 integer operations a key
    bms, by = bound(Q * 12, Q * 16)
    say(f"shard_route: bound {bms:.9f} ms ({by}) at Q={Q}; main-path "
        f"launches {launches['shard_route']}")
    return [row("shard_route", launches, err, timed, bms, by, None,
                f"P-CLHT x{SHARDS}, Q={Q}, hash, {b} bits")]


def conflict_vs_plain(scale, launches: dict) -> list:
    """conflict_any against its plain version and the numpy oracle on
    the admission checks the stream phase made (the largest reference
    set last), writes_conflict both ways, for reference sets of 1 up
    to the largest; timed on the checks of the largest reference set."""
    dev = scale["session"].device
    checks = scale["checks"]

    def on_card(ka, xa, kb, xb):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (ka.astype(np.int32), xa,
                               kb.astype(np.int32), xb))

    ka, xa, kb, xb = checks[-1]
    b_max = kb.size
    err = 0
    for wc in (False, True):
        for nb in sorted({1, 7, 64, PLAN_OPS, b_max} & set(
                range(1, b_max + 1))):
            t = on_card(ka, xa, kb[:nb], xb[:nb])
            got = kconf.kernel.conflict_any(*t, writes_conflict=wc)
            torch.cuda.synchronize()
            plain = kconf.conflict_any_plain(*t, writes_conflict=wc)
            err = max(err, compare("conflict_any", [got], [plain]))
            check(np.array_equal(got.cpu().numpy(), kconf.conflict_any_ref(
                ka, xa, kb[:nb], xb[:nb], writes_conflict=wc)),
                "conflict_any: differs from the numpy oracle")
    n_conf = 0
    for c in checks:  # every admission check of the path, as it ran
        t = on_card(*c)
        got = kconf.kernel.conflict_any(*t, writes_conflict=True)
        torch.cuda.synchronize()
        err = max(err, compare("conflict_any", [got], [
            kconf.conflict_any_plain(*t, writes_conflict=True)]))
        n_conf += int(got.sum())
    check(n_conf > 0, "conflict_any: no admission check found a conflict")
    say(f"conflict_any: bit-identical to its plain version and to the "
        f"numpy oracle, A={ka.size}, B=1..{b_max}, writes_conflict both "
        f"ways; and on all {len(checks)} admission checks of the path "
        f"({n_conf} conflicting candidates)")
    timing = [on_card(*c) for c in checks if c[2].size == b_max]
    timed = time_kernel(
        "conflict_any",
        lambda *t: kconf.kernel.conflict_any(*t, writes_conflict=True),
        lambda *t: kconf.conflict_any_plain(*t, writes_conflict=True),
        timing, reps=320)
    # the pair tests this check needs: each candidate up to its first
    # conflict, or all of B; about 12 integer operations a pair
    conf = kconf.conflict_matrix_ref(ka, xa, kb, xb, writes_conflict=True)
    pairs = int(np.where(conf.any(axis=1), conf.argmax(axis=1) + 1,
                         b_max).sum())
    bms, by = bound((ka.size + b_max) * 12 + ka.size, pairs * 12)
    say(f"conflict_any: bound {bms:.9f} ms ({by}) at A={ka.size}, "
        f"B={b_max} ({pairs} pair tests, {int(conf.any(axis=1).sum())} "
        f"candidates conflict); main-path launches "
        f"{launches['conflict_any']}")
    return [row("conflict_any", launches, err, timed, bms, by, None,
                f"{STREAMS}-stream tick, A={ka.size}, B={b_max}")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-clht", type=int, default=1 << 20)
    ap.add_argument("--n-art", type=int, default=1 << 20)
    ap.add_argument("--n-hot", type=int, default=1 << 18)
    ap.add_argument("--n-masstree", type=int, default=1 << 18)
    ap.add_argument("--n-bwtree", type=int, default=1 << 15)
    # one CCEH directory and one Level hashing level must each fit an
    # arena segment (65,528 words): a 2^16-key CCEH load and a
    # 20,480-key Level hashing load overflow it
    ap.add_argument("--n-cceh", type=int, default=1 << 15)
    ap.add_argument("--n-fastfair", type=int, default=1 << 16)
    ap.add_argument("--n-level", type=int, default=1 << 14)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    check(torch.cuda.is_available(), "no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = build.build()
    say(f"build: {sorted(built)} in {time.perf_counter() - t0:.3f} s")
    check(set(built) >= {"probe", "art_descend", "scan_window",
                         "shard_route", "conflict_any"},
          "a kernel source was not built")
    for name, b in built.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    paths = [
        ("P-CLHT", "clht", ("probe64_fp", "probe64"),
         lambda s: point_path(s, args.n_clht, args.seed, "P-CLHT",
                              edge_keys=False)),
        ("P-ART", "art", ("art_descend",),
         lambda s: point_path(s, args.n_art, args.seed, "P-ART",
                              edge_keys=True)),
        ("P-HOT", "hot", ("art_descend",),
         lambda s: point_path(s, args.n_hot, args.seed, "P-HOT",
                              edge_keys=True)),
        ("P-Masstree", "masstree", ("scan_window",),
         lambda s: sorted_path(s, args.n_masstree, args.seed, "P-Masstree",
                               n_e0=4 * PLAN_OPS, n_e=2 * PLAN_OPS)),
        ("P-BwTree", "bwtree", ("scan_window",),
         lambda s: sorted_path(s, args.n_bwtree, args.seed, "P-BwTree",
                               n_e0=2 * PLAN_OPS, n_e=0)),
    ]
    sessions = {}
    launches = {name: 0 for name in SOURCES}
    for tag, kind, kernels, drive in paths:
        session = sessions[tag] = open_index(kind)
        check(session.device.type == "cuda", f"the {tag} session is not on "
              "the card")
        reset_counts()
        t0 = time.perf_counter()
        drive(session)
        counts = read_counts()
        say(f"{tag} path: {time.perf_counter() - t0:.3f} s; kernel launches "
            f"{counts}")
        for name in kernels:
            check(counts[name] > 0, f"{name} was not launched on the {tag} "
                  "path")
        for name in launches:
            launches[name] += counts[name]

    reset_counts()
    t0 = time.perf_counter()
    scale = scale_out_path(sessions, args)
    counts = read_counts()
    say(f"scale-out path: {time.perf_counter() - t0:.3f} s; kernel "
        f"launches {counts}")
    for name in ("shard_route", "conflict_any", "scan_window_sharded",
                 "probe64_fp", "scan_window"):
        check(counts[name] > 0, f"{name} was not launched on the scale-out "
              "path")
    for name in launches:
        launches[name] += counts[name]

    rows = probe_vs_plain(sessions["P-CLHT"].index, args.seed, launches)
    rows += radix_vs_plain([("P-ART", sessions["P-ART"]),
                            ("P-HOT", sessions["P-HOT"])], args.seed,
                           launches)
    rows += scan_vs_plain(sessions["P-Masstree"], args.seed, launches)
    rows += sharded_scan_vs_plain(scale, args.seed, launches)
    rows += route_vs_plain(scale, launches)
    rows += conflict_vs_plain(scale, launches)
    check([r["name"] for r in rows] == list(SOURCES), "a kernel is missing "
          "from the kernels line")
    say(f"whole run: {time.perf_counter() - t_start:.3f} s")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
