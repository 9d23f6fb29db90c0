#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--n-load 1048576] [--seed 0]

The main path is a YCSB workload of operation plans against P-CLHT
through ``repro_torch.api.open_index("clht")``, whose read waves run the
chained probe kernel (``src/repro_torch/csrc/probe.cu``).  Phases, each
of which exits non-zero on failure:

1. card check: a CUDA device, its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, compiled in parallel;
3. main path, with every kernel's launch count set to 0 just before and
   read just after: YCSB Load A of ``--n-load`` keys in 4096-op plans,
   a powerfail crash after which every loaded key reads back, YCSB-C
   (every lookup found with ``value_of(key)``), YCSB-A (acked writes and
   found reads as the mix implies), YCSB-C plans with fingerprints off,
   and 4096 sampled keys through the kernel path against scalar lookups;
4. each kernel against its plain PyTorch version on the card, on
   4096 queries made from ``--seed`` over the loaded table (hits,
   misses, fingerprint near-misses, values of 2^32 and above, key 0):
   outputs must be bit-identical; then per-launch times at that shape
   (device time from the profiler, call time from CUDA events), beside
   the plain version's and the least time the card could take
   (``bound_ms``).

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
from repro_torch.core.ycsb import PhaseExecutor, generate  # noqa: E402
from repro_torch.kernels import probe as kprobe  # noqa: E402
from repro_torch.kernels.clht_probe import mix64  # noqa: E402
from repro_torch.kernels.probe import fp64  # noqa: E402

PLAN_OPS = 4096
Q = 4096  # queries per probe launch on the main path (one full read wave)
SLOTS = 3
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the float32 rate
# outside the tensor cores standing in for 32-bit integer lanes
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12
SOURCE = "src/repro_torch/csrc/probe.cu"
REPLACES = {"probe64_fp": "src/repro/kernels/probe/kernel.py:76",
            "probe64": "src/repro/kernels/probe/kernel.py:108"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def say(msg: str) -> None:
    print(msg, flush=True)


def value_of(keys: np.ndarray) -> np.ndarray:
    """Vectorized ``core.ycsb.value_of``."""
    return (keys ^ 0x5DEECE66D) & ((1 << 62) - 1) | 1


def get_plan(keys: np.ndarray) -> Plan:
    n = keys.shape[0]
    return Plan.from_arrays(np.zeros(n, np.int32), keys, np.zeros(n, np.int64))


def read_back(session, keys: np.ndarray, what: str) -> None:
    """Every key must read back through plans with ``value_of(key)``."""
    for lo in range(0, keys.shape[0], PLAN_OPS):
        chunk = keys[lo:lo + PLAN_OPS]
        res = session.execute(get_plan(chunk)).results
        check(None not in res, f"{what}: a key did not read back")
        check(np.array_equal(np.asarray(res, np.int64), value_of(chunk)),
              f"{what}: a value differs from value_of(key)")


def timed_run(index, ops) -> tuple:
    ex = PhaseExecutor(index, batch_lookups=True, max_batch=PLAN_OPS)
    t0 = time.perf_counter()
    done = ex.run(ops)
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0


def main_path(session, n_load: int, seed: int) -> None:
    index = session.index
    n_a = max(n_load // 4, PLAN_OPS)
    load = generate("C", n_load, n_load, seed=seed)
    loaded = np.fromiter((k for _, k, _ in load.load_ops), np.int64)
    done, secs = timed_run(index, load.load_ops)
    check(done["acked"] == len(load.load_ops), "Load A: an insert was not "
          "acknowledged")
    say(f"load: {len(load.load_ops)} keys in {secs:.3f} s "
        f"({len(load.load_ops) / secs / 1e3:.3f} kops/s)")
    session.crash()
    read_back(session, loaded, "after powerfail")
    say(f"crash: powerfail after the load; all {loaded.size} acked keys "
        "read back")

    done, secs = timed_run(index, load.run_ops)
    check(done["found"] == len(load.run_ops), "YCSB-C: a lookup missed")
    say(f"YCSB-C: {len(load.run_ops)} ops in {secs:.3f} s "
        f"({len(load.run_ops) / secs / 1e3:.3f} kops/s), all found")
    run_keys = np.fromiter((k for _, k, _ in load.run_ops), np.int64)
    read_back(session, run_keys, "YCSB-C")
    say("YCSB-C: every value equals value_of(key)")

    mix_a = generate("A", n_load, n_a, seed=seed)
    done, secs = timed_run(index, mix_a.run_ops)
    check(done["acked"] == done["insert"], "YCSB-A: an insert of a fresh "
          "key was not acknowledged")
    check(done["found"] == done["lookup"], "YCSB-A: a lookup of a loaded "
          "key missed")
    say(f"YCSB-A: {len(mix_a.run_ops)} ops in {secs:.3f} s "
        f"({len(mix_a.run_ops) / secs / 1e3:.3f} kops/s), "
        f"{done['acked']} acked of {done['insert']} inserts, "
        f"{done['found']} found of {done['lookup']} lookups")

    index.fingerprints = False
    c_off = load.run_ops[:8 * PLAN_OPS]
    done, secs = timed_run(index, c_off)
    index.fingerprints = True
    check(done["found"] == len(c_off), "YCSB-C, fingerprints off: a lookup "
          "missed")
    say(f"YCSB-C, fingerprints off: {len(c_off)} ops in {secs:.3f} s "
        f"({len(c_off) / secs / 1e3:.3f} kops/s), all found")

    rng = np.random.default_rng(seed + 1)
    inserted = np.fromiter((k for kind, k, _ in mix_a.run_ops
                            if kind == "insert"), np.int64)
    sample = np.concatenate([
        rng.choice(loaded, PLAN_OPS // 2),
        rng.choice(inserted, PLAN_OPS // 4),
        rng.integers(1, 1 << 62, size=PLAN_OPS // 4)])
    res = session.execute(get_plan(sample), force_kernel=True).results
    check(res == [index.lookup(int(k)) for k in sample],
          "sampled keys: the kernel path differs from scalar lookup")
    say(f"sample: {sample.size} keys through the kernel path equal scalar "
        "lookup")


def table_on_device(index):
    """The table the main path's last read wave probed: (keys, vals,
    fps, nxt) on the card, the longest chain, the bucket count, and
    the host export it was uploaded from."""
    snap = index.snapshot()
    check("clht_probe" in snap.cache, "the main path left no table on "
          "the card")
    return snap.cache["clht_probe"], snap.arrays


def make_queries(arrays, depth: int, n: int, rng) -> np.ndarray:
    """Hits, misses, fingerprint near-misses (a fresh key whose
    fingerprint equals a slot's in its own chain), values of 2^32 and
    above, and key 0."""
    keys, _, nxt, n_buckets, fps = arrays
    resident = keys[keys != 0]
    hits = rng.choice(resident, n // 2)
    misses = rng.integers(1, 1 << 62, size=n // 4)
    pool = rng.integers(1, 1 << 62, size=1 << 21)
    pool = pool[~np.isin(pool, resident)]
    row = (mix64(pool) % np.uint64(n_buckets)).astype(np.int64)
    pfp = fp64(pool)
    near = np.zeros(pool.size, bool)
    for _ in range(depth):
        live = row >= 0
        safe = np.where(live, row, 0)
        near |= live & (fps[safe] == pfp[:, None]).any(axis=1)
        row = np.where(live, nxt[safe], -1)
    n_near = n - hits.size - misses.size - 4
    check(int(near.sum()) >= n_near, "too few fingerprint near-misses")
    q = np.concatenate([hits, misses, pool[near][:n_near],
                        np.zeros(4, np.int64)])
    rng.shuffle(q)
    return q


def bound_ms(arrays, depth: int, q: np.ndarray, use_fp: bool):
    """Least time for one launch: the bytes this batch's data needs
    (each input byte read once, each output written once) over HBM
    bandwidth, against its lane operations over the lane rate."""
    keys, vals, nxt, n_buckets, fps = arrays
    row = (mix64(q) % np.uint64(n_buckets)).astype(np.int64)
    qfp = fp64(q)
    rows, cand, found = set(), set(), set()
    n_cand = 0
    got = np.zeros(q.size, bool)
    for _ in range(depth):
        live = row >= 0
        safe = np.where(live, row, 0)
        rows.update(row[live].tolist())
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
        row = np.where(live, nxt[safe], -1)
    per_row = (SLOTS + 8) if use_fp else (SLOTS * 8 + 8)
    n_bytes = (q.size * 16 + len(rows) * per_row
               + (len(cand) * 8 if use_fp else 0) + len(found) * 8
               + q.size * (1 + 8 + (8 if use_fp else 0)))
    lanes = q.size * depth * SLOTS
    ops = q.size * 30 + lanes + 2 * n_cand
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / LANE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_calls(fn, batches, reps: int):
    """(device ms, call ms) per call, cycling through ``batches`` so
    most probed rows are not in L2 (the main path's plans probe
    different keys each time).  Call ms: CUDA events around ``reps``
    back-to-back calls, host launch cost included.  Device ms: the
    summed duration of the CUDA kernels the profiler records over
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


def kernels_vs_plain(index, seed: int, launches: dict) -> list:
    (table, depth, n), arrays = table_on_device(index)
    dev = table[0].device
    keys, vals, fps, nxt = table
    n_rows = keys.shape[0]
    n_bytes = sum(t.numel() * t.element_size() for t in table)
    say(f"table: {n_rows} rows, {n} buckets, longest chain {depth}, "
        f"{n_bytes} bytes on {dev}")
    rng = np.random.default_rng(seed + 2)
    q = make_queries(arrays, depth, Q, rng)

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
        err = 0
        for g, p in zip(got, plain):
            if p is None:
                continue
            check(torch.equal(g, p), f"{name}: kernel differs from its "
                  "plain version")
            err = max(err, int((g.to(torch.int64) - p.to(torch.int64))
                               .abs().max()))
        found = got[0].cpu().numpy()
        vals_out = got[1].cpu().numpy()
        check(found.sum() >= Q // 2, f"{name}: drawn hits were not found")
        check((vals_out[found] >= 1 << 32).any(), f"{name}: no value of "
              "2^32 or above")
        if use_fp:
            check(int(got[3].sum()) > 0, "probe64_fp: no fingerprint "
                  "false positive reached the full compare")
        say(f"{name}: bit-identical to its plain version on {Q} queries "
            f"({int(found.sum())} found)")
        dev_ms, call_ms = time_calls(lambda a, b: kprobe.probe_chain(
            a, b, keys, vals, fps, nxt, depth, use_fp=use_fp), timing, 640)
        plain_dev, plain_call = time_calls(
            lambda a, b: kprobe.probe_chain_plain(
                a, b, keys, vals, fps, nxt, depth, use_fp=use_fp),
            timing, 64)
        # the card's time where the profiler saw the kernels, else the
        # event time per call (which then includes the host's launch cost)
        ms = dev_ms if dev_ms is not None else call_ms
        plain_ms = plain_dev if plain_dev is not None else plain_call
        bms, by = bound_ms(arrays, depth, q, use_fp)
        say(f"{name}: device {dev_ms} ms, call {call_ms:.6f} ms per launch "
            f"at Q={Q}, depth {depth}; plain: device {plain_dev} ms, call "
            f"{plain_call:.6f} ms; bound {bms:.9f} ms ({by}); main-path "
            f"launches {launches[name]}")
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name],
                     "launches": launches[name], "max_abs_err": float(err),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": None})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-load", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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
    for name, b in built.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    session = open_index("clht")
    check(session.device.type == "cuda", "the session is not on the card")
    kprobe.reset_launches()
    t0 = time.perf_counter()
    main_path(session, args.n_load, args.seed)
    launches = dict(kprobe.LAUNCHES)
    say(f"main path: {time.perf_counter() - t0:.3f} s; kernel launches "
        f"{launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    rows = kernels_vs_plain(session.index, args.seed, launches)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
