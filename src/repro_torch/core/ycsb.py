"""YCSB workload generator (paper §7, Table 3).

Generates the workload mixes the paper evaluates: Load A (100%
insert), A (50/50 read/write), B (95/5), C (100% read), E (95/5
scan/insert) — plus D (95/5 read-latest/insert) and F (50/50
read/read-modify-write), which the paper excluded because several of
its indexes lacked updates; our conversions add native update commits
(value-word / CoW-leaf / delta stores), so both join the mix.  Keys
are uniformly distributed 8-byte random integers ("randint").

Ported from ``repro.core.ycsb``: ``generate`` draws the same numpy RNG
streams, so a seed gives the reference's op lists exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Tuple

import numpy as np

Op = Tuple[str, int, int]

WORKLOADS = {
    "LoadA": dict(reads=0.0, inserts=1.0, scans=0.0),
    "A": dict(reads=0.5, inserts=0.5, scans=0.0),
    "B": dict(reads=0.95, inserts=0.05, scans=0.0),
    "C": dict(reads=1.0, inserts=0.0, scans=0.0),
    # D reads the latest inserts (the standard YCSB-D skew)
    "D": dict(reads=0.95, inserts=0.05, scans=0.0, latest=True),
    "E": dict(reads=0.0, inserts=0.05, scans=0.95),
    # E0 is to E what C is to B: the pure-scan variant that isolates the
    # steady-state batched scan path (no epoch churn from inserts)
    "E0": dict(reads=0.0, inserts=0.0, scans=1.0),
    # F is read-modify-write over existing keys (native update commits)
    "F": dict(reads=0.5, updates=0.5, scans=0.0),
}

SCAN_MAX = 100  # YCSB-E scans up to 100 records


@dataclasses.dataclass
class Workload:
    name: str
    load_ops: List[Op]  # the Load A phase that populates the index
    run_ops: List[Op]  # the measured phase
    scan_lengths: List[int]
    # generator knobs (distribution, theta, keyspace, ...), so
    # benchmark rows can label themselves from the workload alone
    meta: dict = dataclasses.field(default_factory=dict)


def value_of(key: int) -> int:
    return (key ^ 0x5DEECE66D) & ((1 << 62) - 1) | 1


def update_value(key: int, gen: int) -> int:
    """The value YCSB-F writes back on its ``gen``-th op: usually a
    genuinely changed value (a real update commit); when ``gen`` wraps
    to the original it exercises the no-op-update elision."""
    return value_of(key) ^ ((gen % 4096) << 1)


def generate(name: str, n_load: int, n_run: int, *, seed: int = 0,
             key_space_bits: int = 60) -> Workload:
    mix = WORKLOADS[name]
    rng = np.random.default_rng(seed)
    load_keys = np.unique(rng.integers(1, 1 << key_space_bits, size=n_load))
    rng.shuffle(load_keys)
    load_ops: List[Op] = [("insert", int(k), value_of(int(k)))
                          for k in load_keys]
    run_ops: List[Op] = []
    scan_lengths: List[int] = []
    existing = load_keys
    recent = [int(k) for k in load_keys]  # insertion order, for D's reads
    fresh = iter(np.unique(rng.integers(1 << key_space_bits,
                                        1 << (key_space_bits + 1),
                                        size=max(n_run, 1))))
    reads = mix.get("reads", 0.0)
    inserts = mix.get("inserts", 0.0)
    updates = mix.get("updates", 0.0)
    latest = bool(mix.get("latest", False))
    r = rng.random(n_run)
    targets = rng.integers(0, max(len(existing), 1), size=n_run)
    for i in range(n_run):
        if r[i] < reads:
            if latest:
                # YCSB-D: reads target the most recent tenth of inserts
                window = max(1, len(recent) // 10)
                k = recent[len(recent) - 1 - (int(targets[i]) % window)]
            else:
                k = int(existing[targets[i] % len(existing)])
            run_ops.append(("lookup", k, 0))
        elif r[i] < reads + inserts:
            k = int(next(fresh))
            run_ops.append(("insert", k, value_of(k)))
            recent.append(k)
        elif r[i] < reads + inserts + updates:
            k = int(existing[targets[i] % len(existing)])
            run_ops.append(("update", k, update_value(k, i)))
        else:
            k = int(existing[targets[i] % len(existing)])
            n = int(rng.integers(1, SCAN_MAX + 1))
            run_ops.append(("scan", k, n))
            scan_lengths.append(n)
    return Workload(name=name, load_ops=load_ops, run_ops=run_ops,
                    scan_lengths=scan_lengths)


class PhaseExecutor:
    """Executes a workload phase against an index.

    The batched mode is **plan construction**: the op stream is
    converted to parallel kind/key/aux arrays with no per-op branching,
    chunked into operation plans of ``max_batch`` ops, and each plan
    runs through ``index.execute`` — the conflict-wave scheduler
    preserves per-key program order while letting everything else batch
    across the read/write boundary, so the mixed YCSB mixes (A/B/D/F)
    run fully batched instead of flushing on the first key collision.
    Op results, found counts, and scanned-record counts match the
    scalar execution (``batch_lookups=False``) exactly.  The JAX
    package's ``buffered=True`` baseline engine is not ported.

    Scans execute as "first ``aux`` live records from ``key``"
    (``index.scan``) — real YCSB-E semantics, identical on the scalar
    and batched paths.
    """

    def __init__(self, index, *, batch_lookups: bool = False,
                 max_batch: int = 4096, lat_hist=None):
        self.index = index
        self.batch_lookups = batch_lookups
        self.max_batch = max_batch
        self.lat_hist = lat_hist  # optional obs.Histogram of per-op ns
        self.done = {"insert": 0, "update": 0, "delete": 0, "lookup": 0,
                     "scan": 0, "found": 0, "scanned": 0, "acked": 0,
                     "batches": 0, "scan_batches": 0, "write_batches": 0,
                     "plans": 0, "waves": 0, "wave_ops": 0}

    # -- plan mode (the default batched path) -----------------------------
    def _run_plans(self, ops: Sequence[Op]) -> dict:
        from .plan import DELETE, GET, PUT, Plan, SCAN, UPDATE
        code = {"lookup": GET, "insert": PUT, "update": UPDATE,
                "delete": DELETE, "scan": SCAN}
        n = len(ops)
        kinds = np.fromiter((code[k] for k, _, _ in ops), np.int32, n)
        keys = np.fromiter((k for _, k, _ in ops), np.int64, n)
        aux = np.fromiter((a for _, _, a in ops), np.int64, n)
        done = self.done
        cnt = np.bincount(kinds, minlength=5)
        done["lookup"] += int(cnt[GET])
        done["insert"] += int(cnt[PUT])
        done["update"] += int(cnt[UPDATE])
        done["delete"] += int(cnt[DELETE])
        done["scan"] += int(cnt[SCAN])
        mb = self.max_batch
        hist = self.lat_hist
        for lo in range(0, n, mb):
            plan = Plan.from_arrays(kinds[lo:lo + mb], keys[lo:lo + mb],
                                    aux[lo:lo + mb])
            if hist is not None:
                t0 = time.perf_counter_ns()
            res = self.index.execute(plan, collect_results=False)
            if hist is not None:
                # amortized per-op latency: the batch's ops share its cost
                hist.record_batch(time.perf_counter_ns() - t0, len(plan))
            done["found"] += res.found
            done["acked"] += res.acked
            done["scanned"] += res.scanned
            done["plans"] += 1
            done["waves"] += res.n_waves
            for wkind, width in zip(res.wave_kinds, res.wave_widths):
                done["wave_ops"] += width
                if wkind == "read":
                    done["batches"] += 1
                elif wkind == "scan":
                    done["scan_batches"] += 1
                else:
                    done["write_batches"] += 1
        return done

    def run(self, ops: Sequence[Op]) -> dict:
        if self.batch_lookups:
            return self._run_plans(ops)
        done = self.done
        index, lookup = self.index, self.index.lookup
        hist = self.lat_hist
        timer = time.perf_counter_ns
        for kind, key, aux in ops:
            if hist is not None:
                t0 = timer()
            if kind == "lookup":
                if lookup(key) is not None:
                    done["found"] += 1
                done["lookup"] += 1
            elif kind == "scan":
                done["scanned"] += len(index.scan(key, aux))
                done["scan"] += 1
            else:
                if kind == "insert":
                    r = index.insert(key, aux)
                elif kind == "update":
                    r = index.update(key, aux)
                else:
                    r = index.delete(key)
                done["acked"] += bool(r)
                done[kind] += 1
            if hist is not None:
                hist.record(timer() - t0)
        return done

