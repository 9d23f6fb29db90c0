"""``ShardedIndex`` — scale-out execution of operation plans across S
independent index shards (RECIPE's multi-threaded scaling story, §7,
recast onto the plan/wave engine).

Every shard is a full ``RecipeIndex`` of the same kind on its **own
PMem** — its own persistence domain, its own lock words, its own
group-commit epochs — so shards are independent failure domains
exactly like the per-thread partitions of the paper's YCSB runs.  Keys
route to shards with the same kernels/partition schemes the in-index
write path already uses: ``hash`` (splitmix64 top bits) for unordered
indexes, ``prefix`` (key top bits — contiguous key ranges) for ordered
ones.

Plan execution (``execute``) splits a plan into per-shard sub-plans
(``core.plan.split_by_shard``): point ops go to their routed shard,
scans are replicated to every shard that can hold matching keys and
the per-shard rows are merged back (ascending concatenation under
prefix routing, merge-sort under hash) and truncated to the requested
count.  Per-key program order is preserved — a key lives in exactly
one shard and sub-plan positions stay ascending — so each shard's
conflict-wave scheduler sees an ordinary plan.

All-GET plans can instead take the **mesh fan-out** path
(``distributed.mesh``): each shard's sorted-run snapshot is stacked on
a shard axis and ONE launch of the sorted-run search kernel answers
every shard.  A mesh plan that fails raises; it never drops to the
per-shard path.

Crash semantics are per-shard: an injected crash inside one shard's
group commit raises out of that shard's sub-plan only — sibling shards
still execute (independent devices), their durable state and snapshots
are untouched, and they keep serving stale-free reads with no replay.
The crashed shard's sub-plan is remembered; ``recover_shard`` re-runs
the shard's (trivial) RECIPE recovery and optionally replays exactly
that sub-plan — never a sibling's — on top of the shard's
plan-prefix-consistent image.

Throughput accounting: shard sub-plans are timed individually and a
``ShardedPlanResult`` reports both the serial wall time and the
*critical path* (routing + the slowest shard + merge) — the tick time
of an S-device mesh executing shard waves concurrently.  On a 1-core
host the wall clock serializes the shards; benchmarks report both
columns (the JAX package's docs/SHARDING.md, "Reporting model").

The port of ``repro.distributed.sharded``.  The one difference is where
routing runs: the JAX package routes and splits on the host; here
``execute`` uploads the plan's keys once and ``shard_partition`` routes
them and sorts them stably by shard on the shards' device (its plain
PyTorch version on the CPU).  The per-shard path reads the ids, the
permutation and the run offsets back in one copy: shard s's sub-plan is
``order[offsets[s]:offsets[s + 1]]``, ``split_by_shard``'s ascending
positions, unless the plan has a SCAN, whose replicas
``split_by_shard`` places from the ids.  The mesh path leaves all three
on the card: its search takes the keys and the ids there, and its
results and the offsets come back in one copy.  ``route`` (ids only)
runs the ``shard_route`` kernel.  Results, tallies and PMem counters are
the reference's, bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.plan import Plan, PlanResult, split_by_shard
from ..core.pmem import CrashPoint, OpCounters, PMem
from ..kernels.conflict import GET, SCAN
from ..device import resolve_device
from ..kernels.partition import route_params, route_shards, shard_partition
from ..kernels.readback import to_host
from ..obs import RECORDER as _OBS
from .mesh import build_stacked, found_values, probe_rows


class ShardedPMem:
    """Aggregate view over the per-shard persistence domains, shaped
    like the slice of ``PMem`` the drivers and the ``Session`` facade
    use (``counters``/``crashes``/``crash``)."""

    def __init__(self, pmems: List[PMem]):
        self.all = pmems

    @property
    def counters(self) -> OpCounters:
        agg = OpCounters()
        for pm in self.all:
            c = pm.counters
            agg.stores += c.stores
            agg.loads += c.loads
            agg.clwb += c.clwb
            agg.fence += c.fence
            agg.lines_touched += c.lines_touched
        return agg

    @property
    def crashes(self) -> int:
        return sum(pm.crashes for pm in self.all)

    def crash(self, mode: str = "powerfail", **kw) -> None:
        """Whole-domain power failure: every shard goes down."""
        for pm in self.all:
            pm.crash(mode=mode, **kw)


@dataclasses.dataclass
class ShardedPlanResult(PlanResult):
    """``PlanResult`` plus the scale-out telemetry drivers report."""

    shard_ops: List[int] = dataclasses.field(default_factory=list)
    shard_ns: List[int] = dataclasses.field(default_factory=list)
    route_ns: int = 0
    merge_ns: int = 0
    mesh: bool = False

    @property
    def critical_ns(self) -> int:
        """Modeled S-device tick time: serial routing + the slowest
        shard's sub-plan + serial merge.  Equals wall time at S=1."""
        return self.route_ns + max(self.shard_ns, default=0) + self.merge_ns

    @property
    def wall_ns(self) -> int:
        return self.route_ns + sum(self.shard_ns) + self.merge_ns


class ShardedIndex:
    """S independent shards of one ``RecipeIndex`` kind behind the
    plan/execute surface.  ``factory(pmem)`` builds one shard, on
    ``device`` (``"cuda"`` when omitted, as for the port's indexes):
    routing, the mesh read path and the shards' reads run there."""

    def __init__(self, factory: Callable[[PMem], Any], n_shards: int, *,
                 scheme: Optional[str] = None, seed: int = 0,
                 mesh_reads: bool = False, device=None):
        assert n_shards >= 1 and (n_shards & (n_shards - 1)) == 0, \
            f"n_shards must be a power of two, got {n_shards}"
        self.device = resolve_device(device)
        self.n_shards = n_shards
        self.pmems = [PMem(seed=seed + s) for s in range(n_shards)]
        self.shards = [factory(pm) for pm in self.pmems]
        for sh in self.shards:
            if sh.device != self.device:
                raise ValueError(f"a shard is on {sh.device}, the sharded "
                                 f"index on {self.device}")
        self.ORDERED = self.shards[0].ORDERED
        self.spec = self.shards[0].spec
        # ordered shards must be contiguous key ranges or cross-shard
        # scans lose their ascending-concatenation merge; unordered
        # shards hash-route for uniformity
        self.scheme = scheme or ("prefix" if self.ORDERED else "hash")
        self.mesh_reads = mesh_reads
        self.pmem = ShardedPMem(self.pmems)
        # crashed-shard bookkeeping: shard id -> the sub-plan arrays it
        # was executing when the crash hit (the replay unit)
        self._pending: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self.last_crashed_shard: Optional[int] = None
        self._mesh_cache: Optional[Tuple[tuple, Any]] = None
        self.stats = {"plans": 0, "mesh_plans": 0, "shard_subplans": 0,
                      "scan_merges": 0, "replayed_ops": 0}

    # -- routing ----------------------------------------------------------
    def route(self, keys: np.ndarray) -> np.ndarray:
        """Shard id per key ([Q] int32), kernels/partition routing on
        the shards' device."""
        return route_shards(np.asarray(keys, np.int64), self.n_shards,
                            self.scheme, device=self.device)

    # -- plan execution ---------------------------------------------------
    def execute(self, plan: Plan, *, force_kernel: bool = False,
                collect_results: bool = True,
                mesh: Optional[bool] = None) -> ShardedPlanResult:
        """Execute a plan across the shards; the results contract is
        ``RecipeIndex.execute``'s, bit-identical to running the same
        plan on one unsharded index.  ``mesh=True`` forces the fused
        fan-out probe for all-GET plans (``mesh=None`` follows the
        constructor's ``mesh_reads`` default)."""
        kinds, keys, aux = plan.arrays()
        n = int(kinds.shape[0])
        result = ShardedPlanResult(
            results=[None] * n if collect_results else [],
            wave_kinds=[], wave_widths=[])
        if n == 0:
            return result
        self.stats["plans"] += 1
        self.last_crashed_shard = None
        t0 = time.perf_counter_ns()
        bits, shift = route_params(self.n_shards, self.scheme)
        keys_dev = torch.from_numpy(np.ascontiguousarray(keys, np.int64)
                                    ).to(self.device)
        routed = shard_partition(keys_dev, bits=bits, shift=shift)
        use_mesh = self.mesh_reads if mesh is None else mesh
        if use_mesh and n >= self.n_shards and bool((kinds == GET).all()):
            # nothing comes back (the search reads the ids on the card),
            # but route_ns ends where the per-shard path's does: after
            # the partition has run
            if keys_dev.is_cuda:
                torch.cuda.current_stream(keys_dev.device).synchronize()
            result.route_ns = time.perf_counter_ns() - t0
            self._execute_mesh(keys, keys_dev, routed, result,
                               collect_results)
            return result
        shards, order, offsets = to_host(*routed)
        if (kinds == SCAN).any():
            parts = split_by_shard(
                kinds, shards, self.n_shards,
                scan_suffix=self.scheme.startswith("prefix"))
        else:
            parts = [order[offsets[s]:offsets[s + 1]]
                     for s in range(self.n_shards)]
        result.route_ns = time.perf_counter_ns() - t0
        self._execute_per_shard(kinds, keys, aux, parts, result,
                                force_kernel, collect_results)
        return result

    # -- per-shard sub-plan path ------------------------------------------
    def _execute_per_shard(self, kinds, keys, aux, parts, result,
                           force_kernel: bool, collect_results: bool) -> None:
        is_scan = kinds == SCAN
        has_scan = bool(is_scan.any())
        collect_sub = collect_results or has_scan
        crashed: Optional[int] = None
        sub_results: List[Optional[PlanResult]] = [None] * self.n_shards
        for s, idx in enumerate(parts):
            if idx.size == 0:
                result.shard_ops.append(0)
                result.shard_ns.append(0)
                continue
            sub = Plan.from_arrays(kinds[idx], keys[idx], aux[idx])
            t0 = time.perf_counter_ns()
            with _OBS.span("shard.plan", shard=s, ops=int(idx.size)) as sp:
                c0 = self.pmems[s].counters.snapshot() if sp else None
                try:
                    r = self.shards[s].execute(
                        sub, force_kernel=force_kernel,
                        collect_results=collect_sub)
                except CrashPoint:
                    # this shard's group commit died mid-plan; siblings
                    # are separate failure domains and keep executing
                    crashed = s
                    self._pending[s] = (kinds[idx].copy(), keys[idx].copy(),
                                        aux[idx].copy())
                    r = None
                if sp:
                    d = self.pmems[s].counters.delta(c0)
                    sp.set(stores=d.stores, loads=d.loads, clwb=d.clwb,
                           fence=d.fence, lines_touched=d.lines_touched,
                           crashed=s == crashed)
            result.shard_ns.append(time.perf_counter_ns() - t0)
            result.shard_ops.append(int(idx.size))
            self.stats["shard_subplans"] += 1
            sub_results[s] = r
            if r is not None:
                result.wave_kinds.extend(r.wave_kinds)
                result.wave_widths.extend(r.wave_widths)
                result.found += r.found
                result.acked += r.acked
                # probe-traffic deltas sum exactly across shards (the
                # attribution invariant candidates == fp_hits +
                # fp_false_positives is per-count additive)
                for name, delta in r.probe.items():
                    result.probe[name] = result.probe.get(name, 0) + delta
        if crashed is not None:
            # surface the crash exactly like an unsharded execute: the
            # plan's results are lost (un-acked), the caller decides
            # whether to power-fail + recover the affected shard
            self.last_crashed_shard = crashed
            raise CrashPoint()
        t0 = time.perf_counter_ns()
        if collect_results or has_scan:
            self._scatter(kinds, aux, parts, sub_results, result,
                          collect_results)
        result.merge_ns = time.perf_counter_ns() - t0

    def _scatter(self, kinds, aux, parts, sub_results, result,
                 collect_results: bool) -> None:
        """Scatter per-shard sub-results into global plan slots and
        merge replicated scans."""
        n = int(kinds.shape[0])
        is_scan = kinds == SCAN
        scan_rows: Dict[int, List[list]] = {p: [] for p in
                                            np.nonzero(is_scan)[0].tolist()}
        slots: List[Any] = result.results if collect_results else [None] * n
        for s, idx in enumerate(parts):
            r = sub_results[s]
            if r is None or idx.size == 0:
                continue
            for local, p in enumerate(idx.tolist()):
                if is_scan[p]:
                    scan_rows[p].append(r.results[local])
                else:
                    slots[p] = r.results[local]
        for p, rows in scan_rows.items():
            count = int(aux[p])
            if self.scheme.startswith("prefix"):
                # shards are ascending contiguous key ranges: ascending
                # concatenation of per-shard rows is globally sorted
                merged: list = []
                for rows_s in rows:
                    merged.extend(rows_s)
                    if len(merged) >= count:
                        break
            else:
                # hash-routed ordered index: rows interleave in key
                # order; every true first-count entry is within some
                # shard's first count, so merge-sort + truncate is exact
                merged = sorted(row for rows_s in rows for row in rows_s)
            merged = merged[:count]
            slots[p] = merged
            result.scanned += len(merged)
            self.stats["scan_merges"] += 1

    # -- mesh fan-out read path -------------------------------------------
    def _shard_sorted_run(self, s: int) -> Optional[Tuple[np.ndarray,
                                                          np.ndarray]]:
        """Shard s's sorted (keys, vals) run, memoized on its snapshot
        (the export — the only PMem traffic on this path — is wrapped
        in a shard-attributed span by the caller)."""
        sh = self.shards[s]
        snap = sh.snapshot()
        cell = snap.cache.get("mesh")  # 1-tuple: (run | None,)
        if cell is None:
            if snap.arrays is None:
                run = None
            elif sh.ORDERED:
                run = sh._scan_export(snap)
            else:
                items = sorted(sh.items())
                run = None if not items else (
                    np.fromiter((k for k, _ in items), np.int64, len(items)),
                    np.fromiter((v for _, v in items), np.int64, len(items)))
            cell = (run,)
            snap.cache["mesh"] = cell
        return cell[0]

    def _execute_mesh(self, keys, keys_dev, routed, result,
                      collect_results: bool) -> None:
        ek = tuple(sh._epoch_key() for sh in self.shards)
        if self._mesh_cache is None or self._mesh_cache[0] != ek:
            runs = []
            for s in range(self.n_shards):
                with _OBS.span("shard.export", shard=s) as sp:
                    c0 = self.pmems[s].counters.snapshot() if sp else None
                    runs.append(self._shard_sorted_run(s))
                    if sp:
                        d = self.pmems[s].counters.delta(c0)
                        sp.set(stores=d.stores, loads=d.loads, clwb=d.clwb,
                               fence=d.fence,
                               lines_touched=d.lines_touched)
            self._mesh_cache = (ek, build_stacked(runs,
                                                  device=self.device))
        stacked = self._mesh_cache[1]
        shards_dev, _, offsets_dev = routed
        t0 = time.perf_counter_ns()
        with _OBS.span("shard.mesh_lookup", shards=self.n_shards,
                       ops=int(keys.shape[0])):
            valid, okeys, ovals = probe_rows(stacked, keys_dev, shards_dev)
            okeys, ovals, offsets, valid = to_host(okeys, ovals, offsets_dev,
                                                   valid)
            found, vals = found_values(keys, valid, okeys, ovals)
        dt = time.perf_counter_ns() - t0
        # one launch covers all shards: book each shard's share of it
        # by its query weight (sums back to the wall)
        sizes = np.diff(offsets).tolist()
        total_q = max(1, sum(sizes))
        for size in sizes:
            result.shard_ops.append(size)
            result.shard_ns.append(dt * size // total_q)
        result.wave_kinds.append("read")
        result.wave_widths.append(int(keys.shape[0]))
        result.mesh = True
        self.stats["mesh_plans"] += 1
        result.found += int(found.sum())
        if collect_results:
            result.results[:] = [v if f else None for f, v in
                                 zip(found.tolist(), vals.tolist())]

    # -- crash / recovery -------------------------------------------------
    def crash_shard(self, s: int, mode: str = "powerfail", **kw) -> None:
        """Power-fail ONE shard's persistence domain.  Siblings keep
        their cache state, snapshots, and group-commit epochs."""
        self.pmems[s].crash(mode=mode, **kw)

    def recover_shard(self, s: int, *, replay: bool = True) -> int:
        """Re-attach shard ``s`` after its crash: run the index's
        (trivial) RECIPE recovery, then — ``replay=True`` — re-execute
        exactly the sub-plan the shard was running when it died, on top
        of its plan-prefix-consistent image.  Sibling shards are never
        touched and nothing of theirs replays.  Returns the number of
        ops replayed."""
        self.shards[s].recover()
        pend = self._pending.pop(s, None)
        if not replay or pend is None:
            return 0
        sub = Plan.from_arrays(*pend)
        self.shards[s].execute(sub, collect_results=False)
        self.stats["replayed_ops"] += len(sub)
        return len(sub)

    def recover(self) -> None:
        """Whole-domain re-attach (after ``pmem.crash`` hit every
        shard).  Un-acked in-flight sub-plans are abandoned — a full
        powerfail loses un-fenced work on every shard, exactly like the
        unsharded index — so pending replays are dropped."""
        self._pending.clear()
        for sh in self.shards:
            sh.recover()

    # -- introspection -----------------------------------------------------
    def items(self) -> Iterator[Tuple[int, int]]:
        """Merged iteration; globally sorted under prefix routing."""
        for sh in self.shards:
            for kv in sh.items():
                yield kv

    def keys(self) -> Iterator[int]:
        for k, _ in self.items():
            yield k

    def check_invariants(self) -> None:
        for sh in self.shards:
            sh.check_invariants()

    def __repr__(self) -> str:
        return (f"ShardedIndex({self.spec.name}, n_shards={self.n_shards}, "
                f"scheme={self.scheme!r})")


__all__ = ["ShardedIndex", "ShardedPMem", "ShardedPlanResult"]
