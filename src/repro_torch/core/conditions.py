"""The RECIPE conditions (§4) as first-class framework objects.

Every converted index declares which condition its non-SMO and SMO
paths satisfy (paper Table 2), and the conversion machinery enforces
the corresponding *persist discipline* at runtime:

* after any completed write operation, no dirtied cache line may remain
  unpersisted (``PMem.assert_clean`` — the paper's PIN durability test);
* Condition #2/#3 helper paths must persist the loads they depend on
  before acting (flush-on-read in the help path);
* Condition #3 indexes must route inconsistency fixes through a
  try-lock crash-detection gate (§6 "Crash detection").

The port of ``repro.core.conditions``: the epoch, snapshot and
per-wave protocols are the reference's, line for line, so results,
``probe_stats`` and PMem counters match it bit for bit.  What differs
is where a batched read runs: an index holds a ``device`` and its
snapshot's probe runs there (the CUDA kernel on the card, the plain
PyTorch version on the CPU), and a kernel that fails to build or launch
raises instead of falling back to scalar lookups.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..device import resolve_device
from .pmem import PMem, Region

# the probe-traffic counters every RecipeIndex carries (and every
# PlanResult / Session.stats mirrors).  The attribution invariant —
# candidates == fp_hits + fp_false_positives — is enforced at the
# accounting site (kernels.probe.fingerprint.account); the merge sites
# (plan deltas, sharded sub-results, metrics registries) sum these
# exactly, so it holds at every aggregation level.
PROBE_STAT_KEYS = ("fp_compares", "candidates", "fp_hits",
                   "fp_false_positives", "pm_load_words",
                   "optimistic_probes", "optimistic_retries")


def tracks_epoch(method):
    """Wrap a hand-written mutator (the ported baselines' insert/
    update/delete) so the snapshot epoch — and, inside ``_write_batch``,
    the scoped *shard* epoch — advances exactly when the call stored to
    PM.  The converted indexes bump inside their own write paths; a
    baseline that skips this leaves its shard epochs frozen, and
    ``_shard_refine`` would then serve every batched lookup from a
    stale snapshot (missing keys the same plan just inserted).  Keying
    on the store count preserves the no-op-update rule: a call that
    writes nothing invalidates nothing."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        before = self.pmem.counters.stores
        result = method(self, *args, **kwargs)
        if self.pmem.counters.stores != before:
            self._bump_epoch()
        return result
    return wrapped


class Condition(enum.Enum):
    """Which RECIPE condition a write path satisfies."""

    ATOMIC_STORE = 1  # updates visible via a single hardware-atomic store
    WRITERS_FIX = 2  # non-blocking writers with a helping mechanism
    WRITERS_DONT_FIX = 3  # blocking writers, detect but don't fix


@dataclasses.dataclass(frozen=True)
class ConversionSpec:
    """Per-index record of the conversion (paper Tables 1 & 2)."""

    name: str
    structure: str
    reader: str  # "non-blocking"
    writer: str  # "blocking" | "non-blocking"
    non_smo: Condition
    smo: Condition
    notes: str = ""


@dataclasses.dataclass
class IndexSnapshot:
    """A read-only export of an index's reachable state.

    ``arrays`` is index-specific (see each ``export_arrays``); ``epoch``
    is the validity key the snapshot was built under.  A snapshot is a
    *consistent point-in-time view*: batched lookups and range scans
    against it are bit-identical to scalar reads issued at export time.
    It must never be served across a write or a crash —
    ``RecipeIndex.snapshot`` enforces that by comparing epochs, with one
    refinement: ``shard_epochs`` records the per-shard write epochs at
    export time, and point lookups whose keys route to shards untouched
    since then may still be served (``_shard_refine``) — a sharded
    ``_write_batch`` wave invalidates only the shards it wrote.
    """

    epoch: Tuple[int, int, int]
    arrays: Any
    # kernel front-ends stash per-epoch prepared forms here (the table
    # uploaded to the index's device), so per-batch work is one launch
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # per-shard write epochs at export time (None until first export
    # under the sharded write protocol)
    shard_epochs: Optional[np.ndarray] = None


class RecipeIndex:
    """Base class for converted PM indexes.

    Concrete indexes implement ``insert/lookup/delete`` (and
    ``range_query`` for ordered indexes) directly against a ``PMem``.
    ``recover()`` is deliberately trivial for RECIPE indexes — the whole
    point of the paper is that reads/writes already contain the
    recovery logic; recovery only reinitializes volatile lock state,
    which ``PMem.crash`` already does.

    The batched read path (``snapshot``/``_lookup_batch``) layers on
    top: an index may export its reachable state as dense arrays once
    per *epoch* and answer whole batches of lookups against them with a
    vectorized kernel.  Writers bump the epoch (``_bump_epoch``) so a
    stale snapshot is never served; the epoch key additionally folds in
    the PMem store counter and crash count, so mutations through a
    different handle to the same PMem — or a powerfail that rolls the
    cache back to the persist image — also invalidate.
    """

    spec: ConversionSpec
    ORDERED = False

    # -- sharded write path configuration ---------------------------------
    N_WRITE_SHARDS = 16  # power of two; shard = top bits of the route
    SHARD_SCHEME = "hash"  # ordered indexes route by key prefix instead

    # fingerprint probe lanes: exports carry a 1-byte hash per slot
    # (kernels/probe/fingerprint) and the probe kernels read full
    # keys only on fingerprint hits.  Results are bit-identical either
    # way; flipping this off switches the probe-traffic model to
    # full-key gathers for every lane (the A/B the benchmarks measure).
    fingerprints = True

    def __init__(self, pmem: PMem, device=None):
        self.pmem = pmem
        # where snapshots live and the probe kernels run: the card
        # unless the caller asked for the CPU (the plain versions)
        self.device: torch.device = resolve_device(device)
        self._epoch = 0
        self._snapshot: Optional[IndexSnapshot] = None
        # per-shard write epochs: effective epoch of shard s is
        # _shard_epochs[s] + _all_bump (the offset trick keeps scalar
        # writers at one integer increment, and a plain list keeps the
        # per-op scoped bump at Python-int cost)
        self._shard_epochs = [0] * self.N_WRITE_SHARDS
        self._all_bump = 0
        self._shard_scope: Optional[int] = None  # _write_batch targeting
        # the snapshot that was current when the most recent write
        # batch *started* — the only export an overlapped read wave may
        # probe optimistically (version motion since it is then exactly
        # that wave's writes; see _optimistic_lookup)
        self._overlap_snap: Optional[IndexSnapshot] = None
        # stores attributable to this index's own (shard-tracked)
        # writes.  Indexes set _region_prefixes so the account covers
        # exactly their named regions: stores to *other* structures on
        # the same PMem (another index, an allocator bitmap) are not
        # foreign writers; a second handle mutating this index's
        # regions is, and poisons refinement.
        self._region_prefixes: Tuple[str, ...] = ()
        self._accounted_stores = pmem.counters.stores
        self.shard_stats = {"refined_batches": 0, "refined_queries": 0}
        # probe-traffic counters (see PROBE_STAT_KEYS): the kernel
        # front-ends fold fingerprint-filter outcomes and modeled PM
        # gather words in here; the optimistic read path adds its
        # probe/retry tallies.  Plan execution snapshots deltas of this
        # dict into PlanResult.probe.
        self.probe_stats = {k: 0 for k in PROBE_STAT_KEYS}

    # -- the one batched entry point: operation plans ---------------------
    def execute(self, plan, *, force_kernel: bool = False,
                collect_results: bool = True):
        """Execute an operation ``Plan`` (mixed GET/PUT/UPDATE/DELETE/
        SCAN); returns a ``PlanResult`` whose slot ``i`` is positionally
        identical to applying op ``i`` with the scalar methods in
        program order.  The conflict-wave scheduler (``core.plan``,
        kernels/conflict) partitions the plan into maximal conflict-free
        waves — per-key program order is preserved, independent keys
        are free to batch — and each wave runs as one batched
        lookup/scan dispatch or one sharded group-commit write epoch
        (``_lookup_batch``/``_scan_batch``/``_write_batch``, the
        private per-wave primitives).  Single-op plans degenerate to
        the scalar path.  A crash mid-plan leaves a plan-prefix-
        consistent image: waves commit in level order and a key's ops
        within a wave share one group-commit epoch.
        ``collect_results=False`` skips per-op result slots (tallies
        stay exact) for tally-only drivers."""
        from .plan import run_plan
        return run_plan(self, plan, force_kernel=force_kernel,
                        collect_results=collect_results)

    # -- the five-operation interface of §2.1 ---------------------------
    def insert(self, key: int, value: int) -> bool:
        raise NotImplementedError

    def update(self, key: int, value: int) -> bool:
        """Set ``key``'s value.  Overwriting a key with its current value
        is a no-op: nothing is written and no snapshot epoch is
        invalidated (the write-path mirror of the no-op-delete rule).
        The converted indexes override the changed-value case with their
        native update commit; this default maps it to insert semantics
        (several of the paper's baselines — FAST&FAIR, CCEH — do not
        support updates)."""
        if self.lookup(key) == value:
            return True
        return self.insert(key, value)

    def lookup(self, key: int) -> Optional[int]:
        raise NotImplementedError

    def delete(self, key: int) -> bool:
        raise NotImplementedError

    def range_query(self, key_lo: int, key_hi: int) -> List[Tuple[int, int]]:
        raise NotImplementedError(f"{self.spec.name} is unordered")

    # -- batched read path (snapshot + vectorized probe) ------------------
    def _epoch_key(self) -> Tuple[int, int, int]:
        """Validity key for snapshots: the index's own write epoch, the
        PMem global store count (any mutation goes through ``store``),
        and the crash count (powerfail rolls the cache back)."""
        return (self._epoch, self.pmem.counters.stores, self.pmem.crashes)

    def _bump_epoch(self) -> None:
        """Writers call this on insert/delete/SMO so stale snapshots are
        never served to batched readers.  Scalar writers (no shard
        scope) conservatively invalidate every shard and drop the
        memoized snapshot; inside ``_write_batch`` only the scoped shard
        is bumped and the snapshot object is kept — still never served
        whole (the coarse epoch key has moved), but point lookups in
        untouched shards may be refined against it."""
        self._epoch += 1
        if self._shard_scope is None:
            self._all_bump += 1
            self._snapshot = None
        else:
            self._shard_epochs[self._shard_scope] += 1

    def _effective_shard_epochs(self) -> np.ndarray:
        return np.asarray(self._shard_epochs, np.int64) + self._all_bump

    def write_versions(self) -> np.ndarray:
        """Per-shard write-version gauge ([N_WRITE_SHARDS] int64).

        Each shard's version advances exactly when a write stored into
        it; a snapshot records the gauge at export time.  The
        optimistic read path compares the two to decide which results
        of a probe that overlapped a write wave are still valid
        (``_optimistic_lookup``), and sessions surface the gauge as
        ``write_version_{i}`` metrics."""
        return self._effective_shard_epochs()

    def export_arrays(self) -> Any:
        """Dense-array export of the reachable state for batched
        lookups.  Index-specific layout; see PCLHT/PART."""
        raise NotImplementedError(f"{type(self).__name__} has no array export")

    def build_export(self) -> IndexSnapshot:
        """Build — but do not install — a point-in-time export.

        The deferred re-export path (``serving.pipeline.AsyncExporter``)
        splits ``snapshot()`` in two so the expensive array walk (and
        fingerprint-lane rebuild) can run off the read critical path:
        ``build_export`` captures the epoch key *before* walking (the
        export performs loads but no stores, so the pre-walk key is the
        right validity tag), and ``publish_export`` installs the result
        only if the index hasn't moved since."""
        key = self._epoch_key()
        return IndexSnapshot(epoch=key, arrays=self.export_arrays(),
                             shard_epochs=self._effective_shard_epochs())

    def publish_export(self, snap: IndexSnapshot) -> bool:
        """Epoch-guarded publication of a built export: install ``snap``
        as the serving snapshot iff the index is still at the epoch the
        export was built under.  A stale build (a write or crash landed
        in between) is rejected whole — a read wave can therefore never
        observe a half-published or torn export; it either sees the old
        snapshot or the complete new one.  Returns True on install."""
        if snap.epoch != self._epoch_key():
            return False
        self._snapshot = snap
        return True

    def snapshot(self) -> IndexSnapshot:
        """Return a point-in-time export, rebuilding only on epoch change."""
        key = self._epoch_key()
        if self._snapshot is None or self._snapshot.epoch != key:
            self._snapshot = self.build_export()
        return self._snapshot

    # -- sharded batched write path (partition + group commit) ------------
    def shard_route(self, keys: np.ndarray) -> np.ndarray:
        """Shard id per key ([Q] int32) under this index's routing
        scheme — kernels/partition, on the host."""
        from ..kernels.partition import route_shards
        return route_shards(np.asarray(keys, np.int64),
                            self.N_WRITE_SHARDS, self.SHARD_SCHEME)

    def _write_account(self) -> int:
        """Stores ever issued to this index's own regions (or the
        global count when the index hasn't declared its regions)."""
        prefixes = self._region_prefixes
        if prefixes:
            return sum(r.stores for r in self.pmem.regions.values()
                       if r.name.startswith(prefixes))
        return self.pmem.counters.stores

    def _begin_writes(self) -> None:
        """Foreign-writer gate: stores to this index's regions that did
        not come through its shard-tracked writers cannot be attributed
        to shards, so they invalidate every shard before the batch
        starts."""
        if self._write_account() != self._accounted_stores:
            self._all_bump += 1

    def _end_writes(self) -> None:
        self._accounted_stores = self._write_account()

    def _apply_write(self, kind: str, key: int, value: int):
        if kind == "insert":
            return self.insert(key, value)
        if kind == "update":
            return self.update(key, value)
        if kind == "delete":
            return self.delete(key)
        raise ValueError(f"unknown write kind {kind!r}")

    def _apply_shard_run(self, ops: Sequence[Tuple[str, int, int]],
                         positions: Sequence[int], results: List) -> None:
        """Apply one shard's run (in arrival order) and scatter results
        back to batch positions.  Indexes with a vectorized shard-run
        fast path override this; the default reuses the scalar ops —
        identical commit protocols, identical results."""
        for pos in positions:
            kind, key, value = ops[pos]
            results[pos] = self._apply_write(kind, int(key), int(value))

    def _write_batch(self, ops: Sequence[Tuple[str, int, int]], *,
                     group_commit: bool = True) -> List:
        """Per-wave write primitive (private: callers outside core go
        through ``execute``).  Apply a mixed batch of ``(kind, key,
        value)`` write ops
        (kind in insert/update/delete; value ignored for deletes),
        partitioned by shard.  Results are positionally identical to
        applying the ops one at a time with ``insert``/``update``/
        ``delete``: ops on the same key route to the same shard and
        keep their arrival order (stable sort), and ops on different
        keys commute — an op can only change the mapping at its own
        key, and every SMO a run triggers preserves the mapping.

        Each shard's run executes under one ``PMem.group_commit``
        epoch: the run's clwb/fence traffic collapses to one writeback
        per distinct dirtied line plus a single commit fence, and the
        run's ops are acknowledged together when the epoch closes (a
        crash mid-run loses only the un-acked group, never a fenced
        prefix).  Snapshot invalidation is per shard: only the shards
        a run actually wrote are bumped, so batched point lookups in
        untouched shards keep serving the existing snapshot
        (``_shard_refine``)."""
        if not ops:
            return []
        from ..kernels.partition import partition_writes
        keys = np.fromiter((op[1] for op in ops), np.int64, len(ops))
        shards, order, offsets = partition_writes(
            keys, self.N_WRITE_SHARDS, self.SHARD_SCHEME)
        results: List = [None] * len(ops)
        self._begin_writes()
        # arm the optimistic read overlap only when the snapshot is
        # current RIGHT NOW: any staleness predating this wave (earlier
        # plans whose small read batches never re-exported) could hide
        # writes that route to the same shards this wave touches, and
        # the per-shard version check could not tell them apart
        self._overlap_snap = (
            self._snapshot
            if (self._snapshot is not None
                and self._snapshot.epoch == self._epoch_key())
            else None)
        prev_scope = self._shard_scope
        try:
            order = order.tolist()
            for s in range(self.N_WRITE_SHARDS):
                lo, hi = int(offsets[s]), int(offsets[s + 1])
                if lo == hi:
                    continue
                self._shard_scope = s
                if group_commit:
                    with self.pmem.group_commit():
                        self._apply_shard_run(ops, order[lo:hi], results)
                else:
                    self._apply_shard_run(ops, order[lo:hi], results)
        finally:
            self._shard_scope = prev_scope
            self._end_writes()
        return results

    def _shard_refine(self, keys: np.ndarray) -> Optional[np.ndarray]:
        """When the memoized snapshot is stale *only* because of this
        index's own sharded writes, return the boolean mask of queries
        whose shards are untouched since the export — those are
        servable from the old snapshot (its arrays are immutable
        copies, and a write can only change the mapping at its own
        key, which routes to the written shard).  None when no
        refinement applies: after a crash (the cache rolled back),
        after foreign stores (unattributable), or when every shard
        moved (scalar writers bump all)."""
        snap = self._snapshot
        if snap is None or snap.shard_epochs is None:
            return None
        if self.pmem.crashes != snap.epoch[2]:
            return None
        if self._write_account() != self._accounted_stores:
            return None
        clean = snap.shard_epochs == self._effective_shard_epochs()
        if not clean.any():
            return None
        return clean[self.shard_route(keys)]

    _MIN_KERNEL_BATCH = 8  # below this, kernel dispatch overhead loses
    _MIN_REBUILD_BATCH = 512  # amortizes a snapshot re-export

    def _rebuild_floor(self) -> int:
        """Smallest batch worth rebuilding a stale snapshot for;
        indexes with size-dependent export costs override this."""
        return self._MIN_REBUILD_BATCH

    def _kernel_lookup(self, snapshot: IndexSnapshot, queries: np.ndarray
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Vectorized probe of a snapshot: (found [Q] bool, values [Q]
        int64), or None for an empty structure.  Kernel-backed indexes
        implement this; the base raises so ``_lookup_batch`` stays on
        the scalar path."""
        raise NotImplementedError

    def _optimistic_lookup(self, keys: np.ndarray, written: np.ndarray
                           ) -> Optional[List[Optional[int]]]:
        """Version-validated optimistic read: probe the *pre-write*
        snapshot as if the read wave had overlapped the preceding write
        wave, then validate against the per-shard write-version gauge.

        Validity argument: the probed snapshot must be the one that was
        current when the overlapping write wave *started*
        (``_overlap_snap``) — then every version moved since the export
        is that wave's own writes, a write can only change the mapping
        at its own key, and every moved shard must route some written
        key (else a concurrent writer this path cannot reason about is
        active and we fall back to the fenced path).  A probed key is
        therefore stale only if it was itself written *and* its shard's
        version actually moved — exactly those keys re-run through the
        fenced ``_lookup_batch``; every other result from the stale
        snapshot is already bit-identical to a fenced read.  A snapshot
        that predates the wave (earlier plans' writes never re-exported)
        never qualifies: staleness from before the wave could route to
        the same shards the wave wrote, and the version check could not
        attribute it.

        Returns None when the optimistic protocol does not apply (no
        snapshot, snapshot older than the wave, crash since export,
        unattributable foreign stores, or a batch below the kernel
        floor) — the caller then takes the fenced path."""
        snap = self._snapshot
        if snap is None or snap.shard_epochs is None:
            return None
        if snap is not self._overlap_snap:
            return None  # export predates the overlapping write wave
        if self.pmem.crashes != snap.epoch[2]:
            return None
        if self._write_account() != self._accounted_stores:
            return None
        if len(keys) < self._MIN_KERNEL_BATCH:
            return None
        moved = snap.shard_epochs != self.write_versions()
        if moved.any():
            written_shards = np.zeros(self.N_WRITE_SHARDS, bool)
            if len(written):
                written_shards[self.shard_route(written)] = True
            if bool((moved & ~written_shards).any()):
                return None  # movement we cannot attribute to the wave
        # the overlapped probe: reads the stale arrays, no fence taken
        if snap.arrays is None:
            res = None  # empty at export: every un-retried key is absent
        else:
            try:
                res = self._kernel_lookup(snap, keys)
            except NotImplementedError:
                return None
        self.probe_stats["optimistic_probes"] += len(keys)
        # a crash may land between the overlapped probe and its version
        # re-validation; the sweep in core.crash_testing arms this point
        self.pmem.crash_point()
        out: List[Optional[int]] = [None] * len(keys)
        if res is not None:
            found, vals = res
            out = [v if f else None
                   for f, v in zip(found.tolist(), vals.tolist())]
        retry = np.isin(keys, written)
        if moved.any():
            retry &= moved[self.shard_route(keys)]
        else:
            # no shard moved => the written ops were no-ops; nothing
            # the probe returned can be stale
            retry[:] = False
        n_retry = int(retry.sum())
        if n_retry:
            self.probe_stats["optimistic_retries"] += n_retry
            fresh = self._lookup_batch(keys[retry])  # the fenced path
            for i, v in zip(np.nonzero(retry)[0].tolist(), fresh):
                out[i] = v
        return out

    def _lookup_batch(self, keys: Sequence[int], *,
                      force_kernel: bool = False,
                      overlap_writes: Optional[np.ndarray] = None
                      ) -> List[Optional[int]]:
        """Per-wave read primitive (private: callers outside core go
        through ``execute``).  Batched point lookups; results are
        bit-identical to calling ``lookup`` once per key.

        Dispatch is adaptive: batches below ``_MIN_KERNEL_BATCH`` — or,
        when the snapshot is stale (a write happened), below the
        rebuild floor — run the correct scalar fallback, which is
        cheaper under the amortization point.  ``force_kernel`` skips
        the floors: callers in steady read loops (the serving decode
        path) use it to keep scalar lookups entirely off their hot
        path.  Indexes without an array export always go scalar.

        ``overlap_writes`` (the plan scheduler's push-reads-late pass
        passes the keys the preceding write waves stored) opts this
        wave into the optimistic version-validated read: probe the
        pre-write snapshot, re-validate shard versions after the
        gather, re-run only invalidated keys fenced
        (``_optimistic_lookup``)."""
        stale = (self._snapshot is None
                 or self._snapshot.epoch != self._epoch_key())
        if stale and overlap_writes is not None and not force_kernel \
                and len(keys):
            opt = self._optimistic_lookup(
                np.asarray(keys, np.int64),
                np.asarray(overlap_writes, np.int64))
            if opt is not None:
                return opt
        if stale and not force_kernel and len(keys):
            refined = self._refined_lookup(np.asarray(keys, np.int64))
            if refined is not None:
                return refined
        floor = self._rebuild_floor() if stale else self._MIN_KERNEL_BATCH
        if len(keys) < floor and not force_kernel:
            return [self.lookup(int(k)) for k in keys]
        try:
            res = self._kernel_lookup(self.snapshot(),
                                      np.asarray(keys, np.int64))
        except NotImplementedError:  # no array export for this index
            return [self.lookup(int(k)) for k in keys]
        if res is None:  # empty structure: nothing can be found
            return [None] * len(keys)
        found, vals = res
        return [v if f else None
                for f, v in zip(found.tolist(), vals.tolist())]

    def _refined_lookup(self, keys: np.ndarray) -> Optional[List[Optional[int]]]:
        """Serve a stale-snapshot batch by shard validity: queries in
        untouched shards probe the existing snapshot's kernel path (no
        re-export), the rest fall back to scalar lookups.  Returns None
        when refinement does not apply or is not worth a kernel
        dispatch — the caller then runs the usual stale-path logic.
        Range scans are never refined: a scan window crosses shard
        boundaries, so any dirty shard invalidates it."""
        mask = self._shard_refine(keys)
        if mask is None or int(mask.sum()) < self._MIN_KERNEL_BATCH:
            return None
        snap = self._snapshot
        clean_idx = np.nonzero(mask)[0]
        out: List[Optional[int]] = [None] * len(keys)
        if snap.arrays is None:
            res = None  # empty at export + untouched shard: still absent
        else:
            try:
                res = self._kernel_lookup(snap, keys[clean_idx])
            except NotImplementedError:
                return None
        if res is not None:
            found, vals = res
            for i, f, v in zip(clean_idx.tolist(), found.tolist(),
                               vals.tolist()):
                out[i] = v if f else None
        for i in np.nonzero(~mask)[0].tolist():
            out[i] = self.lookup(int(keys[i]))
        self.shard_stats["refined_batches"] += 1
        self.shard_stats["refined_queries"] += len(clean_idx)
        return out

    # -- batched range scans (ordered indexes only) -----------------------
    def scan(self, start_key: int, count: int) -> List[Tuple[int, int]]:
        """Scalar range scan: the first ``count`` live entries with
        key >= ``start_key``, ascending (YCSB-E's "scan N records from a
        start key").  The default walks the index's sorted iteration
        with an early exit; tree indexes override with a descend +
        sibling walk."""
        if not self.ORDERED:
            raise NotImplementedError(f"{self.spec.name} is unordered")
        if count <= 0:
            return []
        out: List[Tuple[int, int]] = []
        for k, v in self.items():  # type: ignore[attr-defined]
            if k >= start_key:
                out.append((k, v))
                if len(out) >= count:
                    break
        return out

    def _scan_export(self, snapshot: IndexSnapshot
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Sorted (keys, vals) int64 run of the live entries — the
        page export the shared kernels/scan engine probes.  The default
        materializes the index's sorted iteration; P-Masstree/P-BwTree
        override to reuse their (already sorted) lookup export.  Called
        at most once per epoch: kernels/scan memoizes the prepared form
        on the snapshot."""
        items = list(self.items())  # type: ignore[attr-defined]
        if not items:
            return None
        keys = np.fromiter((k for k, _ in items), np.int64, len(items))
        vals = np.fromiter((v for _, v in items), np.int64, len(items))
        return keys, vals

    def _kernel_scan(self, snapshot: IndexSnapshot, starts: np.ndarray,
                     counts: np.ndarray
                     ) -> Optional[List[List[Tuple[int, int]]]]:
        """Vectorized range scans of a snapshot, or None for an empty
        structure.  Ordered indexes share one implementation: lower
        bound + window gather over the sorted run from _scan_export
        (kernels/scan), on the index's device.  Unordered indexes raise
        so ``_scan_batch`` stays on the scalar path (which raises in
        turn)."""
        if not self.ORDERED:
            raise NotImplementedError(f"{self.spec.name} is unordered")
        from ..kernels.scan import snapshot_scan
        return snapshot_scan(snapshot, starts, counts,
                             lambda: self._scan_export(snapshot),
                             device=self.device)

    def _scan_batch(self, start_keys: Sequence[int],
                    counts: Sequence[int], *, force_kernel: bool = False
                    ) -> List[List[Tuple[int, int]]]:
        """Per-wave scan primitive (private: callers outside core go
        through ``execute``).  Batched range scans; results are
        bit-identical to calling ``scan`` once per (start_key, count).

        Dispatch mirrors ``_lookup_batch`` with one twist: the floors
        compare against the *total records requested* (sum of counts),
        the unit the export cost actually amortizes over — a 64-scan
        batch probing 100 records each is kernel-worthy even though 64
        lookups would not be.  The stale-snapshot floor is 4x the
        lookup rebuild floor (on the order of the structure's live
        entry count): the sorted-run export walks every live entry, so
        a batch requesting fewer records than that is cheaper as
        scalar descend-and-walk scans.  Epoch semantics are identical
        to lookups: any write or crash invalidates the snapshot and
        small stale batches fall back to the scalar path."""
        counts = [int(c) for c in counts]
        assert len(counts) == len(start_keys)
        stale = (self._snapshot is None
                 or self._snapshot.epoch != self._epoch_key())
        floor = (4 * self._rebuild_floor() if stale
                 else self._MIN_KERNEL_BATCH)
        if sum(counts) < floor and not force_kernel:
            return [self.scan(int(k), c)
                    for k, c in zip(start_keys, counts)]
        try:
            res = self._kernel_scan(self.snapshot(),
                                    np.asarray(start_keys, np.int64),
                                    np.asarray(counts, np.int64))
        except NotImplementedError:  # unordered / no sorted iteration
            return [self.scan(int(k), c)
                    for k, c in zip(start_keys, counts)]
        if res is None:  # empty structure: every scan is empty
            return [[] for _ in start_keys]
        return res

    # -- recovery --------------------------------------------------------
    def recover(self) -> None:
        """Post-crash hook.  RECIPE indexes need no log replay: reads
        tolerate and writes fix inconsistencies.  (Hand-crafted baselines
        override this with their real recovery algorithms.)"""

    # -- introspection for tests/benchmarks -------------------------------
    def keys(self) -> Iterator[int]:
        raise NotImplementedError

    def check_invariants(self) -> None:
        """Structure-specific integrity check used by property tests."""

    # -- volatile (non-PM) python-side state, for snapshot/restore --------
    def volatile_state(self) -> dict:
        return {}

    def set_volatile_state(self, state: dict) -> None:
        pass


def crash_detect_fix(pmem: PMem, lock_region: Region, lock_slot: int,
                     fix: Callable[[], None]) -> bool:
    """The §6 "Crash detection" gate for Condition #3 indexes.

    On observing an inconsistency during traversal, try the node lock:
    if it cannot be acquired the inconsistency is (possibly) transient —
    another writer owns it; if it *can* be acquired there is no
    concurrent writer, so the inconsistency is permanent (a crash
    artifact) and ``fix`` — built from the write path — repairs it.
    Returns True if the fix ran.
    """
    if not pmem.try_lock(lock_region, lock_slot):
        return False
    try:
        fix()
        return True
    finally:
        pmem.unlock(lock_region, lock_slot)


CONVERSION_TABLE: Dict[str, ConversionSpec] = {}


def register(spec: ConversionSpec) -> ConversionSpec:
    CONVERSION_TABLE[spec.name] = spec
    return spec
