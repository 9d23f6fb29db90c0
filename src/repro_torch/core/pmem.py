"""Simulated persistent memory (PM) with an explicit volatile-cache front.

This module is the substrate every RECIPE index runs on.  It models the
x86+Optane semantics the paper relies on, at the granularity the paper
reasons about:

* stores are 8-byte failure-atomic words written to a *volatile cache*;
* a 64-byte cache line (8 words) is the unit of writeback;
* ``clwb(line)`` marks a line for writeback; the writeback is only
  guaranteed ordered/durable after the next ``fence()``;
* dirty lines that were never flushed may *still* reach PM at any time
  (cache eviction) — so the post-crash image is
  ``persisted ∪ (arbitrary subset of dirty lines)``;
* a crash drops the volatile cache and reinitializes all locks
  (RECIPE §4.2: locks are non-persistent and reinitialized).

Two crash modes are provided:

* ``interrupt`` — the op is cut mid-way but memory is kept (the paper's
  §5 *consistency* test: "returning from the operation without any
  clean-up activities");
* ``powerfail`` — additionally the cache is replaced by a persist image
  (optionally an adversarial one with random evicted lines), which
  functionally catches missing flushes.

The simulator also keeps the paper's Table-4 counters: ``clwb`` and
``fence`` counts per operation, plus a lines-touched proxy for LLC
misses (distinct cache lines loaded per op).

``group_commit()`` opens a *group-commit epoch* for batched writers:
inside the epoch ``clwb``/``fence`` are deferred (each dirtied line is
recorded once), and the epoch closes with one writeback per distinct
recorded line plus a single commit fence — the flush/fence traffic of
a whole shard batch amortized into one persist point.  Ops inside a
group are acknowledged only when the epoch closes; a crash mid-group
abandons the deferred flushes, exactly as a power failure would (the
un-acked suffix of the group may be lost, never a previously fenced
prefix).  Counters stay honest: deferred calls count nothing, the
close counts exactly the clwb/fence instructions it issues.  See
the JAX package's docs/PMEM_MODEL.md for the full semantics and the
eviction caveat.  This module is a line-for-line copy of
``repro.core.pmem`` (host numpy state, same eviction RNG stream, same
set iteration order), so crash images match the reference bit for bit.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from ..obs import RECORDER as _OBS

WORD_BYTES = 8
CACHELINE_BYTES = 64
WORDS_PER_LINE = CACHELINE_BYTES // WORD_BYTES

NULL = 0  # null pointer / empty-key sentinel used across indexes

_M64 = (1 << 64) - 1
_SIGN64 = 1 << 63


class CrashPoint(Exception):
    """Raised by the simulator when an injected crash triggers."""


class DeadlockError(Exception):
    """A lock spun past the deadlock guard (e.g. persisted-lock bug)."""


@dataclasses.dataclass
class OpCounters:
    """Per-operation instruction counters (paper Table 4)."""

    stores: int = 0
    loads: int = 0
    clwb: int = 0
    fence: int = 0
    lines_touched: int = 0  # distinct cache lines loaded (LLC-miss proxy)

    def snapshot(self) -> "OpCounters":
        return dataclasses.replace(self)

    def delta(self, since: "OpCounters") -> "OpCounters":
        return OpCounters(
            stores=self.stores - since.stores,
            loads=self.loads - since.loads,
            clwb=self.clwb - since.clwb,
            fence=self.fence - since.fence,
            lines_touched=self.lines_touched - since.lines_touched,
        )


class Region:
    """A named PM allocation backed by two int64 arrays (cache + pm)."""

    __slots__ = ("name", "rid", "cache", "pm", "dirty", "pending", "n_words",
                 "stores")

    def __init__(self, name: str, rid: int, n_words: int):
        self.name = name
        self.rid = rid
        self.n_words = n_words
        self.cache = np.zeros(n_words, dtype=np.int64)
        self.pm = np.zeros(n_words, dtype=np.int64)
        self.dirty: Set[int] = set()  # line indices dirty in cache
        self.pending: Set[int] = set()  # line indices clwb'd, awaiting fence
        self.stores = 0  # per-region store count (foreign-writer detection)

    def line_of(self, idx: int) -> int:
        return idx // WORDS_PER_LINE


class PMem:
    """The simulated persistence domain.

    All index state lives in ``Region``s allocated from here.  Locks are
    volatile side-state (cleared on crash).  Crash injection is by
    store-count trigger: the paper's targeted strategy is "crash after
    each atomic store", so the tester counts an op's stores and replays
    with ``crash_after_store = k`` for every k.
    """

    def __init__(self, seed: int = 0, max_spins: int = 100_000):
        self.regions: Dict[int, Region] = {}
        self._next_rid = 1
        self.locks: Dict[Tuple[int, int], bool] = {}  # (rid, slot) -> held
        self._shared: Dict[Tuple[int, int], int] = {}  # rw-lock reader counts
        self._lock_mutex = threading.Lock()  # protects lock-state only
        self.max_spins = max_spins
        self.counters = OpCounters()
        self._touched_lines: Set[Tuple[int, int]] = set()
        self.rng = np.random.default_rng(seed)
        # Crash injection
        self.crash_after_store: Optional[int] = None
        self._stores_until_crash = 0
        self.crash_calls = 0  # total crash points seen (for samplers)
        self.crashes = 0  # completed crash() events (snapshot invalidation)
        # Allocation log for epoch GC (RECIPE assumes a GC'd PM allocator)
        self.alloc_log: List[int] = []
        # Group-commit epoch state (see group_commit())
        self._group_depth = 0
        self._group_lines: Set[Tuple[int, int]] = set()  # (rid, line)
        self._group_fence_wanted = False

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------
    def alloc(self, name: str, n_words: int) -> Region:
        rid = self._next_rid
        self._next_rid += 1
        region = Region(name, rid, n_words)
        self.regions[rid] = region
        self.alloc_log.append(rid)
        return region

    def free(self, region: Region) -> None:
        self.regions.pop(region.rid, None)

    def find(self, name: str) -> Optional[Region]:
        """Attach to an existing named region (process-restart path)."""
        for region in self.regions.values():
            if region.name == name:
                return region
        return None

    # ------------------------------------------------------------------
    # the x86-ish primitive set
    # ------------------------------------------------------------------
    def store(self, region: Region, idx: int, value: int) -> None:
        """8-byte atomic store to the volatile cache."""
        self._maybe_crash()
        v = int(value) & _M64
        if v >= _SIGN64:  # two's-complement wrap into the signed PM word
            v -= _M64 + 1
        region.cache[idx] = v
        region.dirty.add(idx // WORDS_PER_LINE)
        region.stores += 1
        self.counters.stores += 1

    def store_bulk(self, region: Region, start: int,
                   words: np.ndarray) -> None:
        """Vectorized multi-word store (checkpoint blobs).  Counts one
        crash point (crashes land between blobs, not mid-word — the
        8-byte units inside are individually failure-atomic and the
        commit protocol never depends on their order)."""
        self._maybe_crash()
        n = len(words)
        region.cache[start:start + n] = words
        first, last = start // WORDS_PER_LINE, (start + n - 1) // WORDS_PER_LINE
        region.dirty.update(range(first, last + 1))
        region.stores += n
        self.counters.stores += n

    def load_bulk(self, region: Region, start: int, n: int) -> np.ndarray:
        """Vectorized multi-word load (counts ``n`` loads and every line
        overlapped, so the batched write paths keep the Table-4 proxies
        honest)."""
        self.counters.loads += n
        first = start // WORDS_PER_LINE
        last = (start + max(n, 1) - 1) // WORDS_PER_LINE
        rid = region.rid
        touched = self._touched_lines
        for line in range(first, last + 1):
            key = (rid, line)
            if key not in touched:
                touched.add(key)
                self.counters.lines_touched += 1
        return region.cache[start:start + n].copy()

    def load(self, region: Region, idx: int) -> int:
        self.counters.loads += 1
        key = (region.rid, region.line_of(idx))
        if key not in self._touched_lines:
            self._touched_lines.add(key)
            self.counters.lines_touched += 1
        return int(region.cache[idx])

    def cas(self, region: Region, idx: int, expected: int, new: int) -> bool:
        """Compare-and-swap; counts as a store when it succeeds.  The
        compare is a counted load (it touches the line like any read);
        ``load`` has no crash point, so failure injection still lands
        only on the store side."""
        if self.load(region, idx) != expected:
            return False
        self.store(region, idx, new)
        return True

    def clwb(self, region: Region, idx: int) -> None:
        """Initiate writeback of the line containing ``idx``.  Inside a
        group-commit epoch the writeback is deferred: the line is
        recorded once and flushed (and counted) at epoch close."""
        line = region.line_of(idx)
        if self._group_depth:
            self._group_lines.add((region.rid, line))
            return
        if line in region.dirty:
            region.pending.add(line)
            region.dirty.discard(line)
        self.counters.clwb += 1

    def flush_range(self, region: Region, lo: int, hi: int) -> None:
        """clwb every line overlapping words [lo, hi)."""
        first, last = lo // WORDS_PER_LINE, (max(hi, lo + 1) - 1) // WORDS_PER_LINE
        for line in range(first, last + 1):
            self.clwb(region, line * WORDS_PER_LINE)

    def fence(self) -> None:
        """sfence: all pending writebacks become durable, in order.
        Inside a group-commit epoch the fence is deferred to the single
        commit fence at epoch close."""
        if self._group_depth:
            self._group_fence_wanted = True
            return
        self._fence_now()

    def _fence_now(self) -> None:
        self.counters.fence += 1
        for region in self.regions.values():
            if region.pending:
                for line in region.pending:
                    lo = line * WORDS_PER_LINE
                    hi = min(lo + WORDS_PER_LINE, region.n_words)
                    region.pm[lo:hi] = region.cache[lo:hi]
                region.pending.clear()

    def persist(self, region: Region, idx: int) -> None:
        """Convenience: clwb + fence for one word's line."""
        self.clwb(region, idx)
        self.fence()

    def persist_region(self, region: Region) -> None:
        self.flush_range(region, 0, region.n_words)
        self.fence()

    # ------------------------------------------------------------------
    # group commit (the sharded batched write path's persist epoch)
    # ------------------------------------------------------------------
    def group_commit(self) -> "_GroupCommit":
        """Open a group-commit epoch: ``clwb`` records its line (once),
        ``fence`` records that durability was requested, and the epoch
        close issues one clwb per distinct recorded line plus a single
        commit fence.  Ops inside the group are acknowledged only at
        close; an exception (including an injected ``CrashPoint``)
        abandons the deferred flushes — power-fail semantics, no
        clean-up activities.  Nestable; only the outermost close
        persists."""
        return _GroupCommit(self)

    def _close_group(self) -> None:
        lines = sorted(self._group_lines)
        self._group_lines = set()
        wanted = self._group_fence_wanted or bool(lines)
        self._group_fence_wanted = False
        for rid, line in lines:
            region = self.regions.get(rid)
            if region is None:
                continue  # freed mid-group (CoW swap garbage)
            if line in region.dirty:
                region.pending.add(line)
                region.dirty.discard(line)
            self.counters.clwb += 1
        if wanted:
            self._fence_now()

    def _abandon_group(self) -> None:
        self._group_lines = set()
        self._group_fence_wanted = False

    # ------------------------------------------------------------------
    # locks (volatile; reinitialized on crash — RECIPE §4.2/§6)
    # ------------------------------------------------------------------
    def try_lock(self, region: Region, slot: int = 0) -> bool:
        key = (region.rid, slot)
        with self._lock_mutex:
            if self.locks.get(key):
                return False
            self.locks[key] = True
            return True

    def lock(self, region: Region, slot: int = 0) -> None:
        """Blocking (spinning) exclusive lock with a deadlock guard."""
        for _ in range(self.max_spins):
            if self.try_lock(region, slot):
                return
        raise DeadlockError(f"lock ({region.name},{slot}) spun out")

    def unlock(self, region: Region, slot: int = 0) -> None:
        with self._lock_mutex:
            self.locks.pop((region.rid, slot), None)

    def holds_lock(self, region: Region, slot: int = 0) -> bool:
        return bool(self.locks.get((region.rid, slot)))

    # shared/exclusive lock (e.g. CLHT global resize lock)
    def lock_shared(self, region: Region, slot: int = 0) -> None:
        key = (region.rid, slot)
        for _ in range(self.max_spins):
            with self._lock_mutex:
                if not self.locks.get(key):
                    self._shared[key] = self._shared.get(key, 0) + 1
                    return
        raise DeadlockError(f"shared lock ({region.name},{slot}) spun out")

    def unlock_shared(self, region: Region, slot: int = 0) -> None:
        key = (region.rid, slot)
        with self._lock_mutex:
            n = self._shared.get(key, 0)
            if n <= 1:
                self._shared.pop(key, None)
            else:
                self._shared[key] = n - 1

    def lock_excl(self, region: Region, slot: int = 0) -> None:
        key = (region.rid, slot)
        for _ in range(self.max_spins):
            with self._lock_mutex:
                if not self.locks.get(key) and not self._shared.get(key):
                    self.locks[key] = True
                    return
        raise DeadlockError(f"excl lock ({region.name},{slot}) spun out")

    # ------------------------------------------------------------------
    # crash machinery
    # ------------------------------------------------------------------
    def arm_crash(self, after_stores: int) -> None:
        self.crash_after_store = after_stores
        self._stores_until_crash = after_stores

    def disarm_crash(self) -> None:
        self.crash_after_store = None

    def _maybe_crash(self) -> None:
        self.crash_calls += 1
        if self.crash_after_store is None:
            return
        self._stores_until_crash -= 1
        if self._stores_until_crash < 0:
            self.crash_after_store = None
            raise CrashPoint()

    def crash_point(self) -> None:
        """An explicit crash-injection point for protocol windows that
        contain no store of their own — e.g. between an optimistic
        read's overlapped probe and its version re-validation.  Counts
        (and may fire) exactly like the store-path crash points, so
        ``crash_calls``-offset sweeps enumerate these windows too."""
        self._maybe_crash()

    def crash(self, mode: str = "powerfail", evict_probability: float = 0.0) -> None:
        """Simulate the machine dying.

        ``interrupt``  — keep memory, just reinit locks (paper §5 consistency
                         test runs in DRAM emulation: partial state persists).
        ``powerfail``  — replace cache with the persist image.  Any *dirty*
                         (never flushed) line additionally lands in PM with
                         probability ``evict_probability`` — the adversarial
                         eviction the hardware is allowed to do.
        """
        self.disarm_crash()
        self.crashes += 1
        if mode == "powerfail":
            for region in self.regions.values():
                # pending-but-unfenced flushes may or may not have landed;
                # treat them like dirty lines (reachable by eviction).
                maybe = list(region.pending | region.dirty)
                for line in maybe:
                    if evict_probability and self.rng.random() < evict_probability:
                        lo = line * WORDS_PER_LINE
                        hi = min(lo + WORDS_PER_LINE, region.n_words)
                        region.pm[lo:hi] = region.cache[lo:hi]
                region.cache[:] = region.pm
                region.dirty.clear()
                region.pending.clear()
        elif mode != "interrupt":
            raise ValueError(f"unknown crash mode {mode!r}")
        # a crash inside a group-commit epoch abandons its deferred
        # flushes — the un-acked group never becomes durable
        self._abandon_group()
        # RECIPE §4.2: locks are volatile and reinitialized after a crash.
        with self._lock_mutex:
            self.locks.clear()
            self._shared.clear()

    # ------------------------------------------------------------------
    # durability audit (the paper's PIN-based test, §5 "Testing durability")
    # ------------------------------------------------------------------
    def unpersisted_lines(self) -> List[Tuple[str, int]]:
        """Lines dirtied but not yet durable — must be empty after any op
        completes, for a correctly converted index."""
        out: List[Tuple[str, int]] = []
        for region in self.regions.values():
            for line in sorted(region.dirty | region.pending):
                out.append((region.name, line))
        return out

    def assert_clean(self) -> None:
        leftover = self.unpersisted_lines()
        if leftover:
            raise AssertionError(f"dirty unpersisted cache lines after op: {leftover}")

    # ------------------------------------------------------------------
    # counters
    # ------------------------------------------------------------------
    def begin_op(self) -> OpCounters:
        self._touched_lines.clear()
        return self.counters.snapshot()

    def end_op(self, start: OpCounters) -> OpCounters:
        return self.counters.delta(start)


class _GroupCommit:
    """Context manager behind ``PMem.group_commit()``.  On clean exit of
    the outermost group it issues the epoch's writebacks and commit
    fence; on exception it abandons them (power-fail semantics — the
    un-acked group is simply not durable)."""

    __slots__ = ("pmem", "_span", "_c0")

    def __init__(self, pmem: PMem):
        self.pmem = pmem
        self._span = None
        self._c0 = None

    def __enter__(self) -> PMem:
        p = self.pmem
        if p._group_depth == 0:
            sp = _OBS.span("pmem.group_commit")
            if sp:
                self._span = sp
                self._c0 = p.counters.snapshot()
                sp.__enter__()
        p._group_depth += 1
        return p

    def __exit__(self, exc_type, exc, tb) -> bool:
        p = self.pmem
        p._group_depth -= 1
        if p._group_depth == 0:
            if exc_type is None:
                p._close_group()
            else:
                p._abandon_group()
            sp = self._span
            if sp:
                d = p.counters.delta(self._c0)
                sp.set(stores=d.stores, loads=d.loads, clwb=d.clwb,
                       fence=d.fence, lines_touched=d.lines_touched,
                       aborted=exc_type is not None)
                sp.__exit__(None, None, None)
                self._span = None
        return False


def measure_op(pmem: PMem, fn: Callable[[], object]
               ) -> Tuple[object, OpCounters]:
    """Run ``fn`` and return (its result, the op's counters)."""
    start = pmem.begin_op()
    result = fn()
    return result, pmem.end_op(start)


def count_stores(pmem: PMem, fn: Callable[[], object]) -> int:
    """Run ``fn`` and return how many atomic stores it made."""
    start = pmem.counters.stores
    fn()
    return pmem.counters.stores - start
