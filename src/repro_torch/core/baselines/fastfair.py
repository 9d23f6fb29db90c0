"""FAST & FAIR B+-tree baseline (Hwang et al., FAST'18) — the
hand-crafted PM ordered index RECIPE's §7.1 compares against.

FAST: inserts into sorted node arrays by shifting entries one 8-byte
atomic store at a time, flushing at cache-line boundaries; readers are
lock-free and tolerate the transient duplicates a mid-shift state
exposes.  FAIR: sibling pointers give lock-free range scans.

We reproduce the paper's two reported bug classes behind flags
(``fixed=False``), both re-found by our §5 crash/concurrency tests:

* ``BUG_LOST_KEY`` (design-level, §3): a writer that waited on a node
  lock does not re-check whether the node split in the meantime and
  inserts into the (now wrong) left node — the key lands below the
  sibling separator and is unreachable by readers.  The fix (confirmed
  by the FAST&FAIR authors) is B-link style high-key re-checking, as
  prior concurrency work (and our P-Masstree) does.
* ``BUG_SPLIT_PERSIST`` (implementation-level, §3/§7.5): the split
  persists the sibling *after* linking it, so a crash between the link
  and the flush leaves the right node's keys unreachable (data loss),
  matching the paper's split+merge crash loss.

Also reproduced (§7.5 durability finding): in buggy mode the initial
root allocation is not flushed — our durability audit flags it.

The port of ``repro.core.baselines.fastfair``: the PM-side
protocol is the reference's, store for store; batched lookups search
the sorted run of live pairs held on the index's device
(``kernels/scan``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..arena import Arena
from ..conditions import (Condition, ConversionSpec, RecipeIndex,
                          register, tracks_epoch)
from ..pmem import NULL, PMem
from ...kernels.probe.fingerprint import fp64
from ...kernels.scan import snapshot_lookup

CAP = 16
T_LEAF, T_INNER = 1, 2
# node: [type, next_sibling, high_key, leftmost_child, pad*4]
#       [keys[16]][vals_or_children[16]] = 40 words
NODE_WORDS = 8 + 2 * CAP
K0, V0 = 8, 8 + CAP
LEFTMOST = 3
INF = (1 << 63) - 1

SPEC = register(ConversionSpec(
    name="FAST&FAIR", structure="B+ tree (hand-crafted PM)",
    reader="non-blocking", writer="blocking",
    non_smo=Condition.ATOMIC_STORE, smo=Condition.WRITERS_DONT_FIX,
    notes="baseline; bugs behind fixed=False",
))


class FastFair(RecipeIndex):
    ORDERED = True
    SHARD_SCHEME = "prefix"  # shards are key ranges: one subtree family
    spec = SPEC

    def __init__(self, pmem: PMem, fixed: bool = True, device=None):
        super().__init__(pmem, device)
        self.fixed = fixed
        self.arena = Arena(pmem, "ff")
        self._region_prefixes = ("ff.",)
        self.super = pmem.alloc("ff.super", 8)
        root = self._new_node(T_LEAF, high_key=INF)
        if fixed:
            self.arena.flush_range(root, NODE_WORDS)
            self.arena.fence()
        pmem.store(self.super, 0, root)
        if fixed:
            pmem.persist_region(self.super)
        # buggy mode: root allocation never flushed (the §7.5 finding)

    def volatile_state(self) -> dict:
        return {"cursor": self.arena._cursor,
                "segments": list(self.arena.segments)}

    def set_volatile_state(self, state: dict) -> None:
        self.arena._cursor = state["cursor"]
        self.arena.segments = list(state["segments"])

    def _new_node(self, ntype: int, *, high_key: int) -> int:
        a = self.arena
        p = a.alloc(NODE_WORDS)
        a.store(p, ntype)
        a.store(p + 1, NULL)
        a.store(p + 2, high_key)
        a.store(p + LEFTMOST, NULL)
        for i in range(CAP):
            a.store(p + K0 + i, NULL)
        return p

    def _count(self, node: int) -> int:
        a = self.arena
        n = 0
        while n < CAP and a.load(node + K0 + n) != NULL:
            n += 1
        return n

    # ------------------------------------------------------------------
    # traversal
    # ------------------------------------------------------------------
    def _descend(self, key: int) -> List[int]:
        a = self.arena
        path: List[int] = []
        node = self.pmem.load(self.super, 0)
        seen = set()
        while True:
            while key >= a.load(node + 2) and a.load(node + 1) != NULL:
                nxt = a.load(node + 1)
                if nxt in seen:  # crash-corrupted sibling cycle (buggy mode)
                    break
                seen.add(nxt)
                node = nxt
            path.append(node)
            if a.load(node) == T_LEAF:
                return path
            child = a.load(node + LEFTMOST)
            for i in range(CAP):
                k = a.load(node + K0 + i)
                if k == NULL or key < k:
                    break
                c = a.load(node + V0 + i)
                if c != NULL:  # skip blanked duplicates (mid-shift state)
                    child = c
            if child == NULL:
                # dead end: reachable only when a crash destroyed a child
                # (buggy split-persist mode) — surface as a miss, not a hang
                return path
            node = child

    def lookup(self, key: int) -> Optional[int]:
        a = self.arena
        leaf = self._descend(key)[-1]
        seen = set()
        while True:
            if leaf in seen:  # corrupted chain cycle: give up (data loss)
                return None
            seen.add(leaf)
            for i in range(CAP):
                k = a.load(leaf + K0 + i)
                if k == NULL:
                    break
                if k == key:
                    v = a.load(leaf + V0 + i)
                    if v != NULL:  # first non-NULL match; mid-shift
                        return v  # duplicates carry NULL or stale-but-
                    # skipped values (FAST reader tolerance)
            if key >= a.load(leaf + 2) and a.load(leaf + 1) != NULL:
                leaf = a.load(leaf + 1)
                continue
            return None

    # ------------------------------------------------------------------
    # FAST insertion: atomic shift with per-store flush+fence
    # ------------------------------------------------------------------
    def _shift_insert(self, node: int, key: int, val: int, *,
                      kbase: int, vbase: int) -> None:
        a = self.arena
        n = self._count(node)
        i = n
        while i > 0 and a.load(node + kbase + i - 1) > key:
            # FAST order for right shifts: KEY first, then value.  Between
            # the stores slot i+1 reads as a duplicate of key[i] with a
            # stale value; ascending readers take the FIRST occurrence
            # (slot i, correct) and skip the duplicate — the exact
            # transient state FAST readers tolerate.
            a.store(node + kbase + i, a.load(node + kbase + i - 1))
            a.clwb(node + kbase + i)
            a.store(node + vbase + i, a.load(node + vbase + i - 1))
            a.clwb(node + vbase + i)
            a.fence()
            i -= 1
        # the insertion slot still holds a live duplicate of the pair
        # shifted out of it; three ordered atomic stores keep every
        # intermediate readable: blank the value (readers fall through
        # to the shifted copy), re-key (reads of the new key see
        # "absent"), then the value store commits the insert
        a.store(node + vbase + i, NULL)
        a.clwb(node + vbase + i)
        a.fence()
        a.store(node + kbase + i, key)
        a.clwb(node + kbase + i)
        a.fence()
        a.store(node + vbase + i, val)
        a.clwb(node + vbase + i)
        a.fence()

    @tracks_epoch
    def insert(self, key: int, value: int) -> bool:
        assert key != NULL and value != NULL
        a = self.arena
        while True:
            path = self._descend(key)
            leaf = path[-1]
            a.lock(leaf)
            try:
                if self.fixed:
                    # the authors' fix: re-check the high key under the lock
                    if key >= a.load(leaf + 2) and a.load(leaf + 1) != NULL:
                        continue
                # BUG_LOST_KEY: in buggy mode, no re-check — if the node
                # split while we waited for the lock, the key is inserted
                # into the wrong (left) node and becomes unreachable.
                if self._find_in_node(leaf, key) is not None:
                    return False
                if self._count(leaf) >= CAP:
                    self._split(path, leaf)
                    continue
                self._shift_insert(leaf, key, value, kbase=K0, vbase=V0)
                return True
            finally:
                a.unlock(leaf)

    def _find_in_node(self, node: int, key: int) -> Optional[int]:
        a = self.arena
        for i in range(CAP):
            k = a.load(node + K0 + i)
            if k == NULL:
                return None
            if k == key:
                return i
        return None

    @tracks_epoch
    def update(self, key: int, value: int) -> bool:
        """In-place value update: one counted store + clwb + fence on
        the value word.  Keys never move, so a reader sees old-or-new
        (the same single-word atomicity delete's tombstone relies on).
        Absent (or tombstoned) keys fall through to ``insert``."""
        assert key != NULL and value != NULL
        a = self.arena
        while True:
            path = self._descend(key)
            leaf = path[-1]
            a.lock(leaf)
            try:
                if self.fixed and key >= a.load(leaf + 2) \
                        and a.load(leaf + 1) != NULL:
                    continue
                i = self._find_in_node(leaf, key)
                if i is not None and a.load(leaf + V0 + i) != NULL:
                    if a.load(leaf + V0 + i) != value:
                        a.store(leaf + V0 + i, value)
                        a.clwb(leaf + V0 + i)
                        a.fence()
                    return True
            finally:
                a.unlock(leaf)
            return self.insert(key, value)  # absent -> insert path

    @tracks_epoch
    def delete(self, key: int) -> bool:
        a = self.arena
        while True:
            path = self._descend(key)
            leaf = path[-1]
            a.lock(leaf)
            try:
                if self.fixed and key >= a.load(leaf + 2) \
                        and a.load(leaf + 1) != NULL:
                    continue
                i = self._find_in_node(leaf, key)
                if i is None or a.load(leaf + V0 + i) == NULL:
                    return False
                # tombstone: one atomic NULL store to the value word —
                # a left-shift compaction tears key/value pairs mid-crash
                # (our sweep caught exactly that); compaction happens at
                # split time instead
                a.store(leaf + V0 + i, NULL)
                a.clwb(leaf + V0 + i)
                a.fence()
                return True
            finally:
                a.unlock(leaf)

    # ------------------------------------------------------------------
    # split
    # ------------------------------------------------------------------
    def _split(self, path: List[int], node: int) -> None:
        """Caller holds node's lock."""
        a = self.arena
        ntype = a.load(node)
        n = self._count(node)
        mid = n // 2
        sep = a.load(node + K0 + mid)
        sib = self._new_node(ntype, high_key=a.load(node + 2))
        a.store(sib + 1, a.load(node + 1))
        if ntype == T_LEAF:
            j = 0
            for i in range(mid, n):
                if a.load(node + V0 + i) == NULL:
                    continue  # compact tombstones into the new sibling
                a.store(sib + K0 + j, a.load(node + K0 + i))
                a.store(sib + V0 + j, a.load(node + V0 + i))
                j += 1
        else:
            a.store(sib + LEFTMOST, a.load(node + V0 + mid))
            for j, i in enumerate(range(mid + 1, n)):
                a.store(sib + K0 + j, a.load(node + K0 + i))
                a.store(sib + V0 + j, a.load(node + V0 + i))
        if self.fixed:
            # persist the sibling BEFORE making it reachable
            a.flush_range(sib, NODE_WORDS)
            a.fence()
        # link the sibling
        a.store(node + 1, sib)
        a.clwb(node + 1)
        a.fence()
        # BUG_SPLIT_PERSIST: buggy mode flushes the sibling only *after*
        # the link is persisted — a crash in between loses the right
        # node's keys (the paper's §7.5 data-loss finding)
        if not self.fixed:
            a.flush_range(sib, NODE_WORDS)
            a.fence()
        a.store(node + 2, sep)
        a.clwb(node + 2)
        a.fence()
        # truncate the left node
        for i in range(mid, n):
            a.store(node + K0 + i, NULL)
            a.clwb(node + K0 + i)
        a.fence()
        # parent insert
        if len(path) >= 2 and path[-1] == node:
            parent = path[-2]
            a.lock(parent)
            try:
                while True:
                    while sep >= a.load(parent + 2) \
                            and a.load(parent + 1) != NULL:
                        nxt = a.load(parent + 1)
                        a.unlock(parent)
                        parent = nxt
                        a.lock(parent)
                    if self._count(parent) < CAP:
                        self._shift_insert(parent, sep, sib,
                                           kbase=K0, vbase=V0)
                        break
                    # split the (locked) parent, then retry placement —
                    # the separator may belong in the new right node
                    self._split(path[:-1], parent)
            finally:
                a.unlock(parent)
        else:
            # root split
            new_root = self._new_node(T_INNER, high_key=INF)
            a.store(new_root + LEFTMOST, node)
            a.store(new_root + K0 + 0, sep)
            a.store(new_root + V0 + 0, sib)
            if self.fixed:
                a.flush_range(new_root, NODE_WORDS)
                a.fence()
            if self.pmem.load(self.super, 0) == node:
                self.pmem.store(self.super, 0, new_root)
                self.pmem.persist(self.super, 0)
            else:
                self._insert_inner(sep, sib)

    def _insert_inner(self, sep: int, sib: int) -> None:
        a = self.arena
        path = self._descend(sep)
        if len(path) < 2:
            return
        parent = path[-2]
        a.lock(parent)
        try:
            if self._find_in_node(parent, sep) is None \
                    and self._count(parent) < CAP:
                self._shift_insert(parent, sep, sib, kbase=K0, vbase=V0)
        finally:
            a.unlock(parent)

    # ------------------------------------------------------------------
    def items(self) -> Iterator[Tuple[int, int]]:
        a = self.arena
        node = self.pmem.load(self.super, 0)
        hops = 0
        while a.load(node) != T_LEAF:
            node = a.load(node + LEFTMOST)
            hops += 1
            if hops > 64:  # corrupted spine (buggy mode post-crash)
                return
        last = -1
        seen = set()
        while node != NULL:
            if node in seen:
                return  # corrupted sibling cycle
            seen.add(node)
            high = a.load(node + 2)
            for i in range(CAP):
                k = a.load(node + K0 + i)
                if k == NULL:
                    break
                v = a.load(node + V0 + i)
                if v != NULL and k < high and k > last:
                    yield k, v
                    last = k
            node = a.load(node + 1)


    def keys(self) -> Iterator[int]:
        for k, _ in self.items():
            yield k

    # ------------------------------------------------------------------
    # data-plane export: plan/execute batched read path (same shape as
    # the CCEH port — the adversarial matrix drives FAST&FAIR through
    # the identical kernels/scan sorted-run probe, and ORDERED=True
    # gives it batched scans via the base ``_scan_export`` for free)
    # ------------------------------------------------------------------
    def export_arrays(self) -> Optional[dict]:
        """Sorted run of the live (key, value) pairs.  ``items`` is the
        FAIR sibling walk with the reader's visibility rules (first
        non-NULL match, mid-shift duplicate skipping), so batched
        lookups stay bit-identical to scalar ``lookup``."""
        items = list(self.items())  # already ascending (leaf chain)
        self._n_entries_hint = len(items)
        if not items:
            return None
        keys = np.fromiter((k for k, _ in items), np.int64, len(items))
        vals = np.fromiter((v for _, v in items), np.int64, len(items))
        return {"keys": keys, "vals": vals, "fps": fp64(keys)}

    _n_entries_hint = 0
    _MIN_REBUILD_BATCH = 64

    def _rebuild_floor(self) -> int:
        """The export walks the whole leaf chain; scale the stale-
        snapshot floor with the live entry count like the tree
        conversions do."""
        return max(self._MIN_REBUILD_BATCH, self._n_entries_hint // 4)

    def _kernel_lookup(self, snapshot, queries):
        """Shared sorted-run kernel path (kernels/scan lower bound +
        equality), bit-identical to scalar ``lookup``."""
        if snapshot.arrays is None:  # empty tree
            return None
        return snapshot_lookup(snapshot, queries, device=self.device,
                               fingerprints=self.fingerprints,
                               stats=self.probe_stats)

    def range_query(self, key_lo: int, key_hi: int) -> List[Tuple[int, int]]:
        return [(k, v) for k, v in self.items() if key_lo <= k <= key_hi]

    def check_invariants(self) -> None:
        ks = list(self.keys())
        assert ks == sorted(ks)
        assert len(ks) == len(set(ks))
