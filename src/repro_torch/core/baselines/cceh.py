"""CCEH — Cacheline-Conscious Extendible Hashing baseline (Nam et al.,
FAST'19), the hand-crafted PM hash table RECIPE's §7.2 compares against.

Structure: a *directory* of segment pointers indexed by the top
``global_depth`` hash bits; each segment is an array of cache-line
buckets probed by the low bits, with a ``local_depth``.  A full segment
*splits* (copy-on-write into two segments, directory entries updated);
when ``local_depth == global_depth`` the directory must *double*.

The paper (§3) reports two crash bugs in directory doubling — three
pieces of metadata (directory pointer, width, global depth) are updated
non-atomically, so a crash in between leaves insertions or recovery
looping forever.  We reproduce the bug class behind ``fixed=False``:
the doubling stores the new directory pointer and the new depth as two
separately-persisted stores; a crash between them leaves a directory
whose size disagrees with the depth, which our operations *detect* and
surface as a stall (a real CCEH would spin forever — we raise instead
so the crash harness can count it).  ``fixed=True`` commits the
doubling RECIPE-style: the new directory object embeds its own depth
and becomes live via one atomic superblock pointer swap.

The port of ``repro.core.baselines.cceh``: the PM-side
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

SLOTS_PER_BUCKET = 4
BUCKET_WORDS = 8  # [k0..k3][v0..v3] interleaved as k,v pairs? keep flat
BUCKETS_PER_SEG = 16
# segment: [local_depth, pad*7][buckets: 16 * 8 words (4 k/v pairs)]
SEG_WORDS = 8 + BUCKETS_PER_SEG * BUCKET_WORDS
# directory object: [depth, n_entries, pad*6][segment ptrs ...]
DIR_HDR = 8

SPEC = register(ConversionSpec(
    name="CCEH", structure="hash table (hand-crafted PM)",
    reader="non-blocking", writer="blocking",
    non_smo=Condition.ATOMIC_STORE, smo=Condition.WRITERS_DONT_FIX,
    notes="baseline; directory-doubling bug behind fixed=False",
))

_M64 = (1 << 64) - 1


def _hash(key: int) -> int:
    z = (int(key) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class StallError(Exception):
    """Operation detected a permanently inconsistent directory (the
    real implementation would loop forever here)."""


class CCEH(RecipeIndex):
    ORDERED = False
    spec = SPEC

    def __init__(self, pmem: PMem, depth: int = 2, fixed: bool = True,
                 device=None):
        super().__init__(pmem, device)
        self.fixed = fixed
        self.arena = Arena(pmem, "cceh")
        self._region_prefixes = ("cceh.",)
        self.super = pmem.alloc("cceh.super", 8)
        # buggy-mode legacy layout keeps depth in a SEPARATE word from the
        # directory pointer (word1) — that's the unsafe pair
        d = self._new_dir(depth)
        pmem.store(self.super, 0, d)  # directory ptr
        pmem.store(self.super, 1, depth)  # global depth (legacy word)
        if fixed:
            pmem.persist_region(self.super)

    def volatile_state(self) -> dict:
        return {"cursor": self.arena._cursor,
                "segments": list(self.arena.segments)}

    def set_volatile_state(self, state: dict) -> None:
        self.arena._cursor = state["cursor"]
        self.arena.segments = list(state["segments"])

    # ------------------------------------------------------------------
    def _new_segment(self, local_depth: int) -> int:
        a = self.arena
        p = a.alloc(SEG_WORDS)
        a.store(p, local_depth)
        return p

    def _new_dir(self, depth: int) -> int:
        a = self.arena
        n = 1 << depth
        p = a.alloc(DIR_HDR + n)
        a.store(p, depth)
        a.store(p + 1, n)
        for i in range(n):
            a.store(p + DIR_HDR + i, NULL)
        # one initial segment shared by all entries
        seg = self._new_segment(0)
        a.flush_range(seg, SEG_WORDS)
        for i in range(n):
            a.store(p + DIR_HDR + i, seg)
        a.flush_range(p, DIR_HDR + n)
        a.fence()
        return p

    def _dir(self) -> Tuple[int, int]:
        """(dir_ptr, global_depth) with the buggy-mode inconsistency check."""
        d = self.pmem.load(self.super, 0)
        if self.fixed:
            return d, self.arena.load(d)  # depth embedded in the dir object
        depth = self.pmem.load(self.super, 1)  # legacy separate word
        if self.arena.load(d + 1) != (1 << depth):
            # directory size disagrees with global depth: the real CCEH
            # loops forever here (paper §3); we surface the stall
            raise StallError("directory width != 2^global_depth after crash")
        return d, depth

    def _seg_for(self, key: int) -> Tuple[int, int, int]:
        d, depth = self._dir()
        h = _hash(key)
        idx = h >> (64 - depth) if depth > 0 else 0
        seg = self.arena.load(d + DIR_HDR + idx)
        return d, idx, seg

    def _bucket_off(self, seg: int, key: int) -> int:
        h = _hash(key)
        return 8 + (h % BUCKETS_PER_SEG) * BUCKET_WORDS

    # ------------------------------------------------------------------
    def lookup(self, key: int) -> Optional[int]:
        a = self.arena
        _, _, seg = self._seg_for(key)
        off = self._bucket_off(seg, key)
        for s in range(SLOTS_PER_BUCKET):
            if a.load(seg + off + 2 * s) == key:
                return a.load(seg + off + 2 * s + 1)
        return None

    @tracks_epoch
    def insert(self, key: int, value: int) -> bool:
        assert key != NULL
        a = self.arena
        while True:
            d, idx, seg = self._seg_for(key)
            a.lock(seg)
            try:
                # re-validate: the segment may have split while we waited
                d2, idx2, seg2 = self._seg_for(key)
                if seg2 != seg:
                    continue
                off = self._bucket_off(seg, key)
                free = None
                for s in range(SLOTS_PER_BUCKET):
                    k = a.load(seg + off + 2 * s)
                    if k == key:
                        return False
                    if k == NULL and free is None:
                        free = s
                if free is not None:
                    # value first, then the atomic key store (commit)
                    a.store(seg + off + 2 * free + 1, value)
                    a.clwb(seg + off + 2 * free + 1)
                    a.fence()
                    a.store(seg + off + 2 * free, key)
                    a.clwb(seg + off + 2 * free)
                    a.fence()
                    return True
                self._split_segment(key)
            finally:
                a.unlock(seg)

    @tracks_epoch
    def update(self, key: int, value: int) -> bool:
        """In-place value update: one counted store + clwb + fence on
        the value word (the key word never moves, so readers always see
        old-or-new — Condition #1).  Falls through to ``insert`` when
        the key is absent, matching the scalar update contract."""
        assert key != NULL
        a = self.arena
        while True:
            _, _, seg = self._seg_for(key)
            a.lock(seg)
            try:
                _, _, seg2 = self._seg_for(key)
                if seg2 != seg:
                    continue
                off = self._bucket_off(seg, key)
                for s in range(SLOTS_PER_BUCKET):
                    if a.load(seg + off + 2 * s) == key:
                        vaddr = seg + off + 2 * s + 1
                        if a.load(vaddr) != value:
                            a.store(vaddr, value)
                            a.clwb(vaddr)
                            a.fence()
                        return True
            finally:
                a.unlock(seg)
            return self.insert(key, value)  # absent -> insert path

    @tracks_epoch
    def delete(self, key: int) -> bool:
        a = self.arena
        _, _, seg = self._seg_for(key)
        a.lock(seg)
        try:
            off = self._bucket_off(seg, key)
            for s in range(SLOTS_PER_BUCKET):
                if a.load(seg + off + 2 * s) == key:
                    a.store(seg + off + 2 * s, NULL)
                    a.clwb(seg + off + 2 * s)
                    a.fence()
                    return True
            return False
        finally:
            a.unlock(seg)

    # ------------------------------------------------------------------
    # segment split + directory doubling (the SMO with the famous bug)
    # ------------------------------------------------------------------
    def _split_segment(self, key: int) -> None:
        a = self.arena
        d, idx, seg = self._seg_for(key)
        local = a.load(seg)
        _, depth = self._dir()
        if local == depth:
            self._double_directory()
            d, idx, seg = self._seg_for(key)
            local = a.load(seg)
            _, depth = self._dir()
        # copy-on-write split into two segments at local_depth+1
        s0 = self._new_segment(local + 1)
        s1 = self._new_segment(local + 1)
        for b in range(BUCKETS_PER_SEG):
            off = 8 + b * BUCKET_WORDS
            for s in range(SLOTS_PER_BUCKET):
                k = a.load(seg + off + 2 * s)
                if k == NULL:
                    continue
                v = a.load(seg + off + 2 * s + 1)
                h = _hash(k)
                bit = (h >> (64 - (local + 1))) & 1
                tgt = s1 if bit else s0
                toff = self._bucket_off(tgt, k)
                for t in range(SLOTS_PER_BUCKET):
                    if a.load(tgt + toff + 2 * t) == NULL:
                        a.store(tgt + toff + 2 * t + 1, v)
                        a.store(tgt + toff + 2 * t, k)
                        break
                else:
                    # cascading overflow: extremely unlikely at these sizes;
                    # production CCEH probes neighbor buckets
                    raise MemoryError("segment split overflow")
        a.flush_range(s0, SEG_WORDS)
        a.flush_range(s1, SEG_WORDS)
        a.fence()
        # update every directory entry that pointed at the old segment
        n = a.load(d + 1)
        for i in range(n):
            if a.load(d + DIR_HDR + i) == seg:
                h_prefix = i >> (depth - (local + 1)) if depth > local else i
                bit = h_prefix & 1
                a.store(d + DIR_HDR + i, s1 if bit else s0)
                a.clwb(d + DIR_HDR + i)
        a.fence()

    def _double_directory(self) -> None:
        a = self.arena
        d, depth = self._dir()
        n = a.load(d + 1)
        new_depth = depth + 1
        nd = a.alloc(DIR_HDR + 2 * n)
        a.store(nd, new_depth)
        a.store(nd + 1, 2 * n)
        for i in range(n):
            seg = a.load(d + DIR_HDR + i)
            a.store(nd + DIR_HDR + 2 * i, seg)
            a.store(nd + DIR_HDR + 2 * i + 1, seg)
        a.flush_range(nd, DIR_HDR + 2 * n)
        a.fence()
        if self.fixed:
            # RECIPE-style Condition #1 commit: the new directory embeds
            # its own depth; one atomic pointer swap publishes both
            self.pmem.store(self.super, 0, nd)
            self.pmem.persist(self.super, 0)
            self.pmem.store(self.super, 1, new_depth)  # legacy mirror
            self.pmem.persist(self.super, 1)
        else:
            # THE BUG (paper §3): pointer and depth are two separately
            # persisted stores — a crash in between strands the table
            self.pmem.store(self.super, 0, nd)
            self.pmem.persist(self.super, 0)
            self.pmem.store(self.super, 1, new_depth)
            self.pmem.persist(self.super, 1)

    # ------------------------------------------------------------------
    def items(self) -> Iterator[Tuple[int, int]]:
        a = self.arena
        d, depth = self._dir()
        n = a.load(d + 1)
        seen = set()
        for i in range(n):
            seg = a.load(d + DIR_HDR + i)
            if seg in seen or seg == NULL:
                continue
            seen.add(seg)
            for b in range(BUCKETS_PER_SEG):
                off = 8 + b * BUCKET_WORDS
                for s in range(SLOTS_PER_BUCKET):
                    k = a.load(seg + off + 2 * s)
                    if k != NULL:
                        yield k, a.load(seg + off + 2 * s + 1)

    def keys(self) -> Iterator[int]:
        for k, _ in self.items():
            yield k

    # ------------------------------------------------------------------
    # data-plane export: plan/execute batched read path (the shard-
    # scaling sweep's head-to-head comparator needs CCEH on the same
    # surface as the converted indexes)
    # ------------------------------------------------------------------
    def export_arrays(self) -> Optional[dict]:
        """Sorted run of the live (key, value) pairs.  CCEH has no
        sorted iteration of its own (it's a hash table), but the shared
        kernels/scan sorted-run probe only needs *a* deterministic
        order, and ``items`` applies the reader's visibility rules —
        so batched lookups stay bit-identical to scalar ``lookup``."""
        items = sorted(self.items())
        self._n_entries_hint = len(items)
        if not items:
            return None
        keys = np.fromiter((k for k, _ in items), np.int64, len(items))
        vals = np.fromiter((v for _, v in items), np.int64, len(items))
        return {"keys": keys, "vals": vals, "fps": fp64(keys)}

    _n_entries_hint = 0
    _MIN_REBUILD_BATCH = 64

    def _rebuild_floor(self) -> int:
        """The export walks every directory entry's segment once plus
        an O(n log n) sort; scale the floor with the live entry count
        like the tree indexes do."""
        return max(self._MIN_REBUILD_BATCH, self._n_entries_hint // 4)

    def _kernel_lookup(self, snapshot, queries):
        """Shared sorted-run kernel path (kernels/scan lower bound +
        equality), bit-identical to scalar ``lookup``."""
        if snapshot.arrays is None:  # empty table
            return None
        return snapshot_lookup(snapshot, queries, device=self.device,
                               fingerprints=self.fingerprints,
                               stats=self.probe_stats)

    def check_invariants(self) -> None:
        ks = list(self.keys())
        assert len(ks) == len(set(ks)), "duplicate keys"
