"""Level hashing baseline (Zuo et al., OSDI'18) — the second hand-crafted
PM hash table in RECIPE's §7.2 comparison.

Two-level structure: a top level of N buckets and a bottom level of N/2
buckets; every key has two candidate top buckets (two hash functions)
and each top bucket shares a bottom bucket with its neighbor.  Its
two-level probing touches non-contiguous cache lines, which is exactly
the extra-LLC-miss behavior the paper's Table 4 measures — our
lines-touched counter reproduces the trend.  Resizing rehashes the
bottom level into a new top level (cost amortized).

The port of ``repro.core.baselines.level_hashing``: the PM-side
protocol is the reference's, store for store; batched lookups search
the sorted run of live pairs held on the index's device
(``kernels/scan``).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from ..arena import Arena
from ..conditions import (Condition, ConversionSpec, RecipeIndex, register,
                          tracks_epoch)
from ..pmem import NULL, PMem
from ...kernels.probe.fingerprint import fp64
from ...kernels.scan import snapshot_lookup

SLOTS = 4
BUCKET_WORDS = 8  # 4 (k,v) pairs

SPEC = register(ConversionSpec(
    name="LevelHashing", structure="hash table (hand-crafted PM)",
    reader="non-blocking", writer="blocking",
    non_smo=Condition.ATOMIC_STORE, smo=Condition.ATOMIC_STORE,
    notes="baseline",
))

_M64 = (1 << 64) - 1


def _h(key: int, salt: int) -> int:
    z = (int(key) * 0x9E3779B97F4A7C15 + salt * 0xD1B54A32D192ED03) & _M64
    z = ((z ^ (z >> 29)) * 0xBF58476D1CE4E5B9) & _M64
    return (z ^ (z >> 32)) & _M64


class LevelHashing(RecipeIndex):
    ORDERED = False
    spec = SPEC

    def __init__(self, pmem: PMem, n_top: int = 16, device=None):
        super().__init__(pmem, device)
        self.arena = Arena(pmem, "level")
        self._region_prefixes = ("level.",)
        self.super = pmem.alloc("level.super", 8)  # [meta_ptr]
        self._build(n_top)

    def volatile_state(self) -> dict:
        return {"cursor": self.arena._cursor,
                "segments": list(self.arena.segments)}

    def set_volatile_state(self, state: dict) -> None:
        self.arena._cursor = state["cursor"]
        self.arena.segments = list(state["segments"])

    def _build(self, n_top: int) -> None:
        a = self.arena
        top = a.alloc(n_top * BUCKET_WORDS)
        bot = a.alloc(max(1, n_top // 2) * BUCKET_WORDS)
        a.flush_range(top, n_top * BUCKET_WORDS)
        a.flush_range(bot, max(1, n_top // 2) * BUCKET_WORDS)
        # meta object embeds the triple; published by ONE pointer store
        meta = a.alloc(8)
        a.store(meta, top)
        a.store(meta + 1, n_top)
        a.store(meta + 2, bot)
        a.flush_range(meta, 8)
        a.fence()
        self.pmem.store(self.super, 0, meta)
        self.pmem.persist_region(self.super)

    def _tables(self):
        meta = self.pmem.load(self.super, 0)
        a = self.arena
        return a.load(meta), a.load(meta + 1), a.load(meta + 2)

    def _candidates(self, key: int):
        top, n, bot = self._tables()
        i1, i2 = _h(key, 1) % n, _h(key, 2) % n
        yield top + i1 * BUCKET_WORDS
        yield top + i2 * BUCKET_WORDS
        nb = max(1, n // 2)
        yield bot + (i1 % nb) * BUCKET_WORDS
        yield bot + (i2 % nb) * BUCKET_WORDS

    def lookup(self, key: int) -> Optional[int]:
        a = self.arena
        for b in self._candidates(key):
            for s in range(SLOTS):
                if a.load(b + 2 * s) == key:
                    return a.load(b + 2 * s + 1)
        return None

    @tracks_epoch
    def insert(self, key: int, value: int) -> bool:
        assert key != NULL
        a = self.arena
        while True:
            if self.lookup(key) is not None:
                return False
            for b in self._candidates(key):
                a.lock(b)
                try:
                    for s in range(SLOTS):
                        if a.load(b + 2 * s) == NULL:
                            a.store(b + 2 * s + 1, value)
                            a.clwb(b + 2 * s + 1)
                            a.fence()
                            a.store(b + 2 * s, key)
                            a.clwb(b + 2 * s)
                            a.fence()
                            return True
                finally:
                    a.unlock(b)
            self._resize()

    @tracks_epoch
    def update(self, key: int, value: int) -> bool:
        """In-place value update: one counted store + clwb + fence on
        the value word of whichever candidate bucket holds the key.
        Absent keys fall through to ``insert``."""
        assert key != NULL
        a = self.arena
        for b in self._candidates(key):
            a.lock(b)
            try:
                for s in range(SLOTS):
                    if a.load(b + 2 * s) == key:
                        if a.load(b + 2 * s + 1) != value:
                            a.store(b + 2 * s + 1, value)
                            a.clwb(b + 2 * s + 1)
                            a.fence()
                        return True
            finally:
                a.unlock(b)
        return self.insert(key, value)  # absent -> insert path

    @tracks_epoch
    def delete(self, key: int) -> bool:
        a = self.arena
        for b in self._candidates(key):
            a.lock(b)
            try:
                for s in range(SLOTS):
                    if a.load(b + 2 * s) == key:
                        a.store(b + 2 * s, NULL)
                        a.clwb(b + 2 * s)
                        a.fence()
                        return True
            finally:
                a.unlock(b)
        return False

    def _resize(self) -> None:
        """CoW into a doubled structure, atomic superblock swap."""
        items = list(self.items())
        a = self.arena
        _, n, _ = self._tables()
        n2 = n * 2
        top = a.alloc(n2 * BUCKET_WORDS)
        bot = a.alloc(max(1, n2 // 2) * BUCKET_WORDS)
        placed = set()
        for k, v in items:
            i1, i2 = _h(k, 1) % n2, _h(k, 2) % n2
            nb = max(1, n2 // 2)
            for b in (top + i1 * BUCKET_WORDS, top + i2 * BUCKET_WORDS,
                      bot + (i1 % nb) * BUCKET_WORDS,
                      bot + (i2 % nb) * BUCKET_WORDS):
                done = False
                for s in range(SLOTS):
                    if a.load(b + 2 * s) == NULL:
                        a.store(b + 2 * s + 1, v)
                        a.store(b + 2 * s, k)
                        done = True
                        break
                if done:
                    placed.add(k)
                    break
            else:
                raise MemoryError("level-hash resize overflow")
        a.flush_range(top, n2 * BUCKET_WORDS)
        a.flush_range(bot, max(1, n2 // 2) * BUCKET_WORDS)
        meta = a.alloc(8)
        a.store(meta, top)
        a.store(meta + 1, n2)
        a.store(meta + 2, bot)
        a.flush_range(meta, 8)
        a.fence()
        self.pmem.store(self.super, 0, meta)
        self.pmem.persist(self.super, 0)

    def items(self) -> Iterator[Tuple[int, int]]:
        a = self.arena
        top, n, bot = self._tables()
        for base, count in ((top, n), (bot, max(1, n // 2))):
            for i in range(count):
                b = base + i * BUCKET_WORDS
                for s in range(SLOTS):
                    k = a.load(b + 2 * s)
                    if k != NULL:
                        yield k, a.load(b + 2 * s + 1)

    def keys(self) -> Iterator[int]:
        for k, _ in self.items():
            yield k

    # ------------------------------------------------------------------
    # data-plane export: plan/execute batched read path (same shape as
    # the CCEH port — with this, all eight indexes of the paper's
    # comparison sit on the plan surface and in the fingerprint A/B)
    # ------------------------------------------------------------------
    def export_arrays(self) -> Optional[dict]:
        """Sorted run of the live (key, value) pairs plus the ``fps``
        fingerprint lane.  Level hashing has no order of its own, but
        the shared kernels/scan sorted-run probe only needs *a*
        deterministic order, and ``items`` applies the reader's
        visibility rules — so batched lookups stay bit-identical to
        scalar ``lookup``."""
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
        """The export walks both levels once plus an O(n log n) sort;
        scale the stale-snapshot floor with the live entry count."""
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
