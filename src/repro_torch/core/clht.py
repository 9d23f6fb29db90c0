"""P-CLHT — persistent Cache-Line Hash Table (RECIPE Condition #1).

Faithful to the paper's §6.2 conversion of CLHT-LB:

* each bucket is exactly one cache line: 3 key/value pairs + a chain
  pointer (``[k0,k1,k2, v0,v1,v2, next, pad]`` = 8 words = 64 B);
* readers are non-blocking and use the CLHT *atomic snapshot* (read
  key, read value, re-read key);
* writers lock the bucket, then commit via a single 8-byte atomic
  store — value first (persisted), then key (the commit point);
* deletes commit by atomically storing 0 to the key word;
* re-hashing is copy-on-write into a fresh table followed by a single
  atomic swap of the table pointer in the superblock.

Conversion action (#1): cache-line flush + fence after each store, with
the paper's optimization that stores preceding the final atomic commit
store may be persisted with one flush of their region before the
commit.  Common-case insert: 2 clwb + 2 fences (paper measures 1.5/2.5).

The port of ``repro.core.clht``: the PM-side protocol is the
reference's, store for store, so tables, counters and crash images
match it bit for bit.  Batched lookups (``_kernel_lookup``) probe a
snapshot held on the index's device with the chained probe kernel.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.clht_probe import snapshot_lookup
from ..kernels.partition import mix64_ref
from ..kernels.probe import fp64
from .conditions import Condition, ConversionSpec, RecipeIndex, register
from .pmem import NULL, PMem, Region

SLOTS = 3
BUCKET_WORDS = 8
HDR_WORDS = 8  # header line: [n_buckets, overflow_cursor, ...]
MAX_CHAIN = 4  # chain length that triggers a resize

SPEC = register(ConversionSpec(
    name="P-CLHT", structure="hash table", reader="non-blocking",
    writer="blocking", non_smo=Condition.ATOMIC_STORE,
    smo=Condition.ATOMIC_STORE,
    notes="CoW rehash + atomic table-pointer swap; 30 LOC in the paper",
))


_M64 = (1 << 64) - 1


def _mix(key: int) -> int:
    """splitmix64 finalizer — the multiplicative hash used everywhere."""
    z = (int(key) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class PCLHT(RecipeIndex):
    ORDERED = False
    spec = SPEC

    def __init__(self, pmem: PMem, n_buckets: int = 64, grow: bool = True,
                 name: str = "clht", device=None):
        super().__init__(pmem, device)
        self.grow = grow
        self.name = name
        self._region_prefixes = (f"{name}.",)
        existing = pmem.find(f"{name}.super")
        if existing is not None:
            self.super = existing  # attach (restart): no reinit needed
            return
        self.super = pmem.alloc(f"{name}.super", 8)
        table = self._new_table(n_buckets)
        pmem.store(self.super, 0, table.rid)
        pmem.persist_region(self.super)

    # ------------------------------------------------------------------
    # table layout helpers
    # ------------------------------------------------------------------
    def _new_table(self, n_buckets: int) -> Region:
        # half the region again as overflow-bucket arena
        n_overflow = max(8, n_buckets // 2)
        words = HDR_WORDS + (n_buckets + n_overflow) * BUCKET_WORDS
        t = self.pmem.alloc(f"{self.name}.table[{n_buckets}]", words)
        self.pmem.store(t, 0, n_buckets)
        self.pmem.store(t, 1, HDR_WORDS + n_buckets * BUCKET_WORDS)  # overflow cursor
        self.pmem.persist_region(t)
        return t

    def _table(self) -> Region:
        rid = self.pmem.load(self.super, 0)
        return self.pmem.regions[rid]

    def _bucket_off(self, t: Region, key: int) -> int:
        n = self.pmem.load(t, 0)
        return HDR_WORDS + (_mix(key) % n) * BUCKET_WORDS

    def _alloc_overflow(self, t: Region) -> Optional[int]:
        cur = self.pmem.load(t, 1)
        if cur + BUCKET_WORDS > t.n_words:
            return None
        # The cursor bump is not itself a commit point: an allocated but
        # never-linked bucket is unreachable garbage (RECIPE assumes GC).
        self.pmem.store(t, 1, cur + BUCKET_WORDS)
        self.pmem.persist(t, 1)
        return cur

    # ------------------------------------------------------------------
    # reads — non-blocking, atomic snapshot
    # ------------------------------------------------------------------
    def lookup(self, key: int) -> Optional[int]:
        assert key != NULL
        t = self._table()
        off = self._bucket_off(t, key)
        while off != NULL:
            for s in range(SLOTS):
                k1 = self.pmem.load(t, off + s)
                if k1 == key:
                    v = self.pmem.load(t, off + SLOTS + s)
                    k2 = self.pmem.load(t, off + s)  # atomic snapshot re-check
                    if k2 == key:
                        return v
            off = self.pmem.load(t, off + 6)
        return None

    # ------------------------------------------------------------------
    # writes — bucket-locked, single-atomic-store commit (Condition #1)
    # ------------------------------------------------------------------
    def insert(self, key: int, value: int) -> bool:
        assert key != NULL
        self._bump_epoch()  # batched readers must re-snapshot
        while True:
            status = self._insert_once(key, value)
            if status == "rehash":
                self._rehash()
                continue
            if status == "rehash_done_true":
                self._rehash()
                return True
            return status == "true"

    def _insert_once(self, key: int, value: int) -> str:
        # writers take the resize lock shared; rehash takes it exclusive
        self.pmem.lock_shared(self.super, 0)
        try:
            t = self._table()
            head = self._bucket_off(t, key)
            self.pmem.lock(t, head)
            try:
                off, chain_len = head, 1
                while True:
                    for s in range(SLOTS):
                        if self.pmem.load(t, off + s) == key:
                            return "false"  # CLHT insert fails on existing key
                    nxt = self.pmem.load(t, off + 6)
                    if nxt == NULL:
                        break
                    off, chain_len = nxt, chain_len + 1
                # find an empty slot in the chain
                slot = self._find_empty(t, head)
                if slot is not None:
                    boff, s = slot
                    # value first (persist), then the atomic key store
                    self.pmem.store(t, boff + SLOTS + s, value)
                    self.pmem.clwb(t, boff + SLOTS + s)
                    self.pmem.fence()
                    self.pmem.store(t, boff + s, key)
                    self.pmem.clwb(t, boff + s)
                    self.pmem.fence()
                    if chain_len > MAX_CHAIN and self.grow:
                        return "rehash_done_true"
                    return "true"
                # chain exhausted: link a fresh overflow bucket
                new_off = self._alloc_overflow(t)
                if new_off is None:
                    return "rehash"
                self.pmem.store(t, new_off + SLOTS + 0, value)
                self.pmem.store(t, new_off + 0, key)
                self.pmem.flush_range(t, new_off, new_off + BUCKET_WORDS)
                self.pmem.fence()
                # commit point: single atomic store of the chain pointer
                self.pmem.store(t, off + 6, new_off)
                self.pmem.clwb(t, off + 6)
                self.pmem.fence()
                if chain_len + 1 > MAX_CHAIN and self.grow:
                    return "rehash_done_true"
                return "true"
            finally:
                self.pmem.unlock(t, head)
        finally:
            self.pmem.unlock_shared(self.super, 0)

    def _find_empty(self, t: Region, head: int) -> Optional[Tuple[int, int]]:
        off = head
        while off != NULL:
            for s in range(SLOTS):
                if self.pmem.load(t, off + s) == NULL:
                    return off, s
            off = self.pmem.load(t, off + 6)
        return None

    def update(self, key: int, value: int) -> bool:
        """Native update: probe the chain for the key and commit the new
        value with a single 8-byte atomic store to the value word — the
        CLHT atomic snapshot (key, value, key re-read) makes a torn
        view impossible, so readers see the old or the new value.
        Overwriting with the current value is a no-op that performs no
        stores and leaves every snapshot epoch valid; absent keys fall
        through to insert semantics."""
        assert key != NULL
        self.pmem.lock_shared(self.super, 0)
        try:
            t = self._table()
            head = self._bucket_off(t, key)
            self.pmem.lock(t, head)
            try:
                off = head
                while off != NULL:
                    for s in range(SLOTS):
                        if self.pmem.load(t, off + s) == key:
                            if self.pmem.load(t, off + SLOTS + s) == value:
                                return True  # no-op overwrite
                            self._bump_epoch()
                            self.pmem.store(t, off + SLOTS + s, value)
                            self.pmem.clwb(t, off + SLOTS + s)
                            self.pmem.fence()
                            return True
                    off = self.pmem.load(t, off + 6)
            finally:
                self.pmem.unlock(t, head)
        finally:
            self.pmem.unlock_shared(self.super, 0)
        return self.insert(key, value)

    def delete(self, key: int) -> bool:
        self._bump_epoch()
        self.pmem.lock_shared(self.super, 0)
        try:
            t = self._table()
            head = self._bucket_off(t, key)
            self.pmem.lock(t, head)
            try:
                off = head
                while off != NULL:
                    for s in range(SLOTS):
                        if self.pmem.load(t, off + s) == key:
                            # commit: atomically store 0 to the key word
                            self.pmem.store(t, off + s, NULL)
                            self.pmem.clwb(t, off + s)
                            self.pmem.fence()
                            return True
                    off = self.pmem.load(t, off + 6)
                return False
            finally:
                self.pmem.unlock(t, head)
        finally:
            self.pmem.unlock_shared(self.super, 0)

    # ------------------------------------------------------------------
    # sharded batched writes (_write_batch wave shard runs)
    # ------------------------------------------------------------------
    def _apply_shard_run(self, ops: Sequence[Tuple[str, int, int]],
                         positions: Sequence[int], results: List) -> None:
        """Vectorized shard-run fast path: one shared resize-lock
        acquisition and one vectorized bucket hash for the whole run;
        each op then walks its chain with bulk line loads (counted like
        the scalar walk) and commits with the *exact* scalar store
        protocol — value word first, then the single atomic key /
        tombstone store, flushes riding the enclosing group-commit
        epoch.  Ops needing an overflow link or a rehash defer to the
        scalar path; epochs bump only on actual mutation."""
        pmem = self.pmem
        rehash_after = False
        i, n_ops = 0, len(positions)
        # hash once per run: the bucket is hash % n, so only the cheap
        # vectorized mod repeats when a deferral swapped the table
        hashes = mix64_ref(np.fromiter((ops[p][1] for p in positions),
                                       np.int64, n_ops))
        while i < n_ops:
            # fast section: hold the resize lock shared across the run;
            # an op needing the scalar path (rehash) breaks out so the
            # scalar op runs lock-free *in order* — same-key op history
            # must be preserved
            deferred = None
            pmem.lock_shared(self.super, 0)
            try:
                t = self._table()
                n = pmem.load(t, 0)
                buckets = (hashes[i:] % np.uint64(n)).astype(np.int64)
                for head_b in buckets.tolist():
                    pos = positions[i]
                    kind, key, value = ops[pos]
                    head = HDR_WORDS + head_b * BUCKET_WORDS
                    pmem.lock(t, head)
                    try:
                        r = self._run_one(t, head, kind, int(key),
                                          int(value))
                    finally:
                        pmem.unlock(t, head)
                    if r is None:
                        deferred = pos
                        break
                    if r == "rehash_done_true":
                        results[pos] = True
                        rehash_after = True
                    else:
                        results[pos] = r
                    i += 1
            finally:
                pmem.unlock_shared(self.super, 0)
            if deferred is not None:
                kind, key, value = ops[deferred]
                results[deferred] = self._apply_write(kind, int(key),
                                                      int(value))
                i += 1
        # the growth trigger fired during the run: rehash once at the
        # end (rehash preserves the key→value mapping, so deferring it
        # past the remaining ops cannot change any result)
        if rehash_after and self.grow:
            self._rehash()

    def _run_one(self, t: Region, head: int, kind: str, key: int,
                 value: int):
        """One op against its (locked) bucket chain via bulk line loads.
        Returns the op result, 'rehash_done_true' (inserted, chain long
        enough to grow), or None to defer to the scalar path (rehash)."""
        pmem = self.pmem
        off, last, chain_len = head, head, 0
        empty = None
        while off != NULL:
            w = pmem.load_bulk(t, off, BUCKET_WORDS).tolist()
            last, chain_len = off, chain_len + 1
            for s in range(SLOTS):
                if w[s] == key:
                    if kind == "insert":
                        return False  # CLHT insert fails on existing key
                    if kind == "delete":
                        self._bump_epoch()
                        pmem.store(t, off + s, NULL)  # atomic commit
                        pmem.clwb(t, off + s)
                        pmem.fence()
                        return True
                    # update: atomic value-word store (no-op elided)
                    if w[SLOTS + s] == value:
                        return True
                    self._bump_epoch()
                    pmem.store(t, off + SLOTS + s, value)
                    pmem.clwb(t, off + SLOTS + s)
                    pmem.fence()
                    return True
                if empty is None and w[s] == NULL:
                    empty = (off, s)
            off = w[6]
        if kind == "delete":
            return False  # absent: no store, no epoch bump
        if empty is not None:
            boff, s = empty
            # the scalar commit protocol: value first, then the atomic key
            self._bump_epoch()
            pmem.store(t, boff + SLOTS + s, value)
            pmem.clwb(t, boff + SLOTS + s)
            pmem.fence()
            pmem.store(t, boff + s, key)
            pmem.clwb(t, boff + s)
            pmem.fence()
            if chain_len > MAX_CHAIN and self.grow:
                return "rehash_done_true"
            return True
        # chain exhausted: link a fresh overflow bucket (the scalar
        # protocol — bucket persisted, then one atomic chain-pointer
        # store commits it)
        new_off = self._alloc_overflow(t)
        if new_off is None:
            return None  # arena full: the scalar rehash path
        self._bump_epoch()
        pmem.store(t, new_off + SLOTS + 0, value)
        pmem.store(t, new_off + 0, key)
        pmem.flush_range(t, new_off, new_off + BUCKET_WORDS)
        pmem.fence()
        pmem.store(t, last + 6, new_off)  # commit: atomic chain pointer
        pmem.clwb(t, last + 6)
        pmem.fence()
        if chain_len + 1 > MAX_CHAIN and self.grow:
            return "rehash_done_true"
        return True

    # ------------------------------------------------------------------
    # SMO: copy-on-write rehash, atomic table swap (Condition #1)
    # ------------------------------------------------------------------
    def _rehash(self, expect_rid: Optional[int] = None) -> None:
        self._bump_epoch()  # the table pointer is about to move
        self.pmem.lock_excl(self.super, 0)
        try:
            old = self._table()
            if expect_rid is not None and old.rid != expect_rid:
                return  # another writer already resized
            n_old = self.pmem.load(old, 0)
            new = self._new_table(n_old * 2)
            for key, value in self._items(old):
                self._raw_insert(new, key, value)
            # persist the entire new table *before* the commit point
            self.pmem.persist_region(new)
            # commit point: single atomic store of the table pointer
            self.pmem.store(self.super, 0, new.rid)
            self.pmem.clwb(self.super, 0)
            self.pmem.fence()
            self.pmem.free(old)  # unreachable; GC reclaims
        finally:
            self.pmem.unlock(self.super, 0)

    def _raw_insert(self, t: Region, key: int, value: int) -> None:
        """Insert into a private (not yet published) table: no fences."""
        off = HDR_WORDS + (_mix(key) % self.pmem.load(t, 0)) * BUCKET_WORDS
        while True:
            for s in range(SLOTS):
                if self.pmem.load(t, off + s) == NULL:
                    self.pmem.store(t, off + SLOTS + s, value)
                    self.pmem.store(t, off + s, key)
                    return
            nxt = self.pmem.load(t, off + 6)
            if nxt == NULL:
                new_off = self._alloc_overflow(t)
                if new_off is None:  # overflow arena full: grow recursively
                    raise MemoryError("overflow arena exhausted during rehash")
                self.pmem.store(t, off + 6, new_off)
                nxt = new_off
            off = nxt

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def _items(self, t: Region) -> Iterator[Tuple[int, int]]:
        n = self.pmem.load(t, 0)
        for b in range(n):
            off = HDR_WORDS + b * BUCKET_WORDS
            while off != NULL:
                for s in range(SLOTS):
                    k = self.pmem.load(t, off + s)
                    if k != NULL:
                        yield k, self.pmem.load(t, off + SLOTS + s)
                off = self.pmem.load(t, off + 6)

    def keys(self) -> Iterator[int]:
        for k, _ in self._items(self._table()):
            yield k

    def items(self) -> Iterator[Tuple[int, int]]:
        return self._items(self._table())

    def check_invariants(self) -> None:
        seen = {}
        for k, v in self._items(self._table()):
            assert k not in seen, f"duplicate key {k} in table"
            seen[k] = v

    # ------------------------------------------------------------------
    # data-plane export: dense arrays for the probe kernel
    # ------------------------------------------------------------------
    def export_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     int, np.ndarray]:
        """(keys, vals, next) bucket-major views + n_buckets + the
        per-slot fingerprint lane (``fp64`` of each slot's key,
        FP_EMPTY=0 on empty slots), for batched lookups.  Layout
        matches kernels/clht_probe."""
        t = self._table()
        n = self.pmem.load(t, 0)
        total = (t.n_words - HDR_WORDS) // BUCKET_WORDS
        base = t.cache[HDR_WORDS:HDR_WORDS + total * BUCKET_WORDS].reshape(total, BUCKET_WORDS)
        keys = base[:, 0:SLOTS].copy()
        vals = base[:, SLOTS:2 * SLOTS].copy()
        nxt = base[:, 6].copy()
        # chain pointers are word offsets; convert to bucket indices (-1 = none)
        nxt = np.where(nxt == NULL, -1, (nxt - HDR_WORDS) // BUCKET_WORDS)
        return keys, vals, nxt, n, fp64(keys)

    def _kernel_lookup(self, snapshot, queries):
        """The device probe path: bit-identical to scalar ``lookup`` —
        each query walks its whole overflow chain, the export's
        fingerprint lane filters candidates, and full 64-bit keys are
        compared on fingerprint hits (see kernels/clht_probe)."""
        return snapshot_lookup(snapshot, queries, device=self.device,
                               fingerprints=self.fingerprints,
                               stats=self.probe_stats)
