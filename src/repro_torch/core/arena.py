"""Segmented PM arena: the persistent-memory allocator the indexes use.

RECIPE assumes a PM allocator whose unreachable objects are garbage
collected (§4.2) — the paper uses PMDK's libvmmalloc.  We provide the
equivalent: a bump allocator over fixed-size PM segments with a
mark-sweep GC driven by each index's reachability walker.

Pointers are global word indices; segment k covers
``[k*SEG_WORDS, (k+1)*SEG_WORDS)``.  Pointer 0 is NULL (the first 8
words of segment 0 are a reserved header line).  An allocation never
straddles segments, so a node's cache lines always live in one region.

A crash can leave the bump cursor ahead of the last *reachable*
allocation — those words are exactly the "allocated but unreachable
object" of a failed update; ``gc()`` reclaims them.

A copy of ``repro.core.arena``, line for line: segment size, attach
path, allocation order and addresses are part of PMem-counter parity.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Set, Tuple

from .pmem import NULL, PMem, Region, WORDS_PER_LINE

SEG_WORDS = 1 << 16  # 64K words = 512 KiB per segment
HDR_WORDS = 8


class Arena:
    def __init__(self, pmem: PMem, name: str = "arena"):
        self.pmem = pmem
        self.name = name
        self.segments: List[Region] = []
        self._cursor = HDR_WORDS  # volatile bump cursor (GC rebuilds it)
        # attach (restart): adopt existing segments; the conservative
        # cursor treats them as full — gc() tightens it
        i = 0
        while True:
            seg = pmem.find(f"{name}.seg{i}")
            if seg is None:
                break
            self.segments.append(seg)
            i += 1
        if self.segments:
            self._cursor = len(self.segments) * SEG_WORDS
        else:
            self._add_segment()

    def _add_segment(self) -> None:
        seg = self.pmem.alloc(f"{self.name}.seg{len(self.segments)}", SEG_WORDS)
        self.pmem.persist_region(seg)
        self.segments.append(seg)

    def _locate(self, ptr: int) -> Tuple[Region, int]:
        return self.segments[ptr // SEG_WORDS], ptr % SEG_WORDS

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------
    def alloc(self, n_words: int) -> int:
        """Bump-allocate; cursor is volatile — a crash strands the object
        (unreachable garbage) exactly as RECIPE assumes, until gc()."""
        assert n_words <= SEG_WORDS - HDR_WORDS
        seg_idx, off = divmod(self._cursor, SEG_WORDS)
        if off + n_words > SEG_WORDS:
            self._cursor = (seg_idx + 1) * SEG_WORDS + HDR_WORDS
            seg_idx, off = divmod(self._cursor, SEG_WORDS)
        while seg_idx >= len(self.segments):
            self._add_segment()
        ptr = self._cursor
        self._cursor += n_words
        return ptr

    # ------------------------------------------------------------------
    # word access (mirrors PMem but pointer-addressed)
    # ------------------------------------------------------------------
    def load(self, ptr: int) -> int:
        seg, off = self._locate(ptr)
        return self.pmem.load(seg, off)

    def load_bulk(self, ptr: int, n_words: int):
        """Vectorized node read (allocations never straddle segments);
        counts n_words loads + touched lines like the scalar walk."""
        seg, off = self._locate(ptr)
        return self.pmem.load_bulk(seg, off, n_words)

    def store(self, ptr: int, value: int) -> None:
        seg, off = self._locate(ptr)
        self.pmem.store(seg, off, value)

    def store_bulk(self, ptr: int, words) -> None:
        """Vectorized multi-word store (CoW node blobs: unreachable
        until a later commit store, so intra-blob order is free)."""
        seg, off = self._locate(ptr)
        self.pmem.store_bulk(seg, off, words)

    def cas(self, ptr: int, expected: int, new: int) -> bool:
        seg, off = self._locate(ptr)
        return self.pmem.cas(seg, off, expected, new)

    def clwb(self, ptr: int) -> None:
        seg, off = self._locate(ptr)
        self.pmem.clwb(seg, off)

    def flush_range(self, ptr: int, n_words: int) -> None:
        seg, off = self._locate(ptr)
        self.pmem.flush_range(seg, off, off + n_words)

    def fence(self) -> None:
        self.pmem.fence()

    def persist(self, ptr: int, n_words: int = 1) -> None:
        self.flush_range(ptr, n_words)
        self.fence()

    # ------------------------------------------------------------------
    # locks keyed by node pointer (volatile; cleared on crash)
    # ------------------------------------------------------------------
    def try_lock(self, ptr: int) -> bool:
        seg, off = self._locate(ptr)
        return self.pmem.try_lock(seg, off)

    def lock(self, ptr: int) -> None:
        seg, off = self._locate(ptr)
        self.pmem.lock(seg, off)

    def unlock(self, ptr: int) -> None:
        seg, off = self._locate(ptr)
        self.pmem.unlock(seg, off)

    # ------------------------------------------------------------------
    # epoch GC (mark-sweep over index-provided reachability)
    # ------------------------------------------------------------------
    def gc(self, roots_walker: Callable[[], Iterable[Tuple[int, int]]]) -> int:
        """``roots_walker`` yields (ptr, n_words) for every *reachable*
        object.  Compacts nothing (pointers are stable); just rewinds the
        bump cursor past the last reachable word and reports words
        reclaimed.  This is the "garbage collection for the PM allocator"
        RECIPE assumes; a production allocator would maintain free lists."""
        high = HDR_WORDS
        for ptr, n_words in roots_walker():
            high = max(high, ptr + n_words)
        reclaimed = max(0, self._cursor - high)
        self._cursor = high
        return reclaimed

    @property
    def used_words(self) -> int:
        return self._cursor
