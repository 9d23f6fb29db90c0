"""P-Masstree — persistent Masstree-style B-link tree (RECIPE §6.5).

Masstree's leaves commit every insert/delete with one atomic store of
an 8-byte **permutation word** (4-bit count + fifteen 4-bit slot
indices in sorted order) — Condition #1.  Its internal nodes, however,
shift keys non-atomically and readers *retry* on version mismatch, so
vanilla Masstree does not fit any RECIPE condition.  The paper's fix —
which we implement — restructures internal nodes to work like the
leaves (permutation-committed, B-link sibling pointers + high keys) so
the whole tree supports the 2-step atomic split and readers never
retry.  (The trie-of-B+-trees layering for >8-byte keys is out of
scope here; one layer over 8-byte keys exercises every conversion
mechanism.)

Split protocol (each step leaves a consistent, tolerable state):
  s0. build the sibling copy-on-write (upper half, old high key, old
      sibling link) and persist it — unreachable garbage until linked;
  s1. atomic store: left.next_sibling = sibling;
  s2. atomic store: left.high_key = separator   (readers for keys ≥ sep
      now take the B-link move; duplicates in left are masked);
  s3. atomic store: left.permutation drops the moved entries;
  s4. insert (sep, sibling) into the parent — itself a Condition-#1
      permutation commit (recursing up; root split swaps the superblock
      root pointer).

Crash between any steps: readers reach every key via B-link moves.
Writers detect the leftover (a sibling overlapping the parent's view)
with the §6 try-lock gate and **replay the split algorithm** — the
helper the paper adds to make Masstree Condition #2; the same replay
undoes a half-done merge, which is why merges need no extra machinery
(we absorb deletes by tombstone + rebuild, as the paper suggests).

The port of ``repro.core.masstree``: the PM-side protocol is the
reference's, store for store; batched lookups and range scans search
the sorted leaf run held on the index's device (``kernels/scan``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from .arena import Arena
from .conditions import Condition, ConversionSpec, RecipeIndex, register
from .pmem import NULL, PMem
from ..kernels.probe.fingerprint import fp64
from ..kernels.scan import snapshot_lookup

FANOUT = 15
T_LEAF, T_INNER = 1, 2

# node: [type, permutation, next_sibling, high_key, leftmost_child,
#        pad*3][keys[15]][vals_or_children[15]][pad*2] = 40 words
NODE_WORDS = 40
K0 = 8
V0 = 8 + FANOUT

INF = (1 << 63) - 1

SPEC = register(ConversionSpec(
    name="P-Masstree", structure="B+ tree & trie", reader="non-blocking",
    writer="blocking", non_smo=Condition.ATOMIC_STORE,
    smo=Condition.WRITERS_DONT_FIX,
    notes="internal nodes restructured to B-link + permutation commit; "
          "split-replay helper added (200 LOC in paper)",
))


# ----------------------------------------------------------------------
# the 8-byte permutation word: count (4 bits) + 15 slot indices (4 bits)
# ----------------------------------------------------------------------
def perm_count(perm: int) -> int:
    return perm & 0xF


def perm_slot(perm: int, i: int) -> int:
    """Slot index holding the i-th smallest key."""
    return (perm >> (4 * (i + 1))) & 0xF


def perm_pack(slots: List[int]) -> int:
    word = len(slots) & 0xF
    for i, s in enumerate(slots):
        word |= (s & 0xF) << (4 * (i + 1))
    return word


def perm_slots(perm: int) -> List[int]:
    return [perm_slot(perm, i) for i in range(perm_count(perm))]


class PMasstree(RecipeIndex):
    ORDERED = True
    spec = SPEC
    SHARD_SCHEME = "prefix"  # shards are key ranges: one leaf family

    def __init__(self, pmem: PMem, device=None):
        super().__init__(pmem, device)
        self._region_prefixes = ("mass.",)
        self.arena = Arena(pmem, "mass")
        self.super = pmem.alloc("mass.super", 8)  # word 0: root ptr
        root = self._new_node(T_LEAF, high_key=INF)
        self.arena.flush_range(root, NODE_WORDS)
        self.arena.fence()
        pmem.store(self.super, 0, root)
        pmem.persist_region(self.super)

    def volatile_state(self) -> dict:
        return {"cursor": self.arena._cursor,
                "segments": list(self.arena.segments)}

    def set_volatile_state(self, state: dict) -> None:
        self.arena._cursor = state["cursor"]
        self.arena.segments = list(state["segments"])

    # ------------------------------------------------------------------
    # node helpers
    # ------------------------------------------------------------------
    def _new_node(self, ntype: int, *, high_key: int) -> int:
        a = self.arena
        p = a.alloc(NODE_WORDS)
        a.store(p, ntype)
        a.store(p + 1, perm_pack([]))
        a.store(p + 2, NULL)
        a.store(p + 3, high_key)
        a.store(p + 4, NULL)
        return p

    def _entries(self, node: int) -> List[Tuple[int, int]]:
        """(key, val) in sorted order, via one atomic permutation read."""
        a = self.arena
        perm = a.load(node + 1)
        out = []
        for s in perm_slots(perm):
            out.append((a.load(node + K0 + s), a.load(node + V0 + s)))
        return out

    def _entries_bulk(self, node: int) -> List[Tuple[int, int]]:
        """``_entries`` via one bulk node read — identical result; used
        on the write/SMO paths where a whole node is consumed anyway."""
        w = self.arena.load_bulk(node, NODE_WORDS).tolist()
        return [(w[K0 + s], w[V0 + s]) for s in perm_slots(w[1])]

    def _free_slot(self, node: int) -> Optional[int]:
        used = set(perm_slots(self.arena.load(node + 1)))
        for s in range(FANOUT):
            if s not in used:
                return s
        return None

    # ------------------------------------------------------------------
    # traversal — non-blocking, B-link moves, no retries
    # ------------------------------------------------------------------
    def _descend(self, key: int) -> List[int]:
        """Root-to-leaf path (after any B-link right moves per level)."""
        a = self.arena
        path: List[int] = []
        node = self.pmem.load(self.super, 0)
        while True:
            # B-link: move right while the key is beyond our high key
            while key >= a.load(node + 3) and a.load(node + 2) != NULL:
                node = a.load(node + 2)
            path.append(node)
            if a.load(node) == T_LEAF:
                return path
            child = a.load(node + 4)  # leftmost
            for k, c in self._entries(node):
                if key >= k:
                    child = c
                else:
                    break
            node = child

    def lookup(self, key: int) -> Optional[int]:
        a = self.arena
        leaf = self._descend(key)[-1]
        while True:
            for k, v in self._entries(leaf):
                if k == key:
                    return None if v == NULL else v
            # the key may have moved right via a concurrent/crashed split
            if key >= a.load(leaf + 3) and a.load(leaf + 2) != NULL:
                leaf = a.load(leaf + 2)
                continue
            return None

    # ------------------------------------------------------------------
    # writes — blocking, permutation-word commits (Condition #1)
    # ------------------------------------------------------------------
    def insert(self, key: int, value: int) -> bool:
        assert key != NULL
        self._bump_epoch()  # batched readers must re-snapshot
        a = self.arena
        while True:
            path = self._descend(key)
            leaf = path[-1]
            a.lock(leaf)
            try:
                # re-validate under the lock; may need another right-move
                if key >= a.load(leaf + 3) and a.load(leaf + 2) != NULL:
                    continue
                self._detect_and_fix_split(path, leaf)
                entries = self._entries(leaf)
                for k, v in entries:
                    if k == key:
                        if v != NULL:
                            return False  # exists (no updates via insert)
                        # tombstone revival: atomic value store
                        s = self._slot_of(leaf, key)
                        a.store(leaf + V0 + s, value)
                        a.persist(leaf + V0 + s)
                        return True
                if len(entries) >= FANOUT:
                    self._split(path, leaf)
                    continue  # retry — the key range may have moved
                slot = self._free_slot(leaf)
                # write the pair into the free slot, persist, then commit
                # with ONE atomic permutation store
                a.store(leaf + K0 + slot, key)
                a.store(leaf + V0 + slot, value)
                a.clwb(leaf + K0 + slot)
                a.clwb(leaf + V0 + slot)
                a.fence()
                perm = a.load(leaf + 1)
                slots = perm_slots(perm)
                pos = 0
                while pos < len(slots) and a.load(leaf + K0 + slots[pos]) < key:
                    pos += 1
                slots.insert(pos, slot)
                a.store(leaf + 1, perm_pack(slots))
                a.persist(leaf + 1)
                return True
            finally:
                a.unlock(leaf)

    def _slot_of(self, node: int, key: int) -> int:
        a = self.arena
        for s in perm_slots(a.load(node + 1)):
            if a.load(node + K0 + s) == key:
                return s
        raise KeyError(key)

    def update(self, key: int, value: int) -> bool:
        """Native update: one atomic store to the leaf's value slot —
        the permutation word is untouched, so a reader's one-permutation
        read sees the old or the new value, never a mix.  Overwriting
        with the current value is a no-op (no stores, snapshot epochs
        stay valid); absent keys fall through to insert."""
        assert key != NULL
        a = self.arena
        while True:
            path = self._descend(key)
            leaf = path[-1]
            a.lock(leaf)
            retry = False
            try:
                if key >= a.load(leaf + 3) and a.load(leaf + 2) != NULL:
                    retry = True  # split moved our range; re-descend
                else:
                    for s in perm_slots(a.load(leaf + 1)):
                        if a.load(leaf + K0 + s) == key:
                            v = a.load(leaf + V0 + s)
                            if v == NULL:
                                break  # tombstone: insert revives it
                            if v == value:
                                return True  # no-op overwrite
                            self._bump_epoch()
                            a.store(leaf + V0 + s, value)
                            a.persist(leaf + V0 + s)
                            return True
            finally:
                a.unlock(leaf)
            if not retry:
                return self.insert(key, value)

    def delete(self, key: int) -> bool:
        """Atomic permutation store dropping the entry (§6.5)."""
        a = self.arena
        while True:
            path = self._descend(key)
            leaf = path[-1]
            a.lock(leaf)
            try:
                if key >= a.load(leaf + 3) and a.load(leaf + 2) != NULL:
                    continue
                perm = a.load(leaf + 1)
                slots = perm_slots(perm)
                for i, s in enumerate(slots):
                    if a.load(leaf + K0 + s) == key:
                        if a.load(leaf + V0 + s) == NULL:
                            return False
                        # invalidate batched readers only when the
                        # delete actually commits (no-op deletes leave
                        # the snapshot valid)
                        self._bump_epoch()
                        slots.pop(i)
                        a.store(leaf + 1, perm_pack(slots))
                        a.persist(leaf + 1)
                        return True
                return False
            finally:
                a.unlock(leaf)

    # ------------------------------------------------------------------
    # sharded batched writes (_write_batch wave shard runs)
    # ------------------------------------------------------------------
    def _apply_shard_run(self, ops, positions, results) -> None:
        """Leaf-group commit: the shard is a contiguous key range
        (prefix routing), so the run sorted by key clusters into few
        leaves, and Masstree's permutation-word protocol is inherently
        group-committable — a whole group of inserts/deletes against
        one leaf becomes slot stores + ONE atomic permutation commit.
        One descent and one lock acquisition serve the entire group.
        Ops that need a split (leaf full) fall back to the scalar path
        in order; sorting is stable, so same-key op history — the only
        order that affects results — is preserved."""
        a = self.arena
        order = sorted(positions, key=lambda p: ops[p][1])
        keys = [int(ops[p][1]) for p in order]
        i, n = 0, len(order)
        stall = 0
        while i < n:
            key0 = keys[i]
            path = self._descend_bulk(key0)
            leaf = path[-1]
            a.lock(leaf)
            consumed = 0
            split_needed = False
            try:
                if key0 >= a.load(leaf + 3) and a.load(leaf + 2) != NULL:
                    continue  # a split moved our range; re-descend
                self._detect_and_fix_split(path, leaf)
                high = a.load(leaf + 3)
                j = i
                while j < n and keys[j] < high:
                    j += 1
                consumed = self._leaf_group(leaf, order[i:j], ops, results)
                if consumed == 0:
                    # the next op needs a fresh slot in a full leaf:
                    # split in place (we hold the lock and the path)
                    # and retry the group against the halves
                    if perm_count(a.load(leaf + 1)) >= FANOUT:
                        self._split(path, leaf)
                        split_needed = True
            finally:
                a.unlock(leaf)
            i += consumed
            if consumed == 0 and not split_needed:
                stall += 1
                if stall > 2:  # unexpected shape: the scalar op, in order
                    pos = order[i]
                    kind, key, value = ops[pos]
                    results[pos] = self._apply_write(kind, int(key),
                                                     int(value))
                    i += 1
                    stall = 0
            else:
                stall = 0

    def _descend_bulk(self, key: int) -> List[int]:
        """Root-to-leaf path via one bulk node read per level — the
        batched-write twin of ``_descend`` (same B-link moves, loads
        counted in bulk)."""
        a = self.arena
        path: List[int] = []
        node = self.pmem.load(self.super, 0)
        while True:
            w = a.load_bulk(node, NODE_WORDS).tolist()
            while key >= w[3] and w[2] != NULL:
                node = w[2]
                w = a.load_bulk(node, NODE_WORDS).tolist()
            path.append(node)
            if w[0] == T_LEAF:
                return path
            child = w[4]  # leftmost
            for s in perm_slots(w[1]):
                if key >= w[K0 + s]:
                    child = w[V0 + s]
                else:
                    break
            node = child

    def _leaf_group(self, leaf: int, group: List[int], ops, results) -> int:
        """Apply a run of ops that all target the (locked) ``leaf``.
        Slot stores accumulate, then ONE atomic permutation store
        commits every membership change at once; value overwrites and
        tombstone revivals stay single atomic value-word stores, as in
        the scalar protocol.  Slots freed by this group's deletes are
        NOT recycled before the commit — the published permutation
        still references them, and reusing one would tear the group's
        atomicity.  Returns how many ops were consumed (0 = the first
        op needs the scalar path)."""
        a = self.arena
        w = a.load_bulk(leaf, NODE_WORDS).tolist()
        slots = perm_slots(w[1])
        keys_sorted = [w[K0 + s] for s in slots]
        slot_of = dict(zip(keys_sorted, slots))
        cur_val = {s: w[V0 + s] for s in slots}
        free = [s for s in range(FANOUT) if s not in slot_of.values()]
        consumed = 0
        perm_dirty = False
        for pos in group:
            kind, key, value = ops[pos]
            key, value = int(key), int(value)
            s = slot_of.get(key)
            if kind == "delete":
                if s is None or cur_val[s] == NULL:
                    results[pos] = False
                else:
                    self._bump_epoch()
                    keys_sorted.remove(key)
                    del slot_of[key]
                    # s stays referenced by the committed permutation:
                    # not recyclable inside this group
                    results[pos] = True
                    perm_dirty = True
            elif s is not None:
                if kind == "insert" and cur_val[s] != NULL:
                    results[pos] = False  # exists (no updates via insert)
                elif kind == "update" and cur_val[s] == value:
                    results[pos] = True  # no-op overwrite: no store
                else:
                    # live overwrite / tombstone revival: one atomic
                    # value-word store (the scalar commit)
                    self._bump_epoch()
                    a.store(leaf + V0 + s, value)
                    a.clwb(leaf + V0 + s)
                    a.fence()
                    cur_val[s] = value
                    results[pos] = True
            else:
                if not free:
                    break  # leaf full for new slots: scalar split path
                s = free.pop()
                self._bump_epoch()
                a.store(leaf + K0 + s, key)
                a.store(leaf + V0 + s, value)
                a.clwb(leaf + K0 + s)
                a.clwb(leaf + V0 + s)
                pos_k = 0
                while pos_k < len(keys_sorted) and keys_sorted[pos_k] < key:
                    pos_k += 1
                keys_sorted.insert(pos_k, key)
                slot_of[key] = s
                cur_val[s] = value
                results[pos] = True
                perm_dirty = True
            consumed += 1
        if perm_dirty:
            # pairs durable before the commit point, then ONE atomic
            # permutation store publishes the whole group
            a.fence()
            a.store(leaf + 1, perm_pack([slot_of[k] for k in keys_sorted]))
            a.persist(leaf + 1)
        return consumed

    # ------------------------------------------------------------------
    # the SMO: 2-step atomic split + parent insert
    # ------------------------------------------------------------------
    def _split(self, path: List[int], node: int,
               held: frozenset = frozenset()) -> None:
        """Caller holds node's lock (and every lock in ``held``)."""
        a = self.arena
        entries = self._entries_bulk(node)
        mid = len(entries) // 2
        sep = entries[mid][0]
        ntype = a.load(node)
        # s0: CoW sibling with the upper half, built as one blob store —
        # unreachable until s1, so intra-blob store order is free
        upper = entries[mid:] if ntype == T_LEAF else entries[mid + 1:]
        words = np.zeros(NODE_WORDS, np.int64)
        words[0] = ntype
        words[1] = perm_pack(list(range(len(upper))))
        words[2] = a.load(node + 2)
        words[3] = a.load(node + 3)
        if ntype == T_INNER:
            words[4] = entries[mid][1]  # leftmost child of sibling
        for i, (k, v) in enumerate(upper):
            words[K0 + i] = k
            words[V0 + i] = v
        sib = a.alloc(NODE_WORDS)
        a.store_bulk(sib, words)
        a.flush_range(sib, NODE_WORDS)
        a.fence()
        # s1 (atomic): link the sibling
        a.store(node + 2, sib)
        a.persist(node + 2)
        # s2 (atomic): truncate our key range — readers for >= sep move right
        a.store(node + 3, sep)
        a.persist(node + 3)
        # s3 (atomic): drop the moved entries from our permutation
        keep = mid if ntype == T_LEAF else mid
        old_slots = perm_slots(a.load(node + 1))
        a.store(node + 1, perm_pack(old_slots[:keep]))
        a.persist(node + 1)
        # s4: insert (sep -> sib) into the parent
        self._insert_parent(path, node, sep, sib, held | {node})

    def _place_entry(self, parent: int, sep: int, sib: int) -> None:
        """Insert (sep -> sib) into a node whose lock the caller holds
        and which has room (permutation-word commit, Condition #1)."""
        a = self.arena
        slot = self._free_slot(parent)
        a.store(parent + K0 + slot, sep)
        a.store(parent + V0 + slot, sib)
        a.clwb(parent + K0 + slot)
        a.clwb(parent + V0 + slot)
        a.fence()
        slots = perm_slots(a.load(parent + 1))
        pos = 0
        while pos < len(slots) and a.load(parent + K0 + slots[pos]) < sep:
            pos += 1
        slots.insert(pos, slot)
        a.store(parent + 1, perm_pack(slots))
        a.persist(parent + 1)

    def _insert_parent(self, path: List[int], node: int, sep: int,
                       sib: int, held: frozenset = frozenset()) -> None:
        """Place (sep -> sib) in node's parent.  ``held`` carries every
        node whose lock this call chain already owns, so deep splits
        never re-lock their own ancestors (self-deadlock)."""
        a = self.arena
        try:
            i = path.index(node)
        except ValueError:
            i = len(path) - 1
        held = held | {node}
        if i == 0:
            # root split: new root, committed by one superblock store
            new_root = self._new_node(T_INNER, high_key=INF)
            a.store(new_root + 4, node)
            a.store(new_root + K0 + 0, sep)
            a.store(new_root + V0 + 0, sib)
            a.store(new_root + 1, perm_pack([0]))
            a.flush_range(new_root, NODE_WORDS)
            a.fence()
            if self.pmem.load(self.super, 0) == node:
                self.pmem.store(self.super, 0, new_root)
                self.pmem.persist(self.super, 0)
            else:
                self._insert_inner_somewhere(sep, sib, held)
            return
        parent = path[i - 1]
        we_locked = parent not in held
        if we_locked:
            a.lock(parent)
        held = held | {parent}
        try:
            while True:
                # the parent itself may have split since `path` was built
                moved = False
                while sep >= a.load(parent + 3) and a.load(parent + 2) != NULL:
                    nxt = a.load(parent + 2)
                    if we_locked:
                        a.unlock(parent)
                    parent = nxt
                    we_locked = parent not in held
                    if we_locked:
                        a.lock(parent)
                    held = held | {parent}
                    moved = True
                entries = self._entries_bulk(parent)
                if any(v == sib for _, v in entries)                         or a.load(parent + 4) == sib:
                    return  # split already completed (helper beat us)
                if len(entries) < FANOUT:
                    self._place_entry(parent, sep, sib)
                    return
                # split the (locked) parent, then loop: (sep, sib) may now
                # belong in the parent's new sibling
                self._split(path[:i], parent, held)
        finally:
            if we_locked:
                a.unlock(parent)

    def _insert_inner_somewhere(self, sep: int, sib: int,
                                held: frozenset = frozenset()) -> None:
        """Fallback when the root moved under us: re-descend to the inner
        level that should reference ``sib`` and place the entry."""
        a = self.arena
        path = self._descend(sep)
        if len(path) < 2:
            return
        target = path[-2]
        we_locked = target not in held
        if we_locked:
            a.lock(target)
        try:
            entries = self._entries_bulk(target)
            if any(v == sib for _, v in entries) or a.load(target + 4) == sib:
                return
            if len(entries) < FANOUT:
                self._place_entry(target, sep, sib)
            else:
                self._split(path[:-1], target, held | {target})
                self._insert_parent(path[:-1], target, sep, sib,
                                    held | {target})
        finally:
            if we_locked:
                a.unlock(target)

    # ------------------------------------------------------------------
    # crash detection + split replay (the added #3→#2 helper, §6.5)
    # ------------------------------------------------------------------
    def _detect_and_fix_split(self, path: List[int], leaf: int) -> None:
        """Caller holds ``leaf``'s lock (so any inconsistency is permanent
        — the §6 try-lock gate is satisfied by construction).  Detect a
        crashed split: a linked sibling the parent doesn't know about, or
        a half-truncated left node; replay the split algorithm to finish."""
        a = self.arena
        sib = a.load(leaf + 2)
        if sib == NULL:
            return
        high = a.load(leaf + 3)
        sib_entries = self._entries_bulk(sib)
        if not sib_entries:
            return
        # crash between s1 and s2 (leaf only): high key not yet truncated —
        # the separator is recoverable as the sibling's smallest key
        sep_guess = sib_entries[0][0]
        if high > sep_guess and a.load(leaf) == T_LEAF:
            # persist the loads the fix depends on (Condition #2 action)
            a.clwb(leaf + 1)
            a.clwb(leaf + 2)
            a.fence()
            a.store(leaf + 3, sep_guess)  # replay s2
            a.persist(leaf + 3)
            high = sep_guess
        # crash between s2 and s3 (leaf or inner): permutation still lists
        # moved entries — drop everything >= our (truncated) high key
        slots = perm_slots(a.load(leaf + 1))
        keep = [s for s in slots if a.load(leaf + K0 + s) < high]
        if len(keep) != len(slots):
            a.store(leaf + 1, perm_pack(keep))  # replay s3
            a.persist(leaf + 1)
        # crash before s4: parent lacks the sibling — replay parent insert
        if len(path) >= 2:
            parent = path[-2]
            if not any(v == sib for _, v in self._entries_bulk(parent)) \
                    and a.load(parent + 4) != sib:
                self._insert_parent(path, leaf, a.load(leaf + 3), sib)

    # ------------------------------------------------------------------
    # iteration
    # ------------------------------------------------------------------
    def _leftmost_leaf(self) -> int:
        a = self.arena
        node = self.pmem.load(self.super, 0)
        while a.load(node) != T_LEAF:
            node = a.load(node + 4)
        return node

    def items(self) -> Iterator[Tuple[int, int]]:
        """Scan with reader tolerance: a crash between split steps can
        leave entries duplicated between a node and its new sibling; the
        scan returns a single record per key (paper §4.1 — reads may see
        duplicates and return one), via a monotone key filter."""
        a = self.arena
        node = self._leftmost_leaf()
        last = -1
        while node != NULL:
            high = a.load(node + 3)
            for k, v in self._entries(node):
                if v != NULL and k < high and k > last:
                    yield k, v
                    last = k
            node = a.load(node + 2)

    def keys(self) -> Iterator[int]:
        for k, _ in self.items():
            yield k

    def range_query(self, key_lo: int, key_hi: int) -> List[Tuple[int, int]]:
        a = self.arena
        out = []
        last = -1
        node = self._descend(key_lo)[-1]
        while node != NULL:
            high = a.load(node + 3)
            for k, v in self._entries(node):
                if v != NULL and key_lo <= k <= key_hi and k < high and k > last:
                    out.append((k, v))
                    last = k
            if high > key_hi:
                break
            node = a.load(node + 2)
        return out

    def scan(self, start_key: int, count: int) -> List[Tuple[int, int]]:
        """Descend to start_key's leaf and walk the B-link chain, with
        the same duplicate-masking filters as ``items``."""
        a = self.arena
        out: List[Tuple[int, int]] = []
        last = -1
        node = self._descend(start_key)[-1]
        while node != NULL and len(out) < count:
            high = a.load(node + 3)
            for k, v in self._entries(node):
                if v != NULL and k >= start_key and k < high and k > last:
                    out.append((k, v))
                    last = k
                    if len(out) >= count:
                        break
            node = a.load(node + 2)
        return out

    # ------------------------------------------------------------------
    # data-plane export: the sorted leaf run for the shared scan kernel
    # ------------------------------------------------------------------
    def export_arrays(self) -> Optional[dict]:
        """Page-major flattening of the leaf level: one sorted run of
        live (key, value) pairs, probed by kernels/scan (binary-search
        lookups and window-gather range scans).  ``items`` applies the
        reader's duplicate masking, so the run reflects exactly what a
        scalar reader can observe — including mid-split crash states."""
        items = list(self.items())
        self._n_entries_hint = len(items)
        if not items:
            return None
        keys = np.fromiter((k for k, _ in items), np.int64, len(items))
        vals = np.fromiter((v for _, v in items), np.int64, len(items))
        return {"keys": keys, "vals": vals, "fps": fp64(keys)}

    _n_entries_hint = 0
    _MIN_REBUILD_BATCH = 64

    def _rebuild_floor(self) -> int:
        """Scales with the last export's entry count: the leaf walk
        costs a couple of loads per entry."""
        return max(self._MIN_REBUILD_BATCH, self._n_entries_hint // 4)

    def _kernel_lookup(self, snapshot, queries):
        """The shared sorted-run kernel path; bit-identical to scalar
        ``lookup`` (see kernels/scan)."""
        if snapshot.arrays is None:  # empty tree
            return None
        return snapshot_lookup(snapshot, queries, device=self.device,
                               fingerprints=self.fingerprints,
                               stats=self.probe_stats)

    def _scan_export(self, snapshot):
        """Range scans reuse the lookup export — same sorted run."""
        if snapshot.arrays is None:
            return None
        return snapshot.arrays["keys"], snapshot.arrays["vals"]

    def check_invariants(self) -> None:
        ks = list(self.keys())
        assert ks == sorted(ks), "B-link leaf chain out of order"
        assert len(ks) == len(set(ks)), "duplicate keys"

    def _walk(self) -> Iterator[Tuple[int, int]]:
        a = self.arena
        stack = [self.pmem.load(self.super, 0)]
        seen = set()
        while stack:
            node = stack.pop()
            if node == NULL or node in seen:
                continue
            seen.add(node)
            yield node, NODE_WORDS
            stack.append(a.load(node + 2))
            if a.load(node) == T_INNER:
                stack.append(a.load(node + 4))
                for _, c in self._entries(node):
                    stack.append(c)

    def gc(self) -> int:
        return self.arena.gc(self._walk)
