"""P-ART — persistent Adaptive Radix Tree (RECIPE §6.4).

The paper's Condition-#3 showcase.  Keys are 8-byte integers traversed
byte-by-byte (depth 0..7); leaves store the full key (tries verify the
search key at the leaf).  Adaptivity is retained with two node classes
(Node16 append-ordered, Node256 direct-indexed); the original's
Node4/48 refinements are orthogonal to the RECIPE conversion.

Non-SMO (Condition #1):
* append a (byte, child) entry to a Node16, then commit by atomically
  incrementing the count word;
* Node16→Node256 growth and leaf→subtree expansion are copy-on-write
  followed by a single atomic child-pointer swap;
* delete atomically NULLs the leaf's value word.

SMO — path-compression split (Condition #3 → #2), the paper's exact
two ordered atomic steps:
1. install a new parent (prefix = matched part) via atomic pointer swap;
2. atomically store the truncated prefix into the old node's header
   (prefix_len and up to 7 prefix bytes packed in ONE 8-byte word).

Between the steps the old node's header is stale.  Readers detect it
with the ``level`` field (level != depth + prefix_len; level is never
modified after node creation) and *tolerate* it by skipping
``level - depth`` bytes, verifying the key at the leaf.  Writers used to
only tolerate; our conversion adds the §6 crash-detection gate — if the
node's try-lock succeeds the inconsistency is permanent, and the added
helper recomputes and persists the correct truncated prefix.

The port of ``repro.core.art``: the PM-side protocol is the
reference's, store for store.  Batched lookups (``_kernel_lookup``)
descend node pages held on the index's device with the radix-descent
kernel (``kernels/art_probe``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .arena import Arena
from .conditions import Condition, ConversionSpec, RecipeIndex, register
from .pmem import NULL, PMem
from ..kernels.art_probe import snapshot_lookup
from ..kernels.probe.fingerprint import fp_partial

KEY_BYTES = 8

T_NODE16, T_NODE256, T_LEAF = 1, 2, 3


class _Retry(Exception):
    """Internal: re-validate failed under lock; retry the insert."""

# node16: [type, hdrword(prefix_len|prefix bytes), level, count,
#          4 pad][16 x (byte, child)] = 8 + 32
N16_WORDS = 40
N16_ENTRIES = 8  # header words before entries
# node256: [type, hdrword, level, count, 4 pad][256 children]
N256_WORDS = 264
# leaf: [type, key, value, 5 pad]
LEAF_WORDS = 8

SPEC = register(ConversionSpec(
    name="P-ART", structure="radix tree", reader="non-blocking",
    writer="blocking", non_smo=Condition.ATOMIC_STORE,
    smo=Condition.WRITERS_DONT_FIX,
    notes="added crash detection + prefix-fix helper (52 LOC in paper)",
))


def key_byte(key: int, depth: int) -> int:
    """Big-endian byte of an 8-byte key (so integer order == lex order)."""
    return (int(key) >> (8 * (KEY_BYTES - 1 - depth))) & 0xFF


def pack_hdr(prefix_len: int, prefix: Tuple[int, ...]) -> int:
    """prefix_len in byte 0, prefix bytes in bytes 1..7 — one atomic word."""
    word = prefix_len & 0xFF
    for i, b in enumerate(prefix[:7]):
        word |= (b & 0xFF) << (8 * (i + 1))
    return word


def unpack_hdr(word: int) -> Tuple[int, Tuple[int, ...]]:
    word = int(word) & ((1 << 64) - 1)
    n = word & 0xFF
    return n, tuple((word >> (8 * (i + 1))) & 0xFF for i in range(min(n, 7)))


class PART(RecipeIndex):
    ORDERED = True
    spec = SPEC
    SHARD_SCHEME = "prefix"  # shards are key ranges: one subtree family

    def __init__(self, pmem: PMem, name: str = "art", device=None):
        super().__init__(pmem, device)
        self._n_nodes_hint = 0  # size of the last export, for batch floors
        self._region_prefixes = (f"{name}.",)
        self.arena = Arena(pmem, name)
        existing = pmem.find(f"{name}.super")
        if existing is not None:
            self.super = existing  # attach (restart)
            return
        self.super = pmem.alloc(f"{name}.super", 8)  # word 0: root pointer
        pmem.persist_region(self.super)

    # -- volatile state for crash-sweep snapshots ------------------------
    def volatile_state(self) -> dict:
        return {"cursor": self.arena._cursor,
                "segments": list(self.arena.segments)}

    def set_volatile_state(self, state: dict) -> None:
        self.arena._cursor = state["cursor"]
        self.arena.segments = list(state["segments"])

    # ------------------------------------------------------------------
    # node constructors (private until published — no fences inside)
    # ------------------------------------------------------------------
    def _new_leaf(self, key: int, value: int) -> int:
        a = self.arena
        ptr = a.alloc(LEAF_WORDS)
        a.store(ptr, T_LEAF)
        a.store(ptr + 1, key)
        a.store(ptr + 2, value)
        return ptr

    def _new_node16(self, prefix: Tuple[int, ...], level: int) -> int:
        a = self.arena
        ptr = a.alloc(N16_WORDS)
        a.store(ptr, T_NODE16)
        a.store(ptr + 1, pack_hdr(len(prefix), prefix))
        a.store(ptr + 2, level)
        a.store(ptr + 3, 0)
        return ptr

    def _new_node256(self, prefix: Tuple[int, ...], level: int) -> int:
        a = self.arena
        ptr = a.alloc(N256_WORDS)
        a.store(ptr, T_NODE256)
        a.store(ptr + 1, pack_hdr(len(prefix), prefix))
        a.store(ptr + 2, level)
        a.store(ptr + 3, 0)
        for i in range(256):
            a.store(ptr + 8 + i, NULL)
        return ptr

    def _persist_node(self, ptr: int) -> None:
        a = self.arena
        t = a.load(ptr)
        n = {T_NODE16: N16_WORDS, T_NODE256: N256_WORDS, T_LEAF: LEAF_WORDS}[t]
        a.flush_range(ptr, n)
        a.fence()

    # ------------------------------------------------------------------
    # child access
    # ------------------------------------------------------------------
    def _find_child(self, node: int, byte: int) -> int:
        a = self.arena
        t = a.load(node)
        if t == T_NODE16:
            count = a.load(node + 3)
            for i in range(count):
                if a.load(node + N16_ENTRIES + 2 * i) == byte:
                    return a.load(node + N16_ENTRIES + 2 * i + 1)
            return NULL
        return a.load(node + 8 + byte)

    def _children(self, node: int) -> List[Tuple[int, int]]:
        a = self.arena
        t = a.load(node)
        out = []
        if t == T_NODE16:
            count = a.load(node + 3)
            for i in range(count):
                b = a.load(node + N16_ENTRIES + 2 * i)
                c = a.load(node + N16_ENTRIES + 2 * i + 1)
                if c != NULL:
                    out.append((b, c))
            out.sort()
        else:
            for b in range(256):
                c = a.load(node + 8 + b)
                if c != NULL:
                    out.append((b, c))
        return out

    # ------------------------------------------------------------------
    # reads — non-blocking, tolerate stale prefixes via the level field
    # ------------------------------------------------------------------
    def lookup(self, key: int) -> Optional[int]:
        a = self.arena
        node = self.pmem.load(self.super, 0)
        depth = 0
        while node != NULL:
            t = a.load(node)
            if t == T_LEAF:
                if a.load(node + 1) == key:  # tries verify the full key
                    v = a.load(node + 2)
                    return None if v == NULL else v
                return None
            plen, prefix = unpack_hdr(a.load(node + 1))
            level = a.load(node + 2)
            if depth + plen != level:
                # interrupted path-compression SMO: ignore (part of) the
                # stale prefix and trust the level field (paper §6.4)
                depth = level
            else:
                for i, b in enumerate(prefix):
                    if key_byte(key, depth + i) != b:
                        return None
                depth += plen
            node = self._find_child(node, key_byte(key, depth))
            depth += 1
        return None

    # ------------------------------------------------------------------
    # writes — blocking (per-node lock), single-atomic-store commits
    # ------------------------------------------------------------------
    def insert(self, key: int, value: int) -> bool:
        assert key != NULL and value != NULL
        assert 0 < key < (1 << 63), "keys are signed-64 PM words"
        self._bump_epoch()  # batched readers must re-snapshot
        a = self.arena
        root = self.pmem.load(self.super, 0)
        if root == NULL:
            leaf = self._new_leaf(key, value)
            self._persist_node(leaf)
            # commit: single atomic store of the root pointer
            if not self.pmem.cas(self.super, 0, NULL, leaf):
                return self.insert(key, value)  # lost race, retry
            self.pmem.persist(self.super, 0)
            return True
        return self._insert_rec(None, 0, root, 0, key, value)

    def _child_slot(self, parent: Optional[int], byte: int) -> Tuple[object, int]:
        """(region-ish, word index) of the pointer that names the child."""
        if parent is None:
            return self.super, 0
        a = self.arena
        t = a.load(parent)
        if t == T_NODE16:
            count = a.load(parent + 3)
            for i in range(count):
                if a.load(parent + N16_ENTRIES + 2 * i) == byte:
                    return None, parent + N16_ENTRIES + 2 * i + 1
            raise AssertionError("child slot vanished")
        return None, parent + 8 + byte

    def _swap_child(self, parent: Optional[int], byte: int, new: int) -> None:
        """Commit a CoW by a single atomic pointer store + flush + fence."""
        region, slot = self._child_slot(parent, byte)
        if region is self.super:
            self.pmem.store(self.super, 0, new)
            self.pmem.persist(self.super, 0)
        else:
            self.arena.store(slot, new)
            self.arena.persist(slot)

    def _insert_rec(self, parent: Optional[int], pbyte: int, node: int,
                    depth: int, key: int, value: int) -> bool:
        a = self.arena
        t = a.load(node)
        if t == T_LEAF:
            return self._expand_leaf(parent, pbyte, node, depth, key, value)
        plen, prefix = unpack_hdr(a.load(node + 1))
        level = a.load(node + 2)
        if depth + plen != level:
            # permanent vs transient? — the §6 crash-detection gate:
            # try-lock succeeding means no concurrent writer, so the
            # inconsistency is a crash artifact → run the added helper.
            if a.try_lock(node):
                try:
                    self._fix_prefix(node, depth)
                finally:
                    a.unlock(node)
            else:
                # transient: the SMO owner holds the lock and will complete
                # step 2; writers are blocking, so wait for it, then
                # re-check (it may still be stale if the owner crashed).
                a.lock(node)
                try:
                    self._fix_prefix(node, depth)
                finally:
                    a.unlock(node)
            plen, prefix = unpack_hdr(a.load(node + 1))
        # prefix mismatch → path-compression split (the 2-step SMO)
        for j in range(len(prefix)):
            if key_byte(key, depth + j) != prefix[j]:
                return self._split_prefix(parent, pbyte, node, depth, j,
                                          plen, prefix, key, value)
        depth += plen
        byte = key_byte(key, depth)
        child = self._find_child(node, byte)
        if child == NULL:
            return self._add_child(node, depth, byte, key, value)
        return self._insert_rec(node, byte, child, depth + 1, key, value)

    def _add_child(self, node: int, depth: int, byte: int, key: int,
                   value: int) -> bool:
        """Append to Node16 + atomic count bump, or direct store in Node256;
        grow 16→256 by CoW + pointer swap when full (all Condition #1)."""
        a = self.arena
        a.lock(node)
        recurse = None
        done = False
        try:
            child = self._find_child(node, byte)  # re-check under lock
            if child != NULL:
                recurse = child
            else:
                t = a.load(node)
                leaf = self._new_leaf(key, value)
                self._persist_node(leaf)
                if t == T_NODE256:
                    a.store(node + 8 + byte, leaf)  # single atomic store
                    a.persist(node + 8 + byte)
                    done = True
                else:
                    count = a.load(node + 3)
                    if count < 16:
                        a.store(node + N16_ENTRIES + 2 * count, byte)
                        a.store(node + N16_ENTRIES + 2 * count + 1, leaf)
                        a.flush_range(node + N16_ENTRIES + 2 * count, 2)
                        a.fence()
                        # commit: atomic count bump makes the entry visible
                        a.store(node + 3, count + 1)
                        a.persist(node + 3)
                        done = True
                    else:
                        # grow: CoW into a Node256, then swap parent pointer
                        plen, prefix = unpack_hdr(a.load(node + 1))
                        level = a.load(node + 2)
                        big = self._new_node256(prefix, level)
                        for b, c in self._children(node):
                            a.store(big + 8 + b, c)
                        a.store(big + 8 + byte, leaf)
                        a.store(big + 3, count + 1)
                        self._persist_node(big)
                        parent, slot_byte = self._locate_parent(node, key, depth)
                        self._swap_child(parent, slot_byte, big)
                        done = True
        finally:
            a.unlock(node)
        if recurse is not None:
            return self._insert_rec(node, byte, recurse, depth + 1, key, value)
        return done

    def _locate_parent(self, node: int, key: int,
                       depth: int) -> Tuple[Optional[int], int]:
        """Re-traverse from the root to find node's parent (lock-coupling
        free control plane; production code would pass it down)."""
        cur = self.pmem.load(self.super, 0)
        if cur == node:
            return None, 0
        a = self.arena
        d = 0
        parent = None
        while cur != NULL and cur != node:
            t = a.load(cur)
            if t == T_LEAF:
                break
            plen, _ = unpack_hdr(a.load(cur + 1))
            level = a.load(cur + 2)
            d = level if d + plen != level else d + plen
            b = key_byte(key, d)
            parent = cur
            cur = self._find_child(cur, b)
            d += 1
        if cur != node:
            raise AssertionError("parent not found")
        return parent, key_byte(key, d - 1)

    def _expand_leaf(self, parent: Optional[int], pbyte: int, leaf: int,
                     depth: int, key: int, value: int) -> bool:
        """Replace a leaf with [new Node16 + old leaf + new leaf] via CoW +
        single pointer swap (Condition #1)."""
        a = self.arena
        old_key = a.load(leaf + 1)
        if old_key == key:
            if a.load(leaf + 2) != NULL:
                return False  # exists (no updates via insert)
            # tombstone revival: single atomic store to the value word
            a.lock(leaf)
            try:
                a.store(leaf + 2, value)
                a.persist(leaf + 2)
            finally:
                a.unlock(leaf)
            return True
        # common prefix between old and new key from `depth`
        j = depth
        while j < KEY_BYTES and key_byte(old_key, j) == key_byte(key, j):
            j += 1
        assert j < KEY_BYTES
        prefix = tuple(key_byte(key, i) for i in range(depth, j))
        node = self._new_node16(prefix, j)
        new_leaf = self._new_leaf(key, value)
        a.store(node + N16_ENTRIES + 0, key_byte(old_key, j))
        a.store(node + N16_ENTRIES + 1, leaf)
        a.store(node + N16_ENTRIES + 2, key_byte(key, j))
        a.store(node + N16_ENTRIES + 3, new_leaf)
        a.store(node + 3, 2)
        self._persist_node(new_leaf)
        self._persist_node(node)
        self._swap_child(parent, pbyte, node)  # commit
        return True

    # ------------------------------------------------------------------
    # the SMO: path-compression split in exactly 2 ordered atomic steps
    # ------------------------------------------------------------------
    def _split_prefix(self, parent: Optional[int], pbyte: int, node: int,
                      depth: int, j: int, plen: int,
                      prefix: Tuple[int, ...], key: int, value: int) -> bool:
        a = self.arena
        a.lock(node)
        retry = False
        try:
            # re-validate under the lock
            plen2, prefix2 = unpack_hdr(a.load(node + 1))
            if (plen2, prefix2) != (plen, prefix):
                retry = True
                raise _Retry
            new_parent = self._new_node16(prefix[:j], depth + j)
            leaf = self._new_leaf(key, value)
            a.store(new_parent + N16_ENTRIES + 0, prefix[j])
            a.store(new_parent + N16_ENTRIES + 1, node)
            a.store(new_parent + N16_ENTRIES + 2, key_byte(key, depth + j))
            a.store(new_parent + N16_ENTRIES + 3, leaf)
            a.store(new_parent + 3, 2)
            self._persist_node(leaf)
            self._persist_node(new_parent)
            # STEP 1 (atomic): install new parent
            self._swap_child(parent, pbyte, new_parent)
            # --- crash here leaves node's header stale; readers tolerate
            # via level, writers fix via the helper (_fix_prefix) ---
            # STEP 2 (atomic): truncate the old node's prefix — one word
            a.store(node + 1, pack_hdr(plen - j - 1, prefix[j + 1:]))
            a.persist(node + 1)
            return True
        except _Retry:
            pass
        finally:
            a.unlock(node)
        assert retry
        return self._insert_rec(parent, pbyte, node, depth, key, value)

    def _fix_prefix(self, node: int, depth: int) -> None:
        """The helper mechanism we add (§6.4): recompute the truncated
        prefix from the immutable level field and persist it.  Loads it
        depends on are flushed first (Condition #2 conversion action)."""
        a = self.arena
        hdr = a.load(node + 1)
        a.clwb(node + 1)  # persist the state the fix is based on
        a.clwb(node + 2)
        a.fence()
        plen, prefix = unpack_hdr(hdr)
        level = a.load(node + 2)
        correct_len = level - depth
        if correct_len == plen or correct_len < 0:
            return  # already consistent (or fixed by another writer)
        # stale prefix retains the full pre-split bytes: correct suffix
        a.store(node + 1, pack_hdr(correct_len, prefix[plen - correct_len:]))
        a.persist(node + 1)

    def update(self, key: int, value: int) -> bool:
        """Native update: descend to the leaf and commit the new value
        with one atomic store to its value word (the delete commit,
        storing a live value instead of NULL).  Overwriting with the
        current value is a no-op — no stores, snapshot epochs stay
        valid; absent keys fall through to insert."""
        assert key != NULL and value != NULL
        a = self.arena
        node = self.pmem.load(self.super, 0)
        depth = 0
        while node != NULL:
            t = a.load(node)
            if t == T_LEAF:
                if a.load(node + 1) == key and a.load(node + 2) != NULL:
                    if a.load(node + 2) == value:
                        return True  # no-op overwrite
                    a.lock(node)
                    try:
                        if a.load(node + 2) == NULL:  # raced with delete
                            break
                        self._bump_epoch()
                        a.store(node + 2, value)  # atomic commit (§6.4)
                        a.persist(node + 2)
                        return True
                    finally:
                        a.unlock(node)
                break
            plen, prefix = unpack_hdr(a.load(node + 1))
            level = a.load(node + 2)
            depth = level if depth + plen != level else depth + plen
            node = self._find_child(node, key_byte(key, depth))
            depth += 1
        return self.insert(key, value)

    def delete(self, key: int) -> bool:
        self._bump_epoch()
        a = self.arena
        node = self.pmem.load(self.super, 0)
        depth = 0
        while node != NULL:
            t = a.load(node)
            if t == T_LEAF:
                if a.load(node + 1) == key and a.load(node + 2) != NULL:
                    a.lock(node)
                    try:
                        # commit: atomically NULL the value word (§6.4)
                        a.store(node + 2, NULL)
                        a.persist(node + 2)
                    finally:
                        a.unlock(node)
                    return True
                return False
            plen, prefix = unpack_hdr(a.load(node + 1))
            level = a.load(node + 2)
            depth = level if depth + plen != level else depth + plen
            node = self._find_child(node, key_byte(key, depth))
            depth += 1
        return False

    # ------------------------------------------------------------------
    # sharded batched writes (_write_batch wave shard runs)
    # ------------------------------------------------------------------
    def _apply_shard_run(self, ops, positions, results) -> None:
        """Radix shard-run fast path: an iterative bulk-load descent
        (one line-counted bulk read per node instead of a scalar load
        per word) that dispatches to the exact scalar mutation helpers
        — ``_add_child``, ``_expand_leaf``, the atomic value commits.
        Anything off the common path (stale prefixes, prefix splits,
        tombstone revival, empty tree) falls back to the full scalar
        op, so results and commit protocols are identical."""
        for pos in positions:
            kind, key, value = ops[pos]
            r = self._fast_write(kind, int(key), int(value))
            if r is None:
                r = self._apply_write(kind, int(key), int(value))
            results[pos] = r

    def _fast_write(self, kind: str, key: int, value: int) -> Optional[bool]:
        a = self.arena
        node = self.pmem.load(self.super, 0)
        if node == NULL:
            return None  # empty-tree root install: scalar path
        parent, pbyte, depth = None, 0, 0
        while True:
            w = a.load_bulk(node, 8).tolist()
            t = w[0]
            if t == T_LEAF:
                leaf_key, leaf_val = w[1], w[2]
                if kind == "insert":
                    if leaf_key == key:
                        return None  # exists / tombstone: scalar path
                    self._bump_epoch()
                    return self._expand_leaf(parent, pbyte, node, depth,
                                             key, value)
                if leaf_key != key or leaf_val == NULL:
                    # update of an absent key inserts; delete is a no-op
                    return None if kind == "update" else False
                if kind == "update" and leaf_val == value:
                    return True  # no-op overwrite
                a.lock(node)
                try:
                    if a.load(node + 2) == NULL:  # raced with delete
                        return None if kind == "update" else False
                    self._bump_epoch()
                    a.store(node + 2,
                            value if kind == "update" else NULL)
                    a.persist(node + 2)
                    return True
                finally:
                    a.unlock(node)
            plen, prefix = unpack_hdr(w[1])
            level = w[2]
            if depth + plen != level:
                if kind == "insert":
                    # §6 crash-detection gate: in a single-writer batch
                    # the lock always succeeds, so the inconsistency is
                    # permanent — run the prefix-fix helper (scalar path)
                    a.lock(node)
                    try:
                        self._fix_prefix(node, depth)
                    finally:
                        a.unlock(node)
                    plen, prefix = unpack_hdr(a.load(node + 1))
                else:
                    # readers (and the read-shaped walks of update /
                    # delete) tolerate: trust the level field
                    depth, plen, prefix = level, 0, ()
            if kind == "insert":
                for j, b in enumerate(prefix):
                    if key_byte(key, depth + j) != b:
                        self._bump_epoch()
                        return self._split_prefix(parent, pbyte, node,
                                                  depth, j, plen, prefix,
                                                  key, value)
            else:
                for j, b in enumerate(prefix):
                    if key_byte(key, depth + j) != b:
                        # key diverges from this subtree: absent
                        return None if kind == "update" else False
            depth += plen
            byte = key_byte(key, depth)
            if t == T_NODE16:
                count = w[3]
                child = NULL
                if count:
                    ent = a.load_bulk(node + N16_ENTRIES, 2 * count).tolist()
                    for i in range(count):
                        if ent[2 * i] == byte:
                            child = ent[2 * i + 1]
                            break
            else:
                child = a.load(node + 8 + byte)
            if child == NULL:
                if kind == "insert":
                    self._bump_epoch()
                    return self._add_child(node, depth, byte, key, value)
                return None if kind == "update" else False
            parent, pbyte, node, depth = node, byte, child, depth + 1

    # ------------------------------------------------------------------
    # ordered iteration / range queries
    # ------------------------------------------------------------------
    def _iter_subtree(self, node: int) -> Iterator[Tuple[int, int]]:
        a = self.arena
        t = a.load(node)
        if t == T_LEAF:
            v = a.load(node + 2)
            if v != NULL:
                yield a.load(node + 1), v
            return
        for _, child in self._children(node):
            yield from self._iter_subtree(child)

    def items(self) -> Iterator[Tuple[int, int]]:
        root = self.pmem.load(self.super, 0)
        if root != NULL:
            yield from self._iter_subtree(root)

    def keys(self) -> Iterator[int]:
        for k, _ in self.items():
            yield k

    def range_query(self, key_lo: int, key_hi: int) -> List[Tuple[int, int]]:
        return [(k, v) for k, v in self.items() if key_lo <= k <= key_hi]

    def check_invariants(self) -> None:
        ks = list(self.keys())
        assert ks == sorted(ks), "radix iteration out of order"
        assert len(ks) == len(set(ks)), "duplicate keys"

    # ------------------------------------------------------------------
    # data-plane export: dense node pages for the radix-descent kernel
    # ------------------------------------------------------------------
    def _node_words(self, ptr: int, n: int) -> np.ndarray:
        """Raw volatile-cache view of a node (allocations never straddle
        segments).  Snapshot reads bypass the load counters: the export
        IS the batched read, amortized over the whole epoch."""
        seg, off = self.arena._locate(ptr)
        return seg.cache[off:off + n]

    def export_arrays(self) -> Optional[Dict[str, np.ndarray]]:
        """Normalized node pages for batched radix descent
        (kernels/art_probe).  Node 0 is the root; every node carries a
        full 256-wide child row (Node16 entries are expanded), its
        ``level`` word, and — for leaves — the full 64-bit key/value.
        Descent needs no prefix bytes: it trusts ``level`` exactly like
        the scalar reader's stale-prefix tolerance and verifies the full
        key at the leaf, so results match ``lookup`` bit for bit."""
        root = int(self.pmem.load(self.super, 0))
        if root == NULL:
            return None
        order: List[int] = []
        idx_of: Dict[int, int] = {}
        queue = [root]
        while queue:
            ptr = queue.pop()
            if ptr in idx_of:
                continue
            idx_of[ptr] = len(order)
            order.append(ptr)
            w = self._node_words(ptr, 8)
            t = int(w[0])
            if t == T_NODE16:
                ent = self._node_words(ptr, N16_WORDS)
                for i in range(int(w[3])):
                    c = int(ent[N16_ENTRIES + 2 * i + 1])
                    if c != NULL:
                        queue.append(c)
            elif t == T_NODE256:
                row = self._node_words(ptr, N256_WORDS)[8:]
                for c in row[row != NULL]:
                    queue.append(int(c))
        N = len(order)
        children = np.full((N, 256), -1, np.int32)
        level = np.zeros(N, np.int32)
        is_leaf = np.zeros(N, np.uint8)
        leaf_key = np.zeros(N, np.int64)
        leaf_val = np.zeros(N, np.int64)
        for ptr, i in idx_of.items():
            w = self._node_words(ptr, 8)
            t = int(w[0])
            if t == T_LEAF:
                is_leaf[i] = 1
                leaf_key[i] = w[1]
                leaf_val[i] = w[2]
                continue
            level[i] = w[2]
            if t == T_NODE16:
                ent = self._node_words(ptr, N16_WORDS)
                # first-match-wins like _find_child's append-order scan
                # (bytes are unique, so order is immaterial in practice)
                for j in range(int(w[3]) - 1, -1, -1):
                    b = int(ent[N16_ENTRIES + 2 * j])
                    c = int(ent[N16_ENTRIES + 2 * j + 1])
                    if c != NULL:
                        children[i, b] = idx_of[c]
            else:
                row = self._node_words(ptr, N256_WORDS)[8:]
                present = np.nonzero(row != NULL)[0]
                children[i, present] = [idx_of[int(row[b])] for b in present]
        self._n_nodes_hint = N
        leaf_fp = np.where(is_leaf != 0, fp_partial(leaf_key), 0)
        return {"children": children, "level": level, "is_leaf": is_leaf,
                "leaf_key": leaf_key, "leaf_val": leaf_val,
                "leaf_fp": leaf_fp}

    _MIN_REBUILD_BATCH = 64  # stale-snapshot floor for an unknown-size tree

    def _rebuild_floor(self) -> int:
        """Scales with the last export's node count: the BFS export
        costs about a scalar lookup per 6 nodes."""
        return max(self._MIN_REBUILD_BATCH, self._n_nodes_hint // 4)

    def _kernel_lookup(self, snapshot, queries):
        """The device radix-descent path; bit-identical to scalar
        ``lookup`` (see kernels/art_probe).  The export's ``leaf_fp``
        partial-key byte filters leaves before the full-key compare."""
        if snapshot.arrays is None:  # empty tree
            return None
        return snapshot_lookup(snapshot, queries, device=self.device,
                               fingerprints=self.fingerprints,
                               stats=self.probe_stats)

    # reachability walker for arena GC
    def _walk(self) -> Iterator[Tuple[int, int]]:
        sizes = {T_NODE16: N16_WORDS, T_NODE256: N256_WORDS, T_LEAF: LEAF_WORDS}
        stack = [self.pmem.load(self.super, 0)]
        while stack:
            node = stack.pop()
            if node == NULL:
                continue
            t = self.arena.load(node)
            yield node, sizes[t]
            if t != T_LEAF:
                stack.extend(c for _, c in self._children(node))

    def gc(self) -> int:
        return self.arena.gc(self._walk)
