"""P-HOT — persistent Height-Optimized Trie (RECIPE §6.1).

HOT's RECIPE-relevant property (the reason it is the paper's cleanest
Condition-#1 index): **every** update — insert, update, delete, and
even structural reorganization — is performed copy-on-write off to the
side and committed by **one atomic parent-pointer swap**.  A crash at
any point leaves either the old or the new subtree reachable; partially
built copies are unreachable garbage for the GC.

We keep that commit discipline exactly, over a nibble-span compound-node
trie with path compression (children of a node share a key prefix; a
node consumes 4 key bits and skips any number of nibbles, PATRICIA
style).  The original's SIMD node layouts and dynamic bit-span tuning
are lookup micro-optimizations orthogonal to the conversion; our
batched data-plane lookups get the equivalent treatment in the
radix-descent kernel instead (one thread per query on the card).

Conversion action (#1): flush + fence the CoW region, then the single
atomic pointer store, then flush + fence it (38 LOC in the paper).

The port of ``repro.core.hot``: the PM-side protocol is the
reference's, store for store; batched lookups descend node pages held
on the index's device (``kernels/art_probe`` with 4-bit units).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .arena import Arena
from .conditions import Condition, ConversionSpec, RecipeIndex, register
from .pmem import NULL, PMem
from ..kernels.art_probe import snapshot_lookup
from ..kernels.probe.fingerprint import fp_partial

KEY_NIBBLES = 16  # 8-byte keys, 4-bit spans
T_NODE, T_LEAF = 1, 3

# node: [type, nibble_pos, count, pad*5][children[16]] = 24 words
NODE_WORDS = 24
# leaf: [type, key, value, pad*5]
LEAF_WORDS = 8

SPEC = register(ConversionSpec(
    name="P-HOT", structure="trie", reader="non-blocking",
    writer="blocking", non_smo=Condition.ATOMIC_STORE,
    smo=Condition.ATOMIC_STORE,
    notes="CoW everything + single parent-pointer swap; 38 LOC in paper",
))


def nibble(key: int, pos: int) -> int:
    """Big-endian nibble so integer order == lexicographic order."""
    return (int(key) >> (4 * (KEY_NIBBLES - 1 - pos))) & 0xF


def diverge_nibble(a: int, b: int) -> int:
    for p in range(KEY_NIBBLES):
        if nibble(a, p) != nibble(b, p):
            return p
    raise AssertionError("identical keys")


class PHOT(RecipeIndex):
    ORDERED = True
    spec = SPEC
    SHARD_SCHEME = "prefix"  # shards are key ranges: one subtree family

    def __init__(self, pmem: PMem, device=None):
        super().__init__(pmem, device)
        self._region_prefixes = ("hot.",)
        self.arena = Arena(pmem, "hot")
        self.super = pmem.alloc("hot.super", 8)  # word 0: root
        pmem.persist_region(self.super)

    def volatile_state(self) -> dict:
        return {"cursor": self.arena._cursor,
                "segments": list(self.arena.segments)}

    def set_volatile_state(self, state: dict) -> None:
        self.arena._cursor = state["cursor"]
        self.arena.segments = list(state["segments"])

    # ------------------------------------------------------------------
    # constructors (private until the commit swap; no fences inside)
    # ------------------------------------------------------------------
    def _new_leaf(self, key: int, value: int) -> int:
        a = self.arena
        p = a.alloc(LEAF_WORDS)
        a.store(p, T_LEAF)
        a.store(p + 1, key)
        a.store(p + 2, value)
        return p

    def _new_node(self, pos: int, children: List[Tuple[int, int]]) -> int:
        a = self.arena
        p = a.alloc(NODE_WORDS)
        a.store(p, T_NODE)
        a.store(p + 1, pos)
        a.store(p + 2, len(children))
        for idx, child in children:
            a.store(p + 8 + idx, child)
        return p

    def _copy_node_with(self, node: int, idx: int, child: int) -> int:
        """CoW: clone ``node`` with children[idx] replaced (or removed)."""
        a = self.arena
        p = a.alloc(NODE_WORDS)
        a.store(p, T_NODE)
        a.store(p + 1, a.load(node + 1))
        count = 0
        for i in range(16):
            c = child if i == idx else a.load(node + 8 + i)
            a.store(p + 8 + i, c)
            count += c != NULL
        a.store(p + 2, count)
        return p

    def _publish(self, parent: Optional[int], pidx: int, new: int,
                 n_words: int) -> None:
        """The Condition-#1 commit: persist the CoW region, then ONE
        atomic pointer store, then persist it."""
        self.arena.flush_range(new, n_words)
        self.arena.fence()
        if parent is None:
            self.pmem.store(self.super, 0, new)
            self.pmem.persist(self.super, 0)
        else:
            self.arena.store(parent + 8 + pidx, new)
            self.arena.persist(parent + 8 + pidx)

    # ------------------------------------------------------------------
    # reads — non-blocking; verify the full key at the leaf
    # ------------------------------------------------------------------
    def _descend(self, key: int):
        """Yield (parent, pidx, node) along the search path."""
        a = self.arena
        parent, pidx = None, 0
        node = self.pmem.load(self.super, 0)
        while node != NULL:
            t = a.load(node)
            yield parent, pidx, node
            if t == T_LEAF:
                return
            pos = a.load(node + 1)
            idx = nibble(key, pos)
            parent, pidx = node, idx
            node = a.load(node + 8 + idx)
        yield parent, pidx, NULL

    def lookup(self, key: int) -> Optional[int]:
        a = self.arena
        last = None
        for parent, pidx, node in self._descend(key):
            last = node
        if last == NULL or last is None:
            return None
        if a.load(last) == T_LEAF and a.load(last + 1) == key:
            v = a.load(last + 2)
            return None if v == NULL else v
        return None

    # ------------------------------------------------------------------
    # writes — blocking (lock the node whose pointer is swapped),
    # committed by a single atomic store (Condition #1)
    # ------------------------------------------------------------------
    def _leftmost_key(self, node: int) -> int:
        a = self.arena
        while a.load(node) != T_LEAF:
            for i in range(16):
                c = a.load(node + 8 + i)
                if c != NULL:
                    node = c
                    break
            else:  # pragma: no cover
                raise AssertionError("empty internal node")
        return a.load(node + 1)

    def _lock_slot(self, parent: Optional[int]) -> Tuple[object, int]:
        if parent is None:
            return self.super, 0
        return None, parent

    def _acquire(self, parent: Optional[int]) -> None:
        if parent is None:
            self.pmem.lock(self.super, 0)
        else:
            self.arena.lock(parent)

    def _release(self, parent: Optional[int]) -> None:
        if parent is None:
            self.pmem.unlock(self.super, 0)
        else:
            self.arena.unlock(parent)

    def insert(self, key: int, value: int) -> bool:
        assert key != NULL and value != NULL
        self._bump_epoch()  # batched readers must re-snapshot
        a = self.arena
        while True:
            path = list(self._descend(key))
            parent, pidx, node = path[-1]
            if (node == NULL or node is None) and parent is None:
                # empty tree: persist leaf, atomic root install
                self.pmem.lock(self.super, 0)
                try:
                    if self.pmem.load(self.super, 0) != NULL:
                        continue
                    leaf = self._new_leaf(key, value)
                    self._publish(None, 0, leaf, LEAF_WORDS)
                    return True
                finally:
                    self.pmem.unlock(self.super, 0)
            if node != NULL and node is not None:
                old_key = a.load(node + 1)  # path ends at a leaf
                if old_key == key:
                    if a.load(node + 2) != NULL:
                        return False  # exists (no updates via insert)
                    # tombstone revival = CoW leaf + pointer swap
                    self._acquire(parent)
                    try:
                        cur = (self.pmem.load(self.super, 0) if parent is None
                               else a.load(parent + 8 + pidx))
                        if cur != node:
                            continue
                        leaf = self._new_leaf(key, value)
                        self._publish(parent, pidx, leaf, LEAF_WORDS)
                        return True
                    finally:
                        self._release(parent)
            else:
                # empty slot: the subtree representative tells us whether
                # the key really shares the node's (implicit) prefix
                old_key = self._leftmost_key(parent)
            # the new branch node belongs at the highest node on the path
            # whose span position exceeds the divergence nibble (the
            # divergence may fall inside a skipped prefix)
            d = diverge_nibble(old_key, key)
            ins_parent, ins_idx, below = None, 0, None
            for p, pi, n in path:
                if n == NULL or n is None:
                    continue
                npos = KEY_NIBBLES if a.load(n) == T_LEAF else a.load(n + 1)
                if npos > d:
                    ins_parent, ins_idx, below = p, pi, n
                    break
            if below is None:
                # d >= every position on the path: the key belongs in the
                # empty slot — persist leaf, then one atomic store into the
                # (previously NULL) slot
                assert node == NULL or node is None
                self._acquire(parent)
                try:
                    if a.load(parent + 8 + pidx) != NULL:
                        continue  # raced; retry
                    leaf = self._new_leaf(key, value)
                    self._publish(parent, pidx, leaf, LEAF_WORDS)
                    return True
                finally:
                    self._release(parent)
            self._acquire(ins_parent)
            try:
                cur = (self.pmem.load(self.super, 0) if ins_parent is None
                       else a.load(ins_parent + 8 + ins_idx))
                if cur != below:
                    continue  # raced; retry
                leaf = self._new_leaf(key, value)
                n = self._new_node(d, [(nibble(old_key, d), below),
                                       (nibble(key, d), leaf)])
                a.flush_range(leaf, LEAF_WORDS)
                self._publish(ins_parent, ins_idx, n, NODE_WORDS)
                return True
            finally:
                self._release(ins_parent)

    def update(self, key: int, value: int) -> bool:
        """Native update: CoW a fresh leaf carrying the new value and
        commit it with the universal HOT single parent-pointer swap —
        the same discipline as every other HOT write.  Overwriting with
        the current value is a no-op (no stores, snapshot epochs stay
        valid); absent keys fall through to insert."""
        assert key != NULL and value != NULL
        a = self.arena
        while True:
            path = list(self._descend(key))
            parent, pidx, node = path[-1]
            if node == NULL or node is None or a.load(node) != T_LEAF \
                    or a.load(node + 1) != key or a.load(node + 2) == NULL:
                return self.insert(key, value)
            if a.load(node + 2) == value:
                return True  # no-op overwrite
            r = self._swap_leaf(parent, pidx, node, key, value)
            if r is not None:
                return r
            # raced with a concurrent publish; re-descend and retry

    def delete(self, key: int) -> bool:
        """CoW tombstone: a fresh leaf with NULL value, committed by the
        same single pointer swap (subtree collapse is left to GC-time
        reorganization, which reuses the identical commit discipline)."""
        a = self.arena
        while True:
            path = list(self._descend(key))
            parent, pidx, node = path[-1]
            if node == NULL or node is None or a.load(node) != T_LEAF \
                    or a.load(node + 1) != key or a.load(node + 2) == NULL:
                return False
            self._acquire(parent)
            try:
                cur = (self.pmem.load(self.super, 0) if parent is None
                       else a.load(parent + 8 + pidx))
                if cur != node:
                    continue
                # invalidate batched readers only when the delete
                # actually commits (no-op deletes leave the snapshot
                # valid)
                self._bump_epoch()
                tomb = self.arena.alloc(LEAF_WORDS)
                a.store(tomb, T_LEAF)
                a.store(tomb + 1, key)
                a.store(tomb + 2, NULL)
                self._publish(parent, pidx, tomb, LEAF_WORDS)
                return True
            finally:
                self._release(parent)

    # ------------------------------------------------------------------
    # sharded batched writes (_write_batch wave shard runs)
    # ------------------------------------------------------------------
    def _apply_shard_run(self, ops, positions, results) -> None:
        """Trie shard-run fast path: an iterative bulk-load descent
        (one header read per level instead of a scalar load per word,
        no generator plumbing) feeding the exact CoW + single
        parent-pointer-swap commit helpers.  Uncommon shapes — empty
        trie, tombstone revival, races — fall back to the full scalar
        op, so results and commit protocols are identical."""
        for pos in positions:
            kind, key, value = ops[pos]
            r = self._fast_write(kind, int(key), int(value))
            if r is None:
                r = self._apply_write(kind, int(key), int(value))
            results[pos] = r

    def _fast_write(self, kind: str, key: int, value: int) -> Optional[bool]:
        a = self.arena
        pmem = self.pmem
        node = pmem.load(self.super, 0)
        if node == NULL:
            return None  # empty-trie root install: scalar path
        parent, pidx = None, 0
        path = []  # (parent, pidx, node, node_pos)
        w = None
        while True:
            w = a.load_bulk(node, 8).tolist()
            t = w[0]
            npos = KEY_NIBBLES if t == T_LEAF else w[1]
            path.append((parent, pidx, node, npos))
            if t == T_LEAF:
                break
            idx = nibble(key, npos)
            child = a.load(node + 8 + idx)
            if child == NULL:
                path.append((node, idx, NULL, -1))
                break
            parent, pidx, node = node, idx, child
        parent, pidx, node, _ = path[-1]
        if node != NULL:
            old_key, old_val = w[1], w[2]  # the terminal leaf's header
            if old_key == key:
                if kind == "delete":
                    if old_val == NULL:
                        return False
                    return self._swap_leaf(parent, pidx, node, key, NULL)
                if kind == "update":
                    if old_val == NULL:
                        return None  # tombstone revival: insert path
                    if old_val == value:
                        return True  # no-op overwrite
                    return self._swap_leaf(parent, pidx, node, key, value)
                # insert: exists, or a tombstone the scalar path revives
                return False if old_val != NULL else None
            if kind == "delete":
                return False
            if kind == "update":
                return None  # absent: insert semantics, scalar path
        else:
            if kind == "delete":
                return False
            if kind == "update":
                return None
            old_key = self._leftmost_key(parent)
        # insert placement: branch at the divergence nibble (scalar
        # algorithm over the already-collected path)
        d = diverge_nibble(old_key, key)
        ins = None
        for p, pi, n, npos in path:
            if n != NULL and npos > d:
                ins = (p, pi, n)
                break
        if ins is None:
            if node != NULL:
                return None  # cannot happen with a leaf terminal; safety
            self._acquire(parent)
            try:
                if a.load(parent + 8 + pidx) != NULL:
                    return None  # raced: scalar retry path
                self._bump_epoch()
                leaf = self._new_leaf(key, value)
                self._publish(parent, pidx, leaf, LEAF_WORDS)
                return True
            finally:
                self._release(parent)
        ins_parent, ins_idx, below = ins
        self._acquire(ins_parent)
        try:
            cur = (pmem.load(self.super, 0) if ins_parent is None
                   else a.load(ins_parent + 8 + ins_idx))
            if cur != below:
                return None  # raced: scalar retry path
            self._bump_epoch()
            leaf = self._new_leaf(key, value)
            n = self._new_node(d, [(nibble(old_key, d), below),
                                   (nibble(key, d), leaf)])
            a.flush_range(leaf, LEAF_WORDS)
            self._publish(ins_parent, ins_idx, n, NODE_WORDS)
            return True
        finally:
            self._release(ins_parent)

    def _swap_leaf(self, parent: Optional[int], pidx: int, node: int,
                   key: int, value: int) -> Optional[bool]:
        """Commit a value change (or tombstone, value NULL) by the
        universal CoW-leaf + single parent-pointer swap."""
        a = self.arena
        self._acquire(parent)
        try:
            cur = (self.pmem.load(self.super, 0) if parent is None
                   else a.load(parent + 8 + pidx))
            if cur != node:
                return None  # raced: scalar retry path
            self._bump_epoch()
            leaf = self._new_leaf(key, value)
            self._publish(parent, pidx, leaf, LEAF_WORDS)
            return True
        finally:
            self._release(parent)

    # ------------------------------------------------------------------
    # ordered iteration
    # ------------------------------------------------------------------
    def _iter_subtree(self, node: int) -> Iterator[Tuple[int, int]]:
        a = self.arena
        if a.load(node) == T_LEAF:
            v = a.load(node + 2)
            if v != NULL:
                yield a.load(node + 1), v
            return
        for i in range(16):
            c = a.load(node + 8 + i)
            if c != NULL:
                yield from self._iter_subtree(c)

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
        assert ks == sorted(ks), "trie iteration out of order"
        assert len(ks) == len(set(ks)), "duplicate keys"

    def _walk(self) -> Iterator[Tuple[int, int]]:
        stack = [self.pmem.load(self.super, 0)]
        while stack:
            node = stack.pop()
            if node == NULL:
                continue
            if self.arena.load(node) == T_LEAF:
                yield node, LEAF_WORDS
            else:
                yield node, NODE_WORDS
                stack.extend(self.arena.load(node + 8 + i) for i in range(16))

    def gc(self) -> int:
        return self.arena.gc(self._walk)

    # ------------------------------------------------------------------
    # data-plane export: nibble node pages for the shared radix kernel
    # ------------------------------------------------------------------
    def _node_words(self, ptr: int, n: int) -> np.ndarray:
        """Raw volatile-cache view of a node (allocations never straddle
        segments).  Snapshot reads bypass the load counters: the export
        IS the batched read, amortized over the whole epoch."""
        seg, off = self.arena._locate(ptr)
        return seg.cache[off:off + n]

    def export_arrays(self) -> Optional[Dict[str, np.ndarray]]:
        """Normalized node pages for the batched radix descent
        (kernels/art_probe with 4-bit units).  Node 0 is the root; every
        compound node carries its 16-wide child row and its nibble
        position as ``level``; leaves carry the full 64-bit key/value
        (tombstones keep value 0 and miss in the kernel's liveness
        check, matching the scalar reader)."""
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
            if int(w[0]) == T_NODE:
                row = self._node_words(ptr, NODE_WORDS)[8:]
                for c in row[row != NULL]:
                    queue.append(int(c))
        N = len(order)
        children = np.full((N, 16), -1, np.int32)
        level = np.zeros(N, np.int32)
        is_leaf = np.zeros(N, np.uint8)
        leaf_key = np.zeros(N, np.int64)
        leaf_val = np.zeros(N, np.int64)
        for ptr, i in idx_of.items():
            w = self._node_words(ptr, 8)
            if int(w[0]) == T_LEAF:
                is_leaf[i] = 1
                leaf_key[i] = w[1]
                leaf_val[i] = w[2]
                continue
            level[i] = w[1]  # the node's nibble position
            row = self._node_words(ptr, NODE_WORDS)[8:]
            present = np.nonzero(row != NULL)[0]
            children[i, present] = [idx_of[int(row[b])] for b in present]
        self._n_nodes_hint = N
        leaf_fp = np.where(is_leaf != 0, fp_partial(leaf_key), 0)
        return {"children": children, "level": level, "is_leaf": is_leaf,
                "leaf_key": leaf_key, "leaf_val": leaf_val,
                "leaf_fp": leaf_fp, "unit_bits": 4}

    _n_nodes_hint = 0
    _MIN_REBUILD_BATCH = 64  # stale-snapshot floor for an unknown-size trie

    def _rebuild_floor(self) -> int:
        """Scales with the last export's node count, like P-ART."""
        return max(self._MIN_REBUILD_BATCH, self._n_nodes_hint // 4)

    def _kernel_lookup(self, snapshot, queries):
        """The device radix-descent path over 4-bit units; bit-identical
        to scalar ``lookup`` (see kernels/art_probe).  The export's
        ``leaf_fp`` byte filters leaves before the full-key compare."""
        if snapshot.arrays is None:  # empty trie
            return None
        return snapshot_lookup(snapshot, queries, device=self.device,
                               fingerprints=self.fingerprints,
                               stats=self.probe_stats)
