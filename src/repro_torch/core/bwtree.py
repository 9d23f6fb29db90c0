"""P-BwTree — persistent Bw-Tree (RECIPE §6.3, Condition #2).

The Bw-Tree is the paper's non-blocking index: updates prepend *delta
records* to per-node chains and publish them with a single CAS on a
**mapping table** entry (PID → chain head).  Structure modification
(node split) follows the two-step B-link protocol:

  1. CAS a SPLIT delta onto the child (names the separator key and the
     new sibling's PID — the sibling base node and its mapping entry
     are written and persisted beforehand; until the CAS they are
     unreachable garbage);
  2. CAS an INDEX-ENTRY delta onto the parent.

Any thread that traverses past an *unfinished* split (split delta
present, parent entry missing) **helps along**: it completes step 2
before doing its own work — the Condition-#2 helper mechanism.  Reads
tolerate the intermediate state by following the split delta's side
link, never retrying (we adopt the paper's fix to the open-source
BwTree whose readers restarted on in-progress merges: we eliminate
merges — deletes are tombstone deltas absorbed at consolidation — so
reads never restart).

Conversion actions applied (§6.3):
* non-SMO deltas: flush the mapping-table word **only if the CAS
  succeeds** + fence; no load flushes needed (all racing writers target
  the same mapping word, so PM store order matches cache store order);
* SMO path: flush + fence after every store AND after the loads the
  helper depends on (the split delta and mapping words it read).

The port of ``repro.core.bwtree``: the PM-side protocol is the
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

# record types
D_INSERT, D_DELETE, D_SPLIT, D_INDEX = 1, 2, 3, 4
N_LEAF, N_INNER = 10, 11

LEAF_CAP = 16  # max records in a consolidated leaf
INNER_CAP = 16
CHAIN_MAX = 8  # consolidate when a delta chain grows past this

# leaf base: [type, count, right_pid, high_key, pad*4][keys][vals]
LEAF_WORDS = 8 + 2 * LEAF_CAP
# inner base: [type, count, right_pid, high_key, leftmost_pid, pad*3]
#             [keys][child_pids]   (child[i] covers keys >= key[i])
INNER_WORDS = 8 + 2 * INNER_CAP
# delta: [type, key, val_or_pid, next_ptr, pad*4]
DELTA_WORDS = 8

INF = (1 << 63) - 1  # +infinity high key

SPEC = register(ConversionSpec(
    name="P-BwTree", structure="B+ tree", reader="non-blocking",
    writer="non-blocking", non_smo=Condition.ATOMIC_STORE,
    smo=Condition.WRITERS_FIX,
    notes="CAS-published deltas; help-along completes splits (85 LOC in paper)",
))


class PBwTree(RecipeIndex):
    ORDERED = True
    spec = SPEC
    SHARD_SCHEME = "prefix"  # shards are key ranges: one leaf family

    def __init__(self, pmem: PMem, map_size: int = 1 << 14, device=None):
        super().__init__(pmem, device)
        self._region_prefixes = ("bw.",)
        self.arena = Arena(pmem, "bw")
        # mapping table: one PM word per PID
        self.map = pmem.alloc("bw.map", map_size)
        self.super = pmem.alloc("bw.super", 8)  # [root_pid, next_pid]
        root = self._new_leaf_base([], [], right_pid=NULL, high_key=INF)
        pmem.store(self.map, 1, root)
        pmem.store(self.super, 0, 1)  # root pid
        pmem.store(self.super, 1, 2)  # next free pid
        pmem.persist_region(self.super)
        self.pmem.persist(self.map, 1)

    def volatile_state(self) -> dict:
        return {"cursor": self.arena._cursor,
                "segments": list(self.arena.segments)}

    def set_volatile_state(self, state: dict) -> None:
        self.arena._cursor = state["cursor"]
        self.arena.segments = list(state["segments"])

    # ------------------------------------------------------------------
    # pid + node constructors
    # ------------------------------------------------------------------
    def _alloc_pid(self) -> int:
        # CAS-bump the persistent next-pid word; a crash strands the pid
        # (GC reclaims unreferenced mapping entries)
        while True:
            nxt = self.pmem.load(self.super, 1)
            if self.pmem.cas(self.super, 1, nxt, nxt + 1):
                self.pmem.persist(self.super, 1)
                return nxt

    def _new_leaf_base(self, keys: List[int], vals: List[int], *,
                       right_pid: int, high_key: int) -> int:
        # one blob store: the base is unreachable garbage until the
        # mapping-table CAS that publishes it, so intra-order is free
        a = self.arena
        words = np.zeros(LEAF_WORDS, np.int64)
        words[0] = N_LEAF
        words[1] = len(keys)
        words[2] = right_pid
        words[3] = high_key
        words[8:8 + len(keys)] = keys
        words[8 + LEAF_CAP:8 + LEAF_CAP + len(vals)] = vals
        p = a.alloc(LEAF_WORDS)
        a.store_bulk(p, words)
        a.flush_range(p, LEAF_WORDS)
        return p

    def _new_inner_base(self, keys: List[int], pids: List[int], *,
                        leftmost: int, right_pid: int, high_key: int) -> int:
        a = self.arena
        words = np.zeros(INNER_WORDS, np.int64)
        words[0] = N_INNER
        words[1] = len(keys)
        words[2] = right_pid
        words[3] = high_key
        words[4] = leftmost
        words[8:8 + len(keys)] = keys
        words[8 + INNER_CAP:8 + INNER_CAP + len(pids)] = pids
        p = a.alloc(INNER_WORDS)
        a.store_bulk(p, words)
        a.flush_range(p, INNER_WORDS)
        return p

    def _new_delta(self, dtype: int, key: int, val: int, nxt: int) -> int:
        a = self.arena
        p = a.alloc(DELTA_WORDS)
        a.store(p, dtype)
        a.store(p + 1, key)
        a.store(p + 2, val)
        a.store(p + 3, nxt)
        a.flush_range(p, DELTA_WORDS)
        return p

    # ------------------------------------------------------------------
    # chain replay
    # ------------------------------------------------------------------
    def _head(self, pid: int) -> int:
        return self.pmem.load(self.map, pid)

    def _base_of(self, head: int) -> int:
        a = self.arena
        p = head
        while a.load(p) in (D_INSERT, D_DELETE, D_SPLIT, D_INDEX):
            p = a.load(p + 3)
        return p

    def _replay_leaf(self, head: int) -> Tuple[dict, int, int]:
        """Fold a leaf chain into ({key: val}, right_pid, high_key).
        A SPLIT delta truncates the key range (side link semantics)."""
        a = self.arena
        records: List[Tuple[int, int, int]] = []  # (type, key, val)
        p = head
        high_key, right_pid = None, None
        while True:
            t = a.load(p)
            if t in (D_INSERT, D_DELETE):
                records.append((t, a.load(p + 1), a.load(p + 2)))
                p = a.load(p + 3)
            elif t == D_SPLIT:
                if high_key is None:  # outermost split delta wins
                    high_key = a.load(p + 1)
                    right_pid = a.load(p + 2)
                p = a.load(p + 3)
            else:
                break
        base = p
        out: dict = {}
        n = a.load(base + 1)
        for i in range(n):
            out[a.load(base + 8 + i)] = a.load(base + 8 + LEAF_CAP + i)
        if high_key is None:
            high_key = a.load(base + 3)
            right_pid = a.load(base + 2)
        for t, k, v in reversed(records):
            if t == D_INSERT:
                out[k] = v
            else:
                out.pop(k, None)
        # honor the (possibly truncated) key range
        out = {k: v for k, v in out.items() if k < high_key}
        return out, right_pid, high_key

    def _replay_inner(self, head: int) -> Tuple[List[Tuple[int, int]], int,
                                                int, int]:
        """Fold an inner chain into (sorted [(sep_key, child_pid)],
        leftmost_pid, right_pid, high_key)."""
        a = self.arena
        adds: List[Tuple[int, int]] = []
        p = head
        high_key, right_pid = None, None
        while True:
            t = a.load(p)
            if t == D_INDEX:
                adds.append((a.load(p + 1), a.load(p + 2)))
                p = a.load(p + 3)
            elif t == D_SPLIT:
                if high_key is None:
                    high_key = a.load(p + 1)
                    right_pid = a.load(p + 2)
                p = a.load(p + 3)
            else:
                break
        base = p
        n = a.load(base + 1)
        entries = {a.load(base + 8 + i): a.load(base + 8 + INNER_CAP + i)
                   for i in range(n)}
        for k, c in reversed(adds):
            entries[k] = c
        if high_key is None:
            high_key = a.load(base + 3)
            right_pid = a.load(base + 2)
        entries = {k: c for k, c in entries.items() if k < high_key}
        leftmost = a.load(base + 4)
        return sorted(entries.items()), leftmost, right_pid, high_key

    # ------------------------------------------------------------------
    # traversal with help-along (the Condition-#2 helper)
    # ------------------------------------------------------------------
    def _descend(self, key: int, *, help_along: bool) -> List[int]:
        """Return the pid path root→leaf for ``key``; optionally complete
        any unfinished splits discovered on the way."""
        path: List[int] = []
        pid = self.pmem.load(self.super, 0)
        while True:
            path.append(pid)
            head = self._head(pid)
            t = self.arena.load(self._base_of(head))
            if help_along:
                self._help_unfinished_split(path, pid, head)
                head = self._head(pid)
            if t == N_LEAF:
                _, right_pid, high_key = self._replay_leaf(head)
                if key >= high_key and right_pid != NULL:
                    path.pop()
                    pid = right_pid  # side-link move (reads tolerate)
                    continue
                return path
            entries, leftmost, right_pid, high_key = self._replay_inner(head)
            if key >= high_key and right_pid != NULL:
                path.pop()
                pid = right_pid
                continue
            child = leftmost
            for k, c in entries:
                if key >= k:
                    child = c
                else:
                    break
            pid = child

    def _find_unfinished_split(self, head: int) -> Optional[Tuple[int, int]]:
        """Outermost SPLIT delta of ``head``'s chain, if any: (sep, q)."""
        a = self.arena
        p = head
        while a.load(p) in (D_INSERT, D_DELETE, D_SPLIT, D_INDEX):
            if a.load(p) == D_SPLIT:
                return a.load(p + 1), a.load(p + 2)
            p = a.load(p + 3)
        return None

    def _help_unfinished_split(self, path: List[int], pid: int,
                               head: int) -> None:
        split = self._find_unfinished_split(head)
        if split is None:
            return
        sep, q = split
        # Condition #2 conversion: persist the loads the helper acted on
        # (the mapping word and the split delta's line) before acting
        self.pmem.clwb(self.map, pid)
        self.arena.clwb(head)
        self.pmem.fence()
        if len(path) >= 2:
            parent = path[-2]
            entries, _, _, _ = self._replay_inner(self._head(parent))
            if any(c == q for _, c in entries):
                return  # split already completed
            self._post_index_entry(parent, sep, q)
        else:
            # root split: build a new root (leftmost = old root, one sep)
            old_root = pid
            new_root = self._new_inner_base([sep], [q], leftmost=old_root,
                                            right_pid=NULL, high_key=INF)
            self.arena.fence()
            rpid = self._alloc_pid()
            self.pmem.store(self.map, rpid, new_root)
            self.pmem.persist(self.map, rpid)
            if self.pmem.cas(self.super, 0, old_root, rpid):
                self.pmem.persist(self.super, 0)
            # losing the CAS means another helper already grew the tree

    def _post_index_entry(self, parent: int, sep: int, q: int) -> None:
        while True:
            head = self._head(parent)
            entries, _, _, high_key = self._replay_inner(head)
            if any(c == q for _, c in entries):
                return
            delta = self._new_delta(D_INDEX, sep, q, head)
            self.arena.fence()
            if self.pmem.cas(self.map, parent, head, delta):
                self.pmem.persist(self.map, parent)
                self._maybe_consolidate(parent)
                return
            # CAS failed: another writer moved the chain; re-read and retry

    # ------------------------------------------------------------------
    # the five-op interface
    # ------------------------------------------------------------------
    def lookup(self, key: int) -> Optional[int]:
        path = self._descend(key, help_along=False)
        records, _, _ = self._replay_leaf(self._head(path[-1]))
        return records.get(key)

    def insert(self, key: int, value: int) -> bool:
        self._bump_epoch()  # batched readers must re-snapshot
        return self._upsert(D_INSERT, key, value)

    def delete(self, key: int) -> bool:
        if self.lookup(key) is None:
            return False
        self._bump_epoch()
        return self._upsert(D_DELETE, key, 0)

    def update(self, key: int, value: int) -> bool:
        """Native update: a D_INSERT delta published by the usual
        mapping-table CAS — chain replay makes the newest delta win, so
        the delta *is* the update commit (an upsert: absent keys take
        insert semantics).  Overwriting with the current value is a
        no-op: no stores, snapshot epochs stay valid.  The one descent
        and chain replay ``_upsert`` already does serve both the
        current-value check and the commit."""
        return self._upsert(D_INSERT, key, value, overwrite=True)

    def _upsert(self, dtype: int, key: int, value: int,
                overwrite: bool = False) -> bool:
        while True:
            path = self._descend(key, help_along=True)
            pid = path[-1]
            head = self._head(pid)
            records, _, high_key = self._replay_leaf(head)
            if key >= high_key:
                continue  # a split landed between descend and read; retry
            if dtype == D_INSERT and key in records:
                if not overwrite:
                    return False  # no updates via insert (YCSB semantics)
                if records[key] == value:
                    return True  # no-op overwrite: no stores, no bump
            if overwrite:
                # update's writers bump here, only once mutation is
                # certain (insert/delete bump at their entry)
                self._bump_epoch()
            delta = self._new_delta(dtype, key, value, head)
            self.arena.fence()
            # non-SMO commit: single CAS on the mapping word; flush only
            # on success (paper §6.3), no load flushes needed
            if self.pmem.cas(self.map, pid, head, delta):
                self.pmem.persist(self.map, pid)
                if len(records) + 1 > LEAF_CAP:
                    self._split_leaf(path, pid)
                self._maybe_consolidate(pid)
                return True
            # CAS failed → abort and restart from the root (paper §6.3)

    # ------------------------------------------------------------------
    # sharded batched writes (_write_batch wave shard runs)
    # ------------------------------------------------------------------
    def _apply_shard_run(self, ops, positions, results) -> None:
        """Consolidating group commit — the Bw-tree-native batch write.
        The shard is a contiguous key range (prefix routing), so the
        run sorted by key clusters into few leaves; each leaf's delta
        chain is replayed ONCE, the whole group folds into the replayed
        record set, and one copy-on-write consolidated base published
        by the usual mapping-table CAS commits every op at once (the
        scalar consolidation protocol, doing the work of a group of
        delta prepends).  Groups that would overflow the leaf defer one
        op to the scalar path (which splits), then resume; stable
        sorting preserves same-key op history."""
        order = sorted(positions, key=lambda p: ops[p][1])
        i, n = 0, len(order)
        while i < n:
            key0 = int(ops[order[i]][1])
            path = self._descend(key0, help_along=True)
            pid = path[-1]
            head = self._head(pid)
            records, right_pid, high_key = self._replay_leaf(head)
            if key0 >= high_key:
                continue  # a split landed between descend and read
            j = i
            while j < n and int(ops[order[j]][1]) < high_key:
                j += 1
            group = order[i:j]
            folded = dict(records)
            staged: List[Tuple[int, bool]] = []
            changed = False
            overflow = False
            for pos in group:
                kind, key, value = ops[pos]
                key, value = int(key), int(value)
                if kind == "insert":
                    if key in folded:
                        staged.append((pos, False))
                        continue
                    if len(folded) >= LEAF_CAP:
                        overflow = True
                        break
                    folded[key] = value
                    changed = True
                elif kind == "update":
                    if folded.get(key) == value:
                        staged.append((pos, True))  # no-op overwrite
                        continue
                    if key not in folded and len(folded) >= LEAF_CAP:
                        overflow = True
                        break
                    folded[key] = value
                    changed = True
                else:  # delete
                    if key not in folded:
                        staged.append((pos, False))
                        continue
                    del folded[key]
                    changed = True
                staged.append((pos, True))
            if changed and len(group) == 1:
                # a singleton gains nothing from consolidation: post the
                # one delta exactly as the scalar _upsert would
                pos, r = staged[0]
                kind, key, value = ops[pos]
                key, value = int(key), int(value)
                self._bump_epoch()
                dtype = D_DELETE if kind == "delete" else D_INSERT
                delta = self._new_delta(dtype, key,
                                        value if dtype == D_INSERT else 0,
                                        head)
                self.arena.fence()
                if not self.pmem.cas(self.map, pid, head, delta):
                    continue  # raced; re-descend and retry
                self.pmem.persist(self.map, pid)
                if dtype == D_INSERT and len(records) + 1 > LEAF_CAP:
                    self._split_leaf(path, pid)
                self._maybe_consolidate(pid)
                results[pos] = r
                i += 1
                continue
            if changed and len(folded) > LEAF_CAP:
                # oversized replay (a split is due): never truncate —
                # run the first op scalar (delta + split), then retry
                pos = order[i]
                kind, key, value = ops[pos]
                results[pos] = self._apply_write(kind, int(key), int(value))
                i += 1
                continue
            if changed:
                # one CoW consolidated base carries the whole group;
                # the mapping CAS is the single commit point
                self._bump_epoch()
                items = sorted(folded.items())
                node = self._new_leaf_base([k for k, _ in items],
                                           [v for _, v in items],
                                           right_pid=right_pid,
                                           high_key=high_key)
                self.arena.fence()
                if not self.pmem.cas(self.map, pid, head, node):
                    continue  # raced; re-descend and retry the group
                self.pmem.persist(self.map, pid)
            for pos, r in staged:
                results[pos] = r
            i += len(staged)
            if overflow:
                # the op that would overflow runs scalar (delta + split)
                pos = order[i]
                kind, key, value = ops[pos]
                results[pos] = self._apply_write(kind, int(key), int(value))
                i += 1

    # ------------------------------------------------------------------
    # consolidation + the 2-step split SMO
    # ------------------------------------------------------------------
    def _chain_len(self, head: int) -> int:
        a = self.arena
        n, p = 0, head
        while a.load(p) in (D_INSERT, D_DELETE, D_SPLIT, D_INDEX):
            n += 1
            p = a.load(p + 3)
        return n

    def _maybe_consolidate(self, pid: int) -> None:
        head = self._head(pid)
        if self._chain_len(head) < CHAIN_MAX:
            return
        a = self.arena
        t = a.load(self._base_of(head))
        if t == N_LEAF:
            records, right_pid, high_key = self._replay_leaf(head)
            if len(records) > LEAF_CAP:
                return  # oversized: a split must run first, never truncate
            items = sorted(records.items())
            node = self._new_leaf_base([k for k, _ in items],
                                       [v for _, v in items],
                                       right_pid=right_pid, high_key=high_key)
        else:
            entries, leftmost, right_pid, high_key = self._replay_inner(head)
            if len(entries) > INNER_CAP:
                return
            node = self._new_inner_base([k for k, _ in entries],
                                        [c for _, c in entries],
                                        leftmost=leftmost,
                                        right_pid=right_pid, high_key=high_key)
        a.fence()
        if self.pmem.cas(self.map, pid, head, node):
            self.pmem.persist(self.map, pid)
        # losing the race just leaves our consolidation as garbage

    def _split_leaf(self, path: List[int], pid: int) -> None:
        head = self._head(pid)
        records, right_pid, high_key = self._replay_leaf(head)
        if len(records) <= LEAF_CAP:
            return
        items = sorted(records.items())
        mid = len(items) // 2
        sep = items[mid][0]
        # step 0 (all unreachable until the CAS): sibling base + mapping
        sib = self._new_leaf_base([k for k, _ in items[mid:]],
                                  [v for _, v in items[mid:]],
                                  right_pid=right_pid, high_key=high_key)
        self.arena.fence()
        q = self._alloc_pid()
        self.pmem.store(self.map, q, sib)
        self.pmem.persist(self.map, q)
        # STEP 1: CAS the split delta onto the child
        delta = self._new_delta(D_SPLIT, sep, q, head)
        self.arena.fence()
        if not self.pmem.cas(self.map, pid, head, delta):
            return  # another writer raced; its path will handle the split
        self.pmem.persist(self.map, pid)
        # STEP 2: post the index entry in the parent (helpers can do this
        # too if we crash right here — that is the Condition-#2 story)
        self._help_unfinished_split(path, pid, self._head(pid))
        self._maybe_split_inner(path)

    def _maybe_split_inner(self, path: List[int]) -> None:
        if len(path) < 2:
            return
        pid = path[-2]
        entries, leftmost, right_pid, high_key = \
            self._replay_inner(self._head(pid))
        if len(entries) <= INNER_CAP:
            return
        head = self._head(pid)
        mid = len(entries) // 2
        sep = entries[mid][0]
        upper = entries[mid:]
        sib = self._new_inner_base([k for k, _ in upper[1:]],
                                   [c for _, c in upper[1:]],
                                   leftmost=upper[0][1],
                                   right_pid=right_pid, high_key=high_key)
        self.arena.fence()
        q = self._alloc_pid()
        self.pmem.store(self.map, q, sib)
        self.pmem.persist(self.map, q)
        delta = self._new_delta(D_SPLIT, sep, q, head)
        self.arena.fence()
        if not self.pmem.cas(self.map, pid, head, delta):
            return
        self.pmem.persist(self.map, pid)
        self._help_unfinished_split(path[:-1], pid, self._head(pid))

    # ------------------------------------------------------------------
    # ordered iteration (follow leaf side links)
    # ------------------------------------------------------------------
    def _leftmost_leaf(self) -> int:
        pid = self.pmem.load(self.super, 0)
        while True:
            head = self._head(pid)
            if self.arena.load(self._base_of(head)) == N_LEAF:
                return pid
            _, leftmost, _, _ = self._replay_inner(head)
            pid = leftmost

    def items(self) -> Iterator[Tuple[int, int]]:
        pid = self._leftmost_leaf()
        while pid != NULL:
            records, right_pid, _ = self._replay_leaf(self._head(pid))
            for k in sorted(records):
                yield k, records[k]
            pid = right_pid

    def keys(self) -> Iterator[int]:
        for k, _ in self.items():
            yield k

    def range_query(self, key_lo: int, key_hi: int) -> List[Tuple[int, int]]:
        out = []
        path = self._descend(key_lo, help_along=False)
        pid = path[-1]
        while pid != NULL:
            records, right_pid, high_key = self._replay_leaf(self._head(pid))
            for k in sorted(records):
                if key_lo <= k <= key_hi:
                    out.append((k, records[k]))
            if high_key > key_hi:
                break
            pid = right_pid
        return out

    def scan(self, start_key: int, count: int) -> List[Tuple[int, int]]:
        """Descend to start_key's leaf and follow the side links,
        replaying each delta chain once."""
        out: List[Tuple[int, int]] = []
        pid = self._descend(start_key, help_along=False)[-1]
        while pid != NULL and len(out) < count:
            records, right_pid, _ = self._replay_leaf(self._head(pid))
            for k in sorted(records):
                if k >= start_key:
                    out.append((k, records[k]))
                    if len(out) >= count:
                        break
            pid = right_pid
        return out

    # ------------------------------------------------------------------
    # data-plane export: the sorted leaf run for the shared scan kernel
    # ------------------------------------------------------------------
    def export_arrays(self) -> Optional[dict]:
        """Page-major flattening of the leaf level with every delta
        chain folded in: one sorted run of live (key, value) pairs,
        probed by kernels/scan.  ``items`` honors SPLIT-delta key-range
        truncation, so the run matches what a scalar reader resolves —
        including unfinished splits (Condition #2 states)."""
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
        """Scales with the last export's entry count: the export replays
        every leaf chain once."""
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
        assert ks == sorted(ks), "leaf chain out of order"
        assert len(ks) == len(set(ks)), "duplicate keys across leaves"

    def _walk(self) -> Iterator[Tuple[int, int]]:
        a = self.arena
        seen = set()
        stack = [self.pmem.load(self.super, 0)]
        while stack:
            pid = stack.pop()
            if pid in seen or pid == NULL:
                continue
            seen.add(pid)
            p = self._head(pid)
            while a.load(p) in (D_INSERT, D_DELETE, D_SPLIT, D_INDEX):
                yield p, DELTA_WORDS
                if a.load(p) in (D_SPLIT, D_INDEX):
                    stack.append(a.load(p + 2))
                p = a.load(p + 3)
            if a.load(p) == N_LEAF:
                yield p, LEAF_WORDS
                base_right = a.load(p + 2)
                stack.append(base_right)
            else:
                yield p, INNER_WORDS
                stack.append(a.load(p + 4))
                n = a.load(p + 1)
                for i in range(n):
                    stack.append(a.load(p + 8 + INNER_CAP + i))
                stack.append(a.load(p + 2))

    def gc(self) -> int:
        return self.arena.gc(self._walk)
