"""Operation plans and the conflict-wave scheduler.

The one public execution surface of the converted indexes: a ``Plan``
is a mixed sequence of GET/PUT/UPDATE/DELETE/SCAN ops with per-op
result slots, and ``RecipeIndex.execute(plan)`` runs it with results
positionally identical to applying the ops one at a time in program
order — the contract every driver (YCSB's PhaseExecutor, the
``repro_torch.api`` facade) builds on.  Ported from ``repro.core.plan``
unchanged: the scheduler is host numpy code, and its waves, widths and
results match the reference exactly.

Ordering semantics: **per-key program order, cross-key freedom.**  Two
ops may be reordered or batched together exactly when neither could
observe the other — reads never conflict with reads (including scans
over identical start keys), a read conflicts with a write of the same
key (or, for scans, a write landing at or above the start key), and
writes of independent keys commute.  ``schedule_waves`` partitions a
plan into maximal conflict-free *waves* under that relation
(kernels/conflict owns the pairwise rules and the peeling oracle);
each wave then runs as ONE batched dispatch:

* read wave  → ``_lookup_batch``  (the probe, radix-descent or
  sorted-run search kernel of the index),
* scan wave  → ``_scan_batch``    (the sorted-run search kernel:
  lower bound + window gather),
* write wave → ``_write_batch``   (kernels/partition shard routing +
  one ``PMem.group_commit`` persist epoch per shard run; same-key
  writes share a wave because the stable partition preserves their
  arrival order).

Waves execute in level order, so a crash mid-plan leaves a
*plan-prefix-consistent* image: every key's durable state is some
prefix of that key's op history in the plan (ops of one key in one
wave ride a single group-commit epoch — all or nothing), and no op of
a later wave can be visible before an op of an earlier one.

Scheduling cost: plans without scans (the YCSB A/B/C/D/F shapes) are
leveled fully vectorized — stable-sort by key, count read/write
alternations per key run with a cumulative sum.  Plans mixing scans
and writes fall back to a sequential sweep with per-level range
summaries (max write key / min scan start per level), still exact
against the oracle.  Read-only and write-only plans skip leveling
entirely.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.conflict import DELETE, GET, PUT, SCAN, UPDATE
from ..obs import RECORDER as _OBS
from .conditions import PROBE_STAT_KEYS


class OpKind(enum.IntEnum):
    """Plan op kinds.  Codes are shared with kernels/conflict."""

    GET = GET
    PUT = PUT
    UPDATE = UPDATE
    DELETE = DELETE
    SCAN = SCAN


_KIND_TO_WRITE_NAME = {PUT: "insert", UPDATE: "update", DELETE: "delete"}
_WRITE_NAME_TO_KIND = {"insert": PUT, "update": UPDATE, "delete": DELETE,
                       "lookup": GET, "scan": SCAN}
_WRITE_CODES = (PUT, UPDATE, DELETE)


@dataclasses.dataclass(frozen=True)
class Op:
    """One plan op.  ``aux`` is the value for PUT/UPDATE, ignored for
    GET/DELETE, and the record count for SCAN."""

    kind: OpKind
    key: int
    aux: int = 0


class Plan:
    """An ordered sequence of ops with per-op result slots.

    Build incrementally (``get``/``put``/``update``/``delete``/
    ``scan`` each append one op and return its slot index), from an
    op list (``from_ops``), or — the zero-copy driver path — from
    parallel kind/key/aux arrays (``from_arrays``).  Execute with
    ``RecipeIndex.execute(plan)``; slot ``i`` of the returned
    ``PlanResult`` holds op ``i``'s result:

    * GET    → ``Optional[int]`` (the value, or None),
    * PUT/UPDATE/DELETE → ``bool`` (the scalar op's ack),
    * SCAN   → ``List[Tuple[key, value]]``.
    """

    __slots__ = ("_kinds", "_keys", "_aux", "_arrays", "_waves")

    def __init__(self) -> None:
        self._kinds: List[int] = []
        self._keys: List[int] = []
        self._aux: List[int] = []
        self._arrays: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._waves: Optional[List["Wave"]] = None

    # -- builders ---------------------------------------------------------
    def _append(self, kind: int, key: int, aux: int) -> int:
        if self._arrays is not None and not self._kinds:
            # appending to a from_arrays plan: materialize the backing
            # lists first so the array-built ops are kept
            kinds, keys, aux_arr = self._arrays
            self._kinds = kinds.tolist()
            self._keys = keys.tolist()
            self._aux = aux_arr.tolist()
        self._arrays = None
        self._waves = None
        self._kinds.append(kind)
        self._keys.append(key)
        self._aux.append(aux)
        return len(self._kinds) - 1

    def get(self, key: int) -> int:
        return self._append(GET, key, 0)

    def put(self, key: int, value: int) -> int:
        return self._append(PUT, key, value)

    def update(self, key: int, value: int) -> int:
        return self._append(UPDATE, key, value)

    def delete(self, key: int) -> int:
        return self._append(DELETE, key, 0)

    def scan(self, start_key: int, count: int) -> int:
        return self._append(SCAN, start_key, count)

    @classmethod
    def from_ops(cls, ops: Sequence) -> "Plan":
        """From ``Op`` objects or ``(kind, key, aux)`` tuples, where
        kind is an ``OpKind``, an int code, or one of the legacy
        YCSB op names (lookup/insert/update/delete/scan)."""
        plan = cls()
        for op in ops:
            if isinstance(op, Op):
                kind, key, aux = int(op.kind), op.key, op.aux
            else:
                kind, key, aux = op
                if isinstance(kind, str):
                    kind = _WRITE_NAME_TO_KIND[kind]
                kind = int(kind)
            plan._append(kind, int(key), int(aux))
        return plan

    @classmethod
    def from_arrays(cls, kinds: np.ndarray, keys: np.ndarray,
                    aux: np.ndarray) -> "Plan":
        """Wrap pre-built parallel arrays (no per-op Python work): the
        PhaseExecutor's vectorized construction path."""
        kinds = np.asarray(kinds, np.int32)
        keys = np.asarray(keys, np.int64)
        aux = np.asarray(aux, np.int64)
        assert kinds.shape == keys.shape == aux.shape
        plan = cls()
        plan._arrays = (kinds, keys, aux)
        return plan

    # -- views ------------------------------------------------------------
    def __len__(self) -> int:
        if self._arrays is not None:
            return int(self._arrays[0].shape[0])
        return len(self._kinds)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(kinds int32, keys int64, aux int64), memoized."""
        if self._arrays is None:
            n = len(self._kinds)
            self._arrays = (np.asarray(self._kinds, np.int32),
                            np.asarray(self._keys, np.int64),
                            np.asarray(self._aux, np.int64))
        return self._arrays

    def ops(self) -> Iterator[Op]:
        kinds, keys, aux = self.arrays()
        for k, key, a in zip(kinds.tolist(), keys.tolist(), aux.tolist()):
            yield Op(OpKind(k), key, a)

    def waves(self) -> List["Wave"]:
        """Conflict-free wave schedule of this plan (``schedule_waves``),
        memoized.  Scheduling is a pure function of the op sequence and
        never touches an index, so a pipelined builder may pre-compute
        it off the executor's critical path; ``run_plan`` picks the memo
        up instead of re-scheduling."""
        if self._waves is None:
            kinds, keys, _ = self.arrays()
            self._waves = schedule_waves(kinds, keys)
        return self._waves


@dataclasses.dataclass(frozen=True)
class Wave:
    """One conflict-free dispatch: all reads, all scans, or all
    writes, identified by the plan positions it covers (ascending, so
    arrival order survives into the stable write partition)."""

    kind: str  # "read" | "scan" | "write"
    indices: np.ndarray


@dataclasses.dataclass
class PlanResult:
    """Per-op result slots plus scheduler telemetry."""

    results: List[Any]
    wave_kinds: List[str]
    wave_widths: List[int]
    # result tallies (found GETs, acked writes, records scanned) —
    # computed during wave scatter so drivers need no second pass
    found: int = 0
    acked: int = 0
    scanned: int = 0
    # probe-traffic deltas over this plan (PROBE_STAT_KEYS): the
    # fingerprint filter's compare/candidate/hit/false-positive
    # tallies, the modeled PM gather words, and the optimistic read
    # path's probe/retry counts.  Sums exactly across sub-plan merges.
    probe: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in PROBE_STAT_KEYS})

    @property
    def n_waves(self) -> int:
        return len(self.wave_widths)

    @property
    def mean_wave_width(self) -> float:
        if not self.wave_widths:
            return 0.0
        return sum(self.wave_widths) / len(self.wave_widths)


# -- wave scheduling -------------------------------------------------------

def _levels_no_scan(kinds: np.ndarray, keys: np.ndarray, *,
                    push_reads_late: bool = True) -> np.ndarray:
    """Vectorized levels for plans without scans: conflicts are purely
    per-key GET↔write alternations.  Stable-sort by key, flag
    read/write class changes inside each key run; the *earliest legal*
    level is the cumulative alternation count since the run started
    (exactly the kernels/conflict peeling oracle).

    ``push_reads_late`` then reassigns every read to the latest legal
    level — one below its key's next write, or the plan's last level
    when none follows (the state a read observes is constant anywhere
    in that window, so results cannot change).  Late reads merge into
    fewer, wider read waves, and each merged wave saves a snapshot
    re-export: YCSB-D's read-latest stream collapses from one read
    wave per conflict level (an export each) to a single post-write
    read wave."""
    n = kinds.shape[0]
    is_write = kinds != GET
    order = np.argsort(keys, kind="stable")
    k_sorted = keys[order]
    w_sorted = is_write[order]
    new_key = np.empty(n, bool)
    new_key[0] = True
    np.not_equal(k_sorted[1:], k_sorted[:-1], out=new_key[1:])
    alt = np.empty(n, bool)
    alt[0] = False
    np.not_equal(w_sorted[1:], w_sorted[:-1], out=alt[1:])
    alt[new_key] = False
    calt = np.cumsum(alt)
    # per-position alternation count at the key run's start: the most
    # recent run start dominates the running maximum because calt is
    # non-decreasing
    base = np.maximum.accumulate(np.where(new_key, calt, 0))
    lvl_sorted = calt - base
    if push_reads_late and bool(is_write.any()):
        # next same-key write per position: levels are non-decreasing
        # along a key run, so the nearest later write is found with one
        # searchsorted over the write positions, bounded by the run end
        starts = np.nonzero(new_key)[0]
        ends = np.append(starts[1:], n)
        seg_end = np.repeat(ends, ends - starts)
        wpos = np.nonzero(w_sorted)[0]
        nxt = np.searchsorted(wpos, np.arange(n), side="right")
        cand = wpos[np.minimum(nxt, len(wpos) - 1)]
        has_next = (nxt < len(wpos)) & (cand < seg_end)
        maxlvl = int(lvl_sorted.max())
        pushed = np.where(has_next, lvl_sorted[cand] - 1, maxlvl)
        lvl_sorted = np.where(w_sorted, lvl_sorted, pushed)
    levels = np.empty(n, np.int64)
    levels[order] = lvl_sorted
    return levels


_KEY_FLOOR = -(1 << 62)  # below every PM word
_KEY_CEIL = 1 << 62      # above every PM word


def _levels_general(kinds: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Sequential exact levels for plans mixing scans and writes.

    Per-key GET↔write chains are tracked with a last-op map; the
    cross-key scan↔write conflicts reduce exactly to per-level range
    summaries — a scan at start ``s`` conflicts with level ``L``'s
    write wave iff ``max_write_key[L] >= s``, and a write at ``k``
    conflicts with level ``L``'s scan wave iff
    ``min_scan_start[L] <= k`` — because the conservative scan window
    is the half-open ``[start, +inf)``."""
    n = kinds.shape[0]
    levels = np.empty(n, np.int64)
    last: dict = {}  # key -> (level, was_write)
    max_wkey: List[int] = []   # per level: max write key
    min_scan: List[int] = []   # per level: min scan start
    klist = kinds.tolist()
    keylist = keys.tolist()
    for i in range(n):
        kind, key = klist[i], keylist[i]
        if kind == SCAN:
            lvl = 0
            for L in range(len(max_wkey) - 1, -1, -1):
                if max_wkey[L] >= key:
                    lvl = L + 1
                    break
            while len(min_scan) <= lvl:
                min_scan.append(_KEY_CEIL)
            if key < min_scan[lvl]:
                min_scan[lvl] = key
        elif kind == GET:
            prev = last.get(key)
            lvl = 0 if prev is None else prev[0] + prev[1]
            last[key] = (lvl, 0)
        else:  # write
            prev = last.get(key)
            lvl = 0 if prev is None else prev[0] + (1 - prev[1])
            for L in range(len(min_scan) - 1, -1, -1):
                if min_scan[L] <= key:
                    if L + 1 > lvl:
                        lvl = L + 1
                    break
            last[key] = (lvl, 1)
            while len(max_wkey) <= lvl:
                max_wkey.append(_KEY_FLOOR)
            if key > max_wkey[lvl]:
                max_wkey[lvl] = key
        levels[i] = lvl
    # push reads late (see _levels_no_scan): a GET may run at any level
    # up to one below its key's next write; scans stay pinned (their
    # window-conflict structure is range-based, not per-key)
    maxlvl = int(levels.max())
    next_write: dict = {}
    for i in range(n - 1, -1, -1):
        kind = klist[i]
        if kind == GET:
            nw = next_write.get(keylist[i])
            levels[i] = maxlvl if nw is None else nw - 1
        elif kind != SCAN:
            next_write[keylist[i]] = levels[i]
    return levels


def schedule_waves(kinds: np.ndarray, keys: np.ndarray) -> List[Wave]:
    """Partition a plan into maximal conflict-free waves, level by
    level (reads, then scans, then writes within a level — order free,
    since conflicting ops never share a level)."""
    n = kinds.shape[0]
    if n == 0:
        return []
    is_scan = kinds == SCAN
    is_write = (kinds == PUT) | (kinds == UPDATE) | (kinds == DELETE)
    has_scan = bool(is_scan.any())
    has_write = bool(is_write.any())
    if not has_write:
        waves = []
        if not is_scan.all():
            waves.append(Wave("read", np.nonzero(~is_scan)[0]))
        if has_scan:
            waves.append(Wave("scan", np.nonzero(is_scan)[0]))
        return waves
    if is_write.all():
        return [Wave("write", np.arange(n))]
    if not has_scan:
        levels = _levels_no_scan(kinds, keys)
    else:
        levels = _levels_general(kinds, keys)
    waves: List[Wave] = []
    is_get = kinds == GET
    for lvl in range(int(levels.max()) + 1):
        at = levels == lvl
        for wkind, mask in (("read", at & is_get), ("scan", at & is_scan),
                            ("write", at & is_write)):
            idx = np.nonzero(mask)[0]
            if idx.size:
                waves.append(Wave(wkind, idx))
    return waves


# -- plan execution --------------------------------------------------------

def _run_single(index, kind: int, key: int, aux: int,
                result: PlanResult) -> None:
    """Single-op plans degenerate to the scalar path: no snapshot
    export, no partition, no kernel dispatch."""
    key, aux = int(key), int(aux)
    wave_kind = ("scan" if kind == SCAN else
                 "read" if kind == GET else "write")
    with _OBS.span("plan.wave", kind=wave_kind, wave=0, width=1) as sp:
        c0 = index.pmem.counters.snapshot() if sp else None
        if kind == GET:
            r = index.lookup(key)
            result.found += r is not None
        elif kind == SCAN:
            r = index.scan(key, aux)
            result.scanned += len(r)
        else:
            r = index._apply_write(_KIND_TO_WRITE_NAME[kind], key, aux)
            result.acked += bool(r)
        if sp:
            d = index.pmem.counters.delta(c0)
            sp.set(stores=d.stores, loads=d.loads, clwb=d.clwb,
                   fence=d.fence, lines_touched=d.lines_touched)
    result.results[0] = r
    result.wave_kinds.append(wave_kind)
    result.wave_widths.append(1)


def run_plan(index, plan: Plan, *, force_kernel: bool = False,
             collect_results: bool = True) -> PlanResult:
    """Execute ``plan`` against ``index``; see ``RecipeIndex.execute``
    for the contract.  ``force_kernel`` is passed through to the read
    and scan wave primitives (steady-loop callers keep scalar lookups
    off their hot path).
    ``collect_results=False`` skips scattering per-op results into
    slots — the tallies (found/acked/scanned) are still exact — for
    tally-only drivers like the YCSB PhaseExecutor."""
    n = len(plan)
    result = PlanResult(results=[None] * n if collect_results else [],
                        wave_kinds=[], wave_widths=[])
    if n == 0:
        return result
    kinds, keys, aux = plan.arrays()
    probe0 = dict(getattr(index, "probe_stats", None) or {})
    with _OBS.span("plan.execute", n_ops=n):
        if n == 1 and collect_results and not force_kernel:
            # degenerate to the scalar path — unless the caller forced
            # the kernel, an explicit request to (re)warm the snapshot
            _run_single(index, int(kinds[0]), keys[0], aux[0], result)
            return result
        with _OBS.span("plan.schedule", n_ops=n):
            waves = plan.waves()
        results = result.results
        # keys the plan's write waves have stored so far: a read wave
        # scheduled after a write wave may overlap it optimistically —
        # probe the pre-write snapshot, then re-validate shard write
        # versions against exactly this set (RecipeIndex
        # ._optimistic_lookup)
        written: Optional[np.ndarray] = None
        for wi, wave in enumerate(waves):
            idx = wave.indices
            result.wave_kinds.append(wave.kind)
            result.wave_widths.append(int(idx.size))
            with _OBS.span("plan.wave", kind=wave.kind, wave=wi,
                           width=int(idx.size)) as sp:
                c0 = index.pmem.counters.snapshot() if sp else None
                p0 = (dict(index.probe_stats)
                      if sp and hasattr(index, "probe_stats") else None)
                if wave.kind == "read":
                    with _OBS.span("plan.lookup_batch", width=int(idx.size)):
                        out = index._lookup_batch(keys[idx],
                                                  force_kernel=force_kernel,
                                                  overlap_writes=written)
                    result.found += len(out) - out.count(None)
                elif wave.kind == "scan":
                    with _OBS.span("plan.scan_batch", width=int(idx.size)):
                        out = index._scan_batch(keys[idx], aux[idx],
                                                force_kernel=force_kernel)
                    result.scanned += sum(map(len, out))
                else:
                    ops = [(_KIND_TO_WRITE_NAME[k], key, a)
                           for k, key, a in zip(kinds[idx].tolist(),
                                                keys[idx].tolist(),
                                                aux[idx].tolist())]
                    with _OBS.span("plan.write_batch", width=int(idx.size)):
                        out = index._write_batch(ops)
                    result.acked += sum(map(bool, out))
                    written = (keys[idx] if written is None
                               else np.concatenate([written, keys[idx]]))
                if sp:
                    d = index.pmem.counters.delta(c0)
                    sp.set(stores=d.stores, loads=d.loads, clwb=d.clwb,
                           fence=d.fence, lines_touched=d.lines_touched)
                    if p0 is not None:
                        ps = index.probe_stats
                        sp.set(pm_load_words=ps["pm_load_words"]
                               - p0["pm_load_words"],
                               fp_candidates=ps["candidates"]
                               - p0["candidates"],
                               optimistic_retries=ps["optimistic_retries"]
                               - p0["optimistic_retries"])
            if collect_results:
                for i, r in zip(idx.tolist(), out):
                    results[i] = r
    pstats = getattr(index, "probe_stats", None)
    if pstats:
        for k in result.probe:
            result.probe[k] = pstats.get(k, 0) - probe0.get(k, 0)
    return result


__all__ = ["Op", "OpKind", "Plan", "PlanResult", "Wave", "run_plan",
           "schedule_waves"]
