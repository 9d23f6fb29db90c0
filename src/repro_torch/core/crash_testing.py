"""Crash-recovery testing for batched plans over PM indexes (paper §5).

Ported from ``repro.core.crash_testing``: the image snapshot/restore
(``PMSnapshot``) and the group-commit crash-point sweep over batched
plans (``plan_crash_sweep``).  The unit of failure atomicity there is
the persist epoch the wave executor opens per shard run: the sweep
crashes a plan at each outermost group-commit boundary and inside each
optimistic-read validation window, recovers, and checks that every
key holds some prefix of its own op history.  The per-store scalar
sweep and the durability audit of the JAX package are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .pmem import CrashPoint, PMem

Op = Tuple[str, int, int]  # (kind, key, value): insert/update/delete/lookup


# ----------------------------------------------------------------------
# snapshot / restore (regions keep object identity so indexes may cache
# only the regions they created in __init__)
# ----------------------------------------------------------------------
class PMSnapshot:
    def __init__(self, pmem: PMem, index: object = None):
        self.regions = {
            rid: (r, r.cache.copy(), r.pm.copy(), set(r.dirty), set(r.pending))
            for rid, r in pmem.regions.items()
        }
        self.next_rid = pmem._next_rid
        self.alloc_log = list(pmem.alloc_log)
        self.index = index
        self.vol = index.volatile_state() if hasattr(index, "volatile_state") else None

    def restore(self, pmem: PMem) -> None:
        pmem.regions = {}
        for rid, (r, cache, pm, dirty, pending) in self.regions.items():
            r.cache[:] = cache
            r.pm[:] = pm
            r.dirty = set(dirty)
            r.pending = set(pending)
            pmem.regions[rid] = r
        pmem._next_rid = self.next_rid
        pmem.alloc_log = list(self.alloc_log)
        with pmem._lock_mutex:
            pmem.locks.clear()
            pmem._shared.clear()
        pmem.disarm_crash()
        if self.vol is not None:
            self.index.set_volatile_state(self.vol)


@dataclasses.dataclass
class CrashReport:
    index_name: str
    n_crash_states: int = 0
    n_ops_tested: int = 0
    consistency_failures: List[str] = dataclasses.field(default_factory=list)
    durability_failures: List[str] = dataclasses.field(default_factory=list)
    stall_failures: List[str] = dataclasses.field(default_factory=list)
    max_stores_per_op: int = 0

    @property
    def ok(self) -> bool:
        return not (self.consistency_failures or self.durability_failures
                    or self.stall_failures)

    def summary(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        return (f"{self.index_name}: {status} — {self.n_crash_states} crash states "
                f"over {self.n_ops_tested} ops (max {self.max_stores_per_op} "
                f"stores/op); {len(self.consistency_failures)} consistency, "
                f"{len(self.durability_failures)} durability, "
                f"{len(self.stall_failures)} stall failures")


# ----------------------------------------------------------------------
# group-commit crash-point sweep over the batched plan surface
# ----------------------------------------------------------------------
def group_commit_boundaries(pmem: PMem, run: Callable[[], None]) -> List[int]:
    """Execute ``run()`` with a spy on ``pmem.group_commit`` and return
    the crash-call offset (relative to the call) of every *outermost*
    persist epoch it opens.  Nested opens are free — only depth-0
    boundaries are durability events (the close emits the clwb batch +
    commit fence).  Offsets are in ``pmem.crash_calls`` units — the
    unit ``arm_crash`` counts down in — so they stay aligned even when
    the run hits store-free crash points (``PMem.crash_point``, the
    optimistic read validation window)."""
    boundaries: List[int] = []
    c0 = pmem.crash_calls
    orig = pmem.group_commit

    def spy(*args, **kwargs):
        if pmem._group_depth == 0:
            boundaries.append(pmem.crash_calls - c0)
        return orig(*args, **kwargs)

    pmem.group_commit = spy
    try:
        run()
    finally:
        pmem.group_commit = orig
    return boundaries


def validation_points(pmem: PMem, run: Callable[[], None]) -> List[int]:
    """Execute ``run()`` with a spy on ``pmem.crash_point`` and return
    the crash-call offset of every explicit crash point it passes —
    each is an optimistic read's window between the overlapped probe
    and its version re-validation.  Arming ``arm_crash`` at such an
    offset makes the crash land exactly inside that window."""
    points: List[int] = []
    c0 = pmem.crash_calls
    orig = pmem.crash_point

    def spy():
        points.append(pmem.crash_calls - c0)
        return orig()

    pmem.crash_point = spy
    try:
        run()
    finally:
        del pmem.crash_point  # restore the class method
    return points


def plan_prefix_states(ops: Sequence[Op],
                       base: Optional[Dict[int, int]] = None
                       ) -> Tuple[Dict[int, set], Dict[int, int]]:
    """Per key: every durable value the key may legally hold after a
    crash anywhere in a batched plan over ``ops`` — its pre-plan state
    (``None``, or its value in the already-committed ``base`` model)
    plus the value after each of its ops in program order.
    Group-commit epochs ack atomically and the wave scheduler
    preserves per-key program order, so a recovered key must sit at
    SOME prefix of its own op history.  Returns ``(states,
    final_model)``."""
    states: Dict[int, set] = {}
    model: Dict[int, int] = dict(base or {})
    for kind, k, v in ops:
        states.setdefault(k, {model.get(k)})
        if kind == "insert":
            model.setdefault(k, v)  # CLHT-style: insert won't overwrite
        elif kind == "update":
            model[k] = v
        elif kind == "delete":
            model.pop(k, None)
        states[k].add(model.get(k))
    return states, model


def plan_crash_sweep(
    factory: Callable[[PMem], object],
    ops: Sequence[Op],
    *,
    setup_ops: Optional[Sequence[Op]] = None,
    max_points: Optional[int] = 6,
    mode: str = "powerfail",
    seed: int = 0,
) -> CrashReport:
    """Crash a *batched plan* at every outermost group-commit boundary
    and inside every optimistic-read validation window.

    Complements :func:`run_crash_sweep` (which crashes inside scalar
    ops): here the unit of failure atomicity is the persist epoch the
    wave executor opens per shard run, so we dry-run the plan once with
    :func:`group_commit_boundaries`, then re-run from a restored image
    with a crash armed at (and one crash call past) each boundary.
    The dry run also records every ``PMem.crash_point`` the plan
    passes (:func:`validation_points` — an overlapped read wave's
    window between its optimistic probe and the version re-validation)
    and those offsets join the sweep: a crash there must likewise
    recover to a plan-prefix-consistent image, and no torn or
    stale-beyond-epoch value can have been returned (the read wave's
    results never materialize — CrashPoint unwinds ``execute`` before
    the wave scatters).  After powerfail + recover, every key must
    hold a legal plan-prefix state (:func:`plan_prefix_states`),
    invariants must hold, and new writes must succeed; a final clean
    run must reproduce the model exactly.  ``max_points`` caps the
    armed offsets, sampling evenly across the plan; ``None`` sweeps
    every boundary.

    ``setup_ops`` run (and fully commit) as their own plan before the
    swept plan's snapshot is taken — use them to pre-populate the
    index and warm its batched-read export so the swept plan's read
    waves can actually overlap its write waves; their final model is
    the committed base of the prefix-state oracle.  Every armed re-run
    re-primes that export at the restored image, so the re-run's
    crash-call trajectory matches the dry run exactly and the armed
    offsets land where they were recorded.
    """
    from .plan import Plan

    pmem = PMem(seed=seed)
    index = factory(pmem)
    report = CrashReport(index_name=type(index).__name__)
    plan = Plan.from_ops(ops)
    base: Dict[int, int] = {}
    if setup_ops:
        index.execute(Plan.from_ops(setup_ops), collect_results=False)
        base = plan_prefix_states(setup_ops)[1]
    snap = PMSnapshot(pmem, index)

    def prime() -> None:
        # rebuild the batched-read export at the (restored) image:
        # PMSnapshot does not roll back the monotonic store counters,
        # so the cached export from a previous run always looks
        # foreign — re-exporting re-arms the optimistic overlap path
        # identically on the dry run and on every armed re-run
        if not hasattr(index, "snapshot"):
            return
        index._snapshot = None
        index._accounted_stores = index._write_account()
        try:
            index.snapshot()
        except NotImplementedError:
            pass

    prime()
    vpoints: List[int] = []
    boundaries = group_commit_boundaries(
        pmem, lambda: vpoints.extend(validation_points(
            pmem, lambda: index.execute(plan, collect_results=False))))
    if not boundaries:
        report.stall_failures.append("plan opened no persist epochs")
        return report
    states, model = plan_prefix_states(ops, base=base)
    for k, v in base.items():
        # committed setup keys the plan never touches must survive any
        # mid-plan crash unchanged
        states.setdefault(k, {v})
    offsets = sorted({b + d for b in boundaries for d in (0, 1)}
                     | set(vpoints))
    if max_points is not None and len(offsets) > max_points:
        keep = offsets[:: len(offsets) // max_points + 1]
        # always keep at least one validation-window point in the
        # sample — the overlapped-read recovery property is the rarest
        # offset class and even sampling can miss it entirely
        if vpoints and not set(keep) & set(vpoints):
            keep.append(vpoints[0])
        offsets = sorted(keep)
    fresh = max(states) + 1
    report.n_ops_tested = len(ops)
    for off in offsets:
        snap.restore(pmem)
        prime()
        report.n_crash_states += 1
        tag = f"plan@store{off}"
        pmem.arm_crash(after_stores=off)
        try:
            index.execute(plan, collect_results=False)
            pmem.disarm_crash()
        except CrashPoint:
            pass
        except Exception as e:  # pragma: no cover - failure path
            report.stall_failures.append(f"{tag}: raised {e!r}")
            continue
        pmem.crash(mode=mode)
        try:
            index.recover()
        except Exception as e:  # pragma: no cover - failure path
            report.stall_failures.append(f"{tag}: recover raised {e!r}")
            continue
        for k, legal in states.items():
            got = index.lookup(k)
            if got not in legal:
                report.consistency_failures.append(
                    f"{tag}: key {k} reads {got!r}, not a plan-prefix state")
                break
        try:
            index.check_invariants()
        except AssertionError as e:  # pragma: no cover - failure path
            report.consistency_failures.append(f"{tag}: invariant: {e}")
        if not index.insert(fresh, 123) or index.lookup(fresh) != 123:
            report.consistency_failures.append(
                f"{tag}: post-crash write of {fresh} lost")
    snap.restore(pmem)
    prime()
    index.execute(plan, collect_results=False)
    if dict(index.items()) != model:
        report.consistency_failures.append(
            "clean plan run diverged from the dict model")
    return report

