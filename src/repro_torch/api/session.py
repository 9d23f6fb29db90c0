"""The public facade: sessions over converted PM indexes.

``open_index(kind)`` constructs a converted index on a (new or shared)
``PMem`` and wraps it in a ``Session`` — the supported public surface.
All I/O funnels through operation plans (``core/plan.py``): scalar
conveniences build single-op plans (which ``execute`` degenerates to
the scalar path), and ``session.pipeline()`` records ops into one plan
that auto-coalesces and drains either when a recorded result is read,
when the pipeline reaches its depth limit, or at context exit.

Ordering semantics are the plan contract: per-key program order,
cross-key freedom.  The port of ``repro.api.session``: sessions run on
the card unless the caller passes ``device="cpu"``.  All eight kinds of
the JAX package are here: RECIPE's five converted indexes and the three
hand-crafted PM baselines, unsharded or as a ``ShardedIndex``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..core import (PART, PBwTree, PCLHT, PHOT, PMasstree, PMem, Plan,
                    PlanResult)
from ..core.baselines import CCEH, FastFair, LevelHashing
from ..core.conditions import PROBE_STAT_KEYS
from ..device import resolve_device
from ..obs import MetricsRegistry, MetricsView

# public index kinds; aliases accept the paper's P-* names (any case).
# "cceh", "fastfair" and "level"/"levelhashing" are the hand-crafted
# PM baselines on the same plan surface.
_KINDS = {
    "clht": PCLHT,
    "art": PART,
    "hot": PHOT,
    "bwtree": PBwTree,
    "masstree": PMasstree,
    "cceh": CCEH,
    "fastfair": FastFair,
    "level": LevelHashing,
    "levelhashing": LevelHashing,
}


def _resolve_kind(kind: str):
    name = kind.lower().lstrip("p").lstrip("-").replace("_", "")
    if name not in _KINDS:
        raise ValueError(
            f"unknown index kind {kind!r}; choose from "
            f"{sorted(_KINDS)} (P-* aliases accepted)")
    return name, _KINDS[name]


def open_index(kind: str, *, device=None, pmem: Optional[PMem] = None,
               shards: int = 1, scheme: Optional[str] = None,
               mesh_reads: bool = False, **index_kwargs) -> "Session":
    """Open a converted PM index as a ``Session``.

    ``kind`` is one of clht/art/hot/bwtree/masstree/cceh/fastfair/level
    (or a P-* alias).  ``device`` is where the index's snapshots live
    and its batched reads run: ``"cuda"`` when omitted, which raises
    without a card; ``"cpu"`` runs the plain PyTorch versions of the
    kernels.  Pass an existing ``pmem`` to attach to a shared
    persistence domain (e.g. re-attaching after a crash); extra kwargs
    go to the index constructor (``n_buckets=...`` for clht).

    ``shards=S`` (a power of two > 1) opens a ``ShardedIndex``
    instead: S independent shards of the kind, each on its own PMem
    and on ``device``, with plans routed per key and executed
    shard-wise.  ``scheme`` overrides the routing (hash/prefix) and
    ``mesh_reads=True`` turns on the one-launch mesh read path for
    all-GET plans.  Sharded sessions own their persistence domains, so
    ``pmem=`` cannot be combined with ``shards=``.
    """
    name, factory = _resolve_kind(kind)
    if shards > 1:
        if pmem is not None:
            raise ValueError("shards= builds one PMem per shard; "
                             "pmem= cannot be shared across them")
        from ..distributed import ShardedIndex
        dev = resolve_device(device)
        index = ShardedIndex(
            lambda pm: factory(pm, device=dev, **index_kwargs), shards,
            scheme=scheme, mesh_reads=mesh_reads, device=dev)
        return Session(index, kind=name)
    pmem = pmem or PMem()
    return Session(factory(pmem, device=device, **index_kwargs), kind=name)


class _Generation:
    """One coalescing round's result cell.  Handles hold the cell, not
    the pipeline's history, so a generation's results are freed as
    soon as its last handle dies — a long-lived pipeline stays O(open
    ops), not O(ops ever executed)."""

    __slots__ = ("results", "__weakref__")

    def __init__(self) -> None:
        self.results: Optional[List[Any]] = None  # filled at drain


class OpHandle:
    """Deferred result slot for one pipelined op.  Reading ``.value``
    drains the owning pipeline (all ops recorded so far execute as one
    plan) if it has not drained yet."""

    __slots__ = ("_pipeline", "_slot", "_gen")

    def __init__(self, pipeline: "Pipeline", slot: int,
                 gen: _Generation):
        self._pipeline = pipeline
        self._slot = slot
        self._gen = gen

    @property
    def done(self) -> bool:
        return self._gen.results is not None

    @property
    def value(self):
        if self._gen.results is None:
            self._pipeline.drain()
        return self._gen.results[self._slot]

    def __repr__(self) -> str:
        return (f"OpHandle(slot={self._slot}, "
                + (f"value={self.value!r})" if self.done else "pending)"))


class Pipeline:
    """Records ops into a plan; drains on result read, on reaching
    ``depth`` buffered ops, or at context exit.  After a drain the
    pipeline starts a fresh plan, so one pipeline can span many
    coalesced rounds."""

    def __init__(self, session: "Session", depth: int):
        self._session = session
        self._depth = depth
        self._plan = Plan()
        self._gen = _Generation()
        self._closed = False

    # -- op recording -----------------------------------------------------
    def _record(self, slot: int) -> OpHandle:
        h = OpHandle(self, slot, self._gen)
        if len(self._plan) >= self._depth:
            self.drain()
        return h

    def get(self, key: int) -> OpHandle:
        return self._record(self._plan.get(int(key)))

    def put(self, key: int, value: int) -> OpHandle:
        return self._record(self._plan.put(int(key), int(value)))

    def update(self, key: int, value: int) -> OpHandle:
        return self._record(self._plan.update(int(key), int(value)))

    def delete(self, key: int) -> OpHandle:
        return self._record(self._plan.delete(int(key)))

    def scan(self, start_key: int, count: int) -> OpHandle:
        return self._record(self._plan.scan(int(start_key), int(count)))

    # -- draining ---------------------------------------------------------
    def drain(self) -> Optional[PlanResult]:
        """Execute everything recorded since the last drain as one
        plan.  Called automatically on result reads, depth overflow,
        and context exit."""
        if not len(self._plan):
            return None
        res = self._session.execute(self._plan)
        self._gen.results = res.results
        self._plan = Plan()
        self._gen = _Generation()
        return res

    # -- context management ----------------------------------------------
    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._closed = True
        if exc_type is None:
            self.drain()


class Session:
    """A handle on one converted index: scalar conveniences, plan
    execution, pipelines, and crash/recover — the public API, as the
    JAX package's docs/API.md describes it.  The underlying ``RecipeIndex`` and ``PMem`` remain
    reachable as ``.index`` / ``.pmem`` for tooling, but the supported
    surface is this class plus ``Plan``."""

    def __init__(self, index, *, kind: str,
                 metrics: Optional[MetricsRegistry] = None):
        self.index = index
        self.kind = kind
        self.metrics = metrics or MetricsRegistry()
        for name in ("plans", "waves", "wave_ops") + PROBE_STAT_KEYS:
            self.metrics.counter(name)
        self.stats = MetricsView(self.metrics)

    @property
    def pmem(self) -> PMem:
        return self.index.pmem

    @property
    def ordered(self) -> bool:
        return self.index.ORDERED

    @property
    def device(self):
        """Where the index's snapshots live and its batched reads run."""
        return self.index.device

    @property
    def shards(self) -> int:
        """Shard count (1 for an unsharded session)."""
        return getattr(self.index, "n_shards", 1)

    def streams(self, n: int, *, collect_results: bool = True,
                lat_hist=None) -> "StreamDriver":
        """Multi-session harness: ``n`` independent client streams over
        this session's index.  Each ``driver.streams[i]`` submits plans
        independently; ``driver.tick()``/``driver.run()`` admit
        non-conflicting head-of-queue plans per tick (the
        ``conflict_any`` check on the index's device) and execute them
        as one merged plan.  The driver mirrors its admission telemetry
        (``stream_deferred_plans`` — the contention signal — plus
        ticks/admitted/merged counters) into this session's ``stats``.
        See ``repro_torch.distributed.streams``."""
        from ..distributed import StreamDriver
        return StreamDriver(self.index, n, collect_results=collect_results,
                            lat_hist=lat_hist, metrics=self.metrics)

    # -- plan execution ---------------------------------------------------
    def execute(self, plan: Plan, *, force_kernel: bool = False
                ) -> PlanResult:
        res = self.index.execute(plan, force_kernel=force_kernel)
        self.metrics.counter("plans").inc()
        self.metrics.counter("waves").inc(res.n_waves)
        self.metrics.counter("wave_ops").inc(sum(res.wave_widths))
        # probe-traffic deltas (fingerprint filter + optimistic reads)
        # mirror into the registry so Session.stats sums exactly
        for name, delta in res.probe.items():
            if delta:
                self.metrics.counter(name).inc(delta)
        self._update_write_versions()
        return res

    def _update_write_versions(self) -> None:
        """Surface the index's per-shard write-version gauge (the
        optimistic read path's validation input) as metrics gauges."""
        wv = getattr(self.index, "write_versions", None)
        if wv is None:
            return
        for shard, version in enumerate(wv().tolist()):
            self.metrics.gauge(f"write_version_{shard}").set(version)

    def pipeline(self, *, depth: int = 4096) -> Pipeline:
        """Context manager that coalesces ops into plans of up to
        ``depth`` ops; see ``Pipeline``."""
        return Pipeline(self, depth)

    # -- scalar conveniences (single-op plans -> scalar path) -------------
    def get(self, key: int) -> Optional[int]:
        return self.execute(Plan.from_ops([("lookup", key, 0)])).results[0]

    def put(self, key: int, value: int) -> bool:
        return self.execute(Plan.from_ops([("insert", key, value)])).results[0]

    def update(self, key: int, value: int) -> bool:
        return self.execute(Plan.from_ops([("update", key, value)])).results[0]

    def delete(self, key: int) -> bool:
        return self.execute(Plan.from_ops([("delete", key, 0)])).results[0]

    def scan(self, start_key: int, count: int) -> List[Tuple[int, int]]:
        return self.execute(Plan.from_ops([("scan", start_key, count)])
                            ).results[0]

    # -- durability -------------------------------------------------------
    def crash(self, mode: str = "powerfail") -> None:
        """Simulated power failure of the persistence domain."""
        self.pmem.crash(mode=mode)
        self.recover()

    def recover(self) -> None:
        """Re-attach after a crash: RECIPE indexes need no repair
        pass; this only reruns the index's (trivial) recovery hook."""
        self.index.recover()

    def items(self):
        return self.index.items()

    def __repr__(self) -> str:
        return f"Session(kind={self.kind!r}, index={self.index.spec.name})"
