"""Multi-stream workload driver: N independent client streams submit
interleaved operation plans against one index (sharded or not).

The driver runs in *ticks*.  Each tick admits at most one pending plan
per stream, round-robin with a rotating head for fairness, and a
candidate plan is admitted only if it is conflict-free against every
plan already admitted this tick (``kernels.conflict.conflict_any``
with ``writes_conflict=True`` — cross-stream ops have no defined
order, so even write/write on the same key must not co-admit).  A
conflicting plan stays queued and retries next tick
(``stats["deferred_plans"]``).

Because admitted plans are pairwise conflict-free across streams, the
tick's merged plan executes them as if each stream ran alone: no op of
one stream can observe another admitted stream's ops, so per-stream
results are independent of admission order — the property the
cross-stream tests pin against a sequential per-stream oracle.  Within
a stream, plan submission order is program order (a stream's next plan
is not admitted before its earlier one).

Per-op latency attribution is batch-amortized: a tick's cost is spread
over the ops it completed (``obs.Histogram.record_batch``).  When the
index is a ``ShardedIndex`` the driver books the *modeled* S-device
tick time (``critical_ns`` — routing + slowest shard + merge) and
keeps the serial wall time in ``stats["wall_ns"]``; for a plain index
the two are the same measurement.

The port of ``repro.distributed.streams``.  Admission runs on the
index's device: each candidate plan is checked against the tick's
admitted set by the ``conflict_any`` kernel on the card (its plain
PyTorch version on the CPU), where the JAX package's default is the
host oracle; the admitted sets, ticks and results are the same.  The
pipelined ticks (``tick_pipelined``, ``collect_ready``,
``run_pipelined``) feed the serving layer's ``PlanPipeline`` and come
with it.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

import numpy as np

from ..core.plan import Plan, PlanResult
from ..kernels.conflict import conflict_any
from ..obs import RECORDER as _OBS
from ..obs import Histogram


class StreamTicket:
    """Deferred result of one submitted plan."""

    __slots__ = ("plan", "result", "tick")

    def __init__(self, plan: Plan):
        self.plan = plan
        self.result: Optional[List[Any]] = None  # per-op slots at completion
        self.tick: Optional[int] = None  # tick the plan executed in

    @property
    def done(self) -> bool:
        return self.tick is not None


class ClientStream:
    """One client's FIFO of submitted plans."""

    def __init__(self, driver: "StreamDriver", sid: int):
        self.driver = driver
        self.sid = sid
        self.queue: Deque[StreamTicket] = deque()

    def submit(self, plan: Plan) -> StreamTicket:
        t = StreamTicket(plan)
        self.queue.append(t)
        return t

    def __repr__(self) -> str:
        return f"ClientStream(sid={self.sid}, queued={len(self.queue)})"


class StreamDriver:
    """Tick-driven multi-stream execution with conflict admission."""

    #: driver stats mirrored into an attached MetricsRegistry, as
    #: ``stream_<name>`` counters (``Session.stats``/``Server.stats``)
    MIRRORED = ("ticks", "admitted_plans", "deferred_plans", "merged_ops",
                "multi_stream_ticks")

    def __init__(self, index, n_streams: int, *,
                 collect_results: bool = True,
                 lat_hist: Optional[Histogram] = None,
                 metrics=None):
        self.index = index
        self.streams = [ClientStream(self, i) for i in range(n_streams)]
        self.collect_results = collect_results
        self.lat_hist = lat_hist
        self.stats = {"ticks": 0, "admitted_plans": 0, "deferred_plans": 0,
                      "merged_ops": 0, "multi_stream_ticks": 0,
                      "wall_ns": 0, "critical_ns": 0,
                      "found": 0, "acked": 0, "scanned": 0}
        # optional obs.MetricsRegistry: admission telemetry (above all
        # the deferred-plan contention counter) mirrored live so it is
        # readable through the owning Session/Server stats view without
        # a handle on the driver object
        self.metrics = metrics
        if metrics is not None:
            for name in self.MIRRORED:
                metrics.counter(f"stream_{name}")

    def _mirror(self, name: str, delta: int = 1) -> None:
        self.stats[name] += delta
        if self.metrics is not None:
            self.metrics.counter(f"stream_{name}").inc(delta)

    def pending(self) -> int:
        return sum(len(s.queue) for s in self.streams)

    # -- one admission + execution tick -----------------------------------
    def _admit_tick(self) -> Tuple[List[Tuple["ClientStream", StreamTicket]],
                                   Optional[Plan]]:
        """One admission round: pop a conflict-free set of head-of-queue
        plans (round-robin, rotating start) and merge them into one
        plan."""
        n_streams = len(self.streams)
        start = self.stats["ticks"] % max(1, n_streams)
        admitted: List[Tuple[ClientStream, StreamTicket]] = []
        adm_kinds: List[np.ndarray] = []
        adm_keys: List[np.ndarray] = []
        adm_aux: List[np.ndarray] = []
        for i in range(n_streams):
            stream = self.streams[(start + i) % n_streams]
            if not stream.queue:
                continue
            ticket = stream.queue[0]
            kinds, keys, aux = ticket.plan.arrays()
            if admitted:
                conf = conflict_any(kinds, keys,
                                    np.concatenate(adm_kinds),
                                    np.concatenate(adm_keys),
                                    writes_conflict=True,
                                    device=self.index.device)
                if bool(conf.any()):
                    self._mirror("deferred_plans")
                    continue
            stream.queue.popleft()
            admitted.append((stream, ticket))
            adm_kinds.append(kinds)
            adm_keys.append(keys)
            adm_aux.append(aux)
        if not admitted:
            return [], None
        self._mirror("ticks")
        self._mirror("admitted_plans", len(admitted))
        self._mirror("multi_stream_ticks", int(len(admitted) > 1))
        merged = Plan.from_arrays(np.concatenate(adm_kinds),
                                  np.concatenate(adm_keys),
                                  np.concatenate(adm_aux))
        self._mirror("merged_ops", len(merged))
        return admitted, merged

    def _scatter(self, admitted: List[Tuple["ClientStream", StreamTicket]],
                 res: PlanResult, wall: int, tick_no: int) -> None:
        """Book a completed merged plan: tally stats, record latency,
        slice per-op results back to the stream tickets."""
        modeled = getattr(res, "critical_ns", 0) or wall
        self.stats["wall_ns"] += wall
        self.stats["critical_ns"] += modeled
        self.stats["found"] += res.found
        self.stats["acked"] += res.acked
        self.stats["scanned"] += res.scanned
        if self.lat_hist is not None:
            self.lat_hist.record_batch(modeled, sum(
                len(t.plan) for _, t in admitted))
        at = 0
        for stream, ticket in admitted:
            width = len(ticket.plan)
            if self.collect_results:
                ticket.result = res.results[at:at + width]
            ticket.tick = tick_no
            at += width

    def tick(self, **execute_kw) -> Optional[PlanResult]:
        """Admit a conflict-free set of head-of-queue plans (round-
        robin, rotating start), execute them as one merged plan, and
        scatter results back to the tickets.  Returns the merged
        ``PlanResult`` (None when every stream was idle)."""
        admitted, merged = self._admit_tick()
        if not admitted:
            return None
        n_ops = len(merged)
        t0 = time.perf_counter_ns()
        with _OBS.span("streams.tick", streams=len(admitted), ops=n_ops):
            res = self.index.execute(
                merged, collect_results=self.collect_results, **execute_kw)
        wall = time.perf_counter_ns() - t0
        self._scatter(admitted, res, wall, self.stats["ticks"])
        return res

    def run(self, max_ticks: int = 100_000, **execute_kw) -> int:
        """Tick until every stream drains; returns ticks run.  Always
        terminates: each tick admits at least its first non-empty
        stream's head plan (nothing to conflict with yet)."""
        ticks = 0
        while self.pending() and ticks < max_ticks:
            self.tick(**execute_kw)
            ticks += 1
        return ticks


__all__ = ["ClientStream", "StreamDriver", "StreamTicket"]
