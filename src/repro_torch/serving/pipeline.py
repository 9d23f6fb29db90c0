"""Double-buffered serving pipeline: deferred snapshot re-exports and
an overlapped plan executor.

The blocking engine pays two costs on its critical path that this
module moves off it:

* **Snapshot re-exports.**  After a write wave bumps an index's epoch,
  the next batched read pays the full array walk (including the
  fingerprint-lane rebuild) before it can probe.  ``AsyncExporter``
  turns that into a *deferred job*: the runtime submits the index at
  the end of a tick (or between plans) and the job rebuilds the export
  off the read path.  Publication is epoch-guarded
  (``RecipeIndex.publish_export``): a build that raced a write or a
  crash is discarded whole, so a read wave never observes a
  half-published export — it serves either the old snapshot or the
  complete new one.

* **Plan build + scheduling.**  ``PlanPipeline`` double-buffers plan
  execution: the caller's ``submit`` runs the *build stage* — array
  materialization (``Plan.arrays``) and the conflict-wave schedule
  (``Plan.waves``), both pure functions that never touch the index —
  on the submitting thread, while a single worker thread dispatches
  previously queued plans strictly FIFO through ``index.execute``.
  Tick N+1's plan is therefore built while tick N's waves dispatch,
  and because execution order equals submission order the results are
  identical to the blocking path by construction.  All PMem access
  (execution *and* the deferred re-exports, which the worker runs
  between plans) stays on the worker thread, so the simulated PMem's
  honest counters never race.

Telemetry: both objects count into an attached ``obs.MetricsRegistry``
(``pipeline_*`` / ``async_export*`` names) so ``Server.stats`` and the
benchmarks see pipeline depth, stalls, and export backlog alongside
the probe-traffic counters.

The port of ``repro.serving.pipeline``.  On the card the worker thread
is where the index kernels launch: it runs with the index's device as
its current device, and it marks a ticket done only after its stream
has finished, so a ticket's results are on the host when ``wait``
returns.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.plan import Plan, PlanResult
from ..kernels.conflict import GET, SCAN
from ..obs import RECORDER as _OBS


class AsyncExporter:
    """Deferred snapshot re-export jobs with epoch-guarded publication.

    ``submit(index)`` enqueues a re-export (deduplicated per index);
    ``run_pending()`` — called off the critical path: at a tick's tail,
    or by the ``PlanPipeline`` worker between plans — rebuilds each
    pending index's export via ``build_export`` and installs it through
    the ``publish_export`` epoch guard.  A job whose index is already
    current is a no-op; a build the index outran (a write or crash
    landed mid-walk) is discarded and counted, never installed.
    """

    STAT_KEYS = ("submitted", "published", "noop", "stale", "discarded")

    def __init__(self, *, metrics=None):
        self._pending: Dict[int, Any] = {}  # id(index) -> index, FIFO
        self.stats = {k: 0 for k in self.STAT_KEYS}
        self.metrics = metrics
        if metrics is not None:
            for name in self.STAT_KEYS:
                metrics.counter(f"async_exports_{name}")
            metrics.gauge("async_export_backlog")

    def _count(self, name: str, delta: int = 1) -> None:
        self.stats[name] += delta
        if self.metrics is not None:
            self.metrics.counter(f"async_exports_{name}").inc(delta)

    def _gauge_backlog(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("async_export_backlog").set(self.backlog)

    @property
    def backlog(self) -> int:
        """Number of submitted-but-not-yet-run re-export jobs."""
        return len(self._pending)

    def submit(self, index) -> bool:
        """Enqueue a deferred re-export of ``index``.  Idempotent while
        the job is pending; returns True if a new job was enqueued."""
        if id(index) in self._pending:
            return False
        self._pending[id(index)] = index
        self._count("submitted")
        self._gauge_backlog()
        return True

    def submit_if_stale(self, index) -> bool:
        """Enqueue a re-export only when the index has an export *in
        use* that a write has invalidated.  Never creates an export
        nobody asked for: an eager rebuild after every writing plan
        would add array walks the blocking path never pays on
        workloads whose reads stay on the scalar path."""
        snap = index._snapshot
        if snap is None or snap.epoch == index._epoch_key():
            return False
        return self.submit(index)

    def run_pending(self, budget: Optional[int] = None) -> int:
        """Run up to ``budget`` pending jobs (all, by default); returns
        the number of exports actually published."""
        published = 0
        while self._pending and (budget is None or budget > 0):
            key = next(iter(self._pending))
            index = self._pending.pop(key)
            if budget is not None:
                budget -= 1
            snap = index._snapshot
            if snap is not None and snap.epoch == index._epoch_key():
                self._count("noop")
                continue
            with _OBS.span("export.async", index=type(index).__name__):
                built = index.build_export()
                if index.publish_export(built):
                    self._count("published")
                    published += 1
                else:  # epoch moved mid-build: reject whole, never torn
                    self._count("stale")
        self._gauge_backlog()
        return published

    def discard_pending(self) -> int:
        """Drop every queued job without running it — the crash path:
        a power-fail invalidates any staged re-export work, and
        recovery re-warms explicitly (``PagedKVManager.recover``)."""
        n = len(self._pending)
        if n:
            self._pending.clear()
            self._count("discarded", n)
            self._gauge_backlog()
        return n


class PlanTicket:
    """Deferred result of one pipelined plan submission."""

    __slots__ = ("plan", "result", "error", "exec_ns", "_event")

    def __init__(self, plan: Plan):
        self.plan = plan
        self.result: Optional[PlanResult] = None
        self.error: Optional[BaseException] = None
        self.exec_ns: int = 0
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> PlanResult:
        """Block until the plan executed; re-raise its error if any."""
        if not self._event.wait(timeout):
            raise TimeoutError("pipelined plan did not complete")
        if self.error is not None:
            raise self.error
        return self.result


_CLOSE = object()  # worker shutdown sentinel


def _slice_result(res: PlanResult, at: int, width: int,
                  kinds: np.ndarray, *, first: bool) -> PlanResult:
    """Per-ticket view of a coalesced group's merged ``PlanResult``:
    result slots are sliced positionally and the found/acked/scanned
    tallies are recomputed exactly from the slice (same rules as the
    wave scatter in ``core.plan.run_plan``).  Wave telemetry and probe
    deltas belong to the one merged dispatch, so the group's first
    ticket carries them whole and the rest carry zeros — sums across
    tickets equal the merged execution exactly."""
    out = PlanResult(
        results=res.results[at:at + width],
        wave_kinds=list(res.wave_kinds) if first else [],
        wave_widths=list(res.wave_widths) if first else [],
        probe=dict(res.probe) if first else {k: 0 for k in res.probe})
    for k, r in zip(kinds.tolist(), out.results):
        if k == GET:
            out.found += r is not None
        elif k == SCAN:
            out.scanned += len(r)
        else:
            out.acked += bool(r)
    return out


class PlanPipeline:
    """Double-buffered FIFO plan executor over one index.

    ``submit(plan)`` runs the build stage (arrays + wave schedule) on
    the calling thread and hands the plan to the worker; at most
    ``depth`` plans queue ahead of the executor, and a full queue
    blocks the submitter (counted as a *stall* — the backpressure that
    bounds memory and keeps admission honest).  Execution is strictly
    submission-ordered, so results are bit-identical to calling
    ``index.execute`` inline.  When an ``AsyncExporter`` is attached,
    the worker refreshes stale in-use exports after writing plans and
    drains the exporter between plans — deferred re-exports ride the
    pipeline's idle gaps instead of the read path.

    **Coalescing.**  Under load, plans queue while the worker is busy;
    the worker drains up to ``coalesce`` result-collecting plans at
    once and executes them as *one* merged plan, amortizing wave
    scheduling and kernel dispatch that the blocking path pays per
    plan.  FIFO concatenation preserves per-key op order, and the
    conflict-wave schedule already serializes same-key ops within one
    plan, so the merged execution is semantically the sequential one
    — per-ticket results come back bit-identical via ``_slice_result``
    (exact tallies; wave/probe telemetry attributed to the group's
    first ticket).  Plans submitted with ``collect_results=False``
    never coalesce: without result slots their per-ticket tallies
    could not be attributed exactly.
    """

    def __init__(self, index, *, depth: int = 2, coalesce: int = 8,
                 exporter: Optional[AsyncExporter] = None,
                 metrics=None, collect_results: bool = True,
                 force_kernel: bool = False):
        self.index = index
        self.exporter = exporter
        self.coalesce = max(1, coalesce)
        self.collect_results = collect_results
        self.force_kernel = force_kernel
        self.metrics = metrics
        self.stats = {"plans": 0, "stalls": 0, "max_depth": 0,
                      "groups": 0, "coalesced_plans": 0}
        if metrics is not None:
            metrics.counter("pipeline_plans")
            metrics.counter("pipeline_stalls")
            metrics.counter("pipeline_coalesced_plans")
            metrics.gauge("pipeline_depth")
        dev = getattr(index, "device", None)
        self._device = dev if (dev is not None
                               and torch.device(dev).type == "cuda") else None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._inflight: List[PlanTicket] = []
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="plan-pipeline")
        self._worker.start()

    # -- submit side ------------------------------------------------------
    def submit(self, plan: Plan, *, collect_results: Optional[bool] = None
               ) -> PlanTicket:
        """Build (arrays + wave schedule) on this thread, queue for
        FIFO execution on the worker; returns the plan's ticket."""
        with _OBS.span("pipeline.build", n_ops=len(plan)):
            plan.arrays()
            plan.waves()
        ticket = PlanTicket(plan)
        ticket_collect = (self.collect_results if collect_results is None
                          else collect_results)
        if self._q.full():
            self.stats["stalls"] += 1
            if self.metrics is not None:
                self.metrics.counter("pipeline_stalls").inc()
        self._q.put((ticket, ticket_collect))
        self._inflight.append(ticket)
        depth = self._q.qsize()
        if depth > self.stats["max_depth"]:
            self.stats["max_depth"] = depth
            if self.metrics is not None:
                self.metrics.gauge("pipeline_depth").set(depth)
        self.stats["plans"] += 1
        if self.metrics is not None:
            self.metrics.counter("pipeline_plans").inc()
        return ticket

    def drain(self) -> List[PlanResult]:
        """Wait for every outstanding plan; returns their results in
        submission order (re-raising the first execution error)."""
        done, self._inflight = self._inflight, []
        return [t.wait() for t in done]

    def close(self) -> None:
        """Drain and stop the worker thread."""
        self.drain()
        self._q.put((_CLOSE, False))
        self._worker.join()

    def __enter__(self) -> "PlanPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker side ------------------------------------------------------
    def _plan_writes(self, plan: Plan) -> bool:
        kinds = plan.arrays()[0]
        return bool(((kinds != GET) & (kinds != SCAN)).any())

    def _after_exec(self, wrote: bool) -> None:
        if self.exporter is not None:
            if wrote:
                self.exporter.submit_if_stale(self.index)
            # ride the inter-plan gap, not the next read wave
            self.exporter.run_pending()

    def _finish_device(self) -> None:
        """Wait for the kernels this thread launched on the index's card
        (results copied to the host are complete already; this also
        covers plans that collect none)."""
        if self._device is not None:
            torch.cuda.current_stream(self._device).synchronize()

    def _exec_single(self, ticket: PlanTicket, collect: bool) -> None:
        t0 = time.perf_counter_ns()
        try:
            ticket.result = self.index.execute(
                ticket.plan, collect_results=collect,
                force_kernel=self.force_kernel)
            self._after_exec(self._plan_writes(ticket.plan))
            self._finish_device()
        except BaseException as e:  # surfaced at wait()/drain()
            ticket.error = e
        finally:
            ticket.exec_ns = time.perf_counter_ns() - t0
            ticket._event.set()

    def _exec_group(self, group: List[Tuple[PlanTicket, bool]]) -> None:
        t0 = time.perf_counter_ns()
        try:
            arrs = [t.plan.arrays() for t, _ in group]
            merged = Plan.from_arrays(
                np.concatenate([a[0] for a in arrs]),
                np.concatenate([a[1] for a in arrs]),
                np.concatenate([a[2] for a in arrs]))
            with _OBS.span("pipeline.coalesce", plans=len(group),
                           n_ops=len(merged)):
                res = self.index.execute(merged, collect_results=True,
                                         force_kernel=self.force_kernel)
            at = 0
            for gi, (ticket, _) in enumerate(group):
                width = len(ticket.plan)
                ticket.result = _slice_result(res, at, width, arrs[gi][0],
                                              first=(gi == 0))
                at += width
            self.stats["groups"] += 1
            self.stats["coalesced_plans"] += len(group)
            if self.metrics is not None:
                self.metrics.counter("pipeline_coalesced_plans").inc(
                    len(group))
            self._after_exec(any(self._plan_writes(t.plan)
                                 for t, _ in group))
            self._finish_device()
        except BaseException as e:
            for ticket, _ in group:
                ticket.error = e
        finally:
            dt = time.perf_counter_ns() - t0
            # batch-amortized wall attribution, proportional to op count
            total = sum(len(t.plan) for t, _ in group) or 1
            for ticket, _ in group:
                ticket.exec_ns = dt * len(ticket.plan) // total
                ticket._event.set()

    def _run(self) -> None:
        if self._device is None:
            return self._loop()
        with torch.cuda.device(self._device):
            return self._loop()

    def _loop(self) -> None:
        held = None  # lookahead item popped while forming a group
        while True:
            item = held if held is not None else self._q.get()
            held = None
            ticket, collect = item
            if ticket is _CLOSE:
                return
            group = [item]
            while collect and len(group) < self.coalesce:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt[0] is _CLOSE or not nxt[1]:
                    held = nxt  # boundary: handle after this group
                    break
                group.append(nxt)
            if len(group) == 1:
                self._exec_single(ticket, collect)
            else:
                self._exec_group(group)


__all__ = ["AsyncExporter", "PlanPipeline", "PlanTicket"]
