"""Tracing spans: nested, monotonic-timestamped, near-zero cost when off.

The global recorder (``repro_torch.obs.RECORDER``) is disabled by default.
``Recorder.span`` returns the singleton ``NULL_SPAN`` in that state — a
falsy no-op context manager — so instrumentation sites pay one method
call and can guard any extra work (counter snapshots, kwargs building)
with ``if sp:``.  No strings are formatted and nothing is allocated per
call on the disabled path.

Timestamps come from ``time.perf_counter_ns`` relative to the
recorder's epoch, so span times are monotonic and directly convertible
to Chrome-trace microseconds.  Nesting is tracked with a per-thread
stack: each finished span knows its ``parent_id``, which the exporter
carries into the trace ``args`` for tools that reconstruct trees.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class Span:
    """One finished (or in-flight) span.  ``set(**attrs)`` attaches
    attributes at any point before exit; truthy so ``if sp:`` guards
    work on the enabled path only."""

    __slots__ = ("name", "ts", "dur", "tid", "span_id", "parent_id",
                 "attrs", "_rec")

    def __init__(self, rec: "Recorder", name: str,
                 attrs: Optional[Dict] = None) -> None:
        self._rec = rec
        self.name = name
        self.ts = 0
        self.dur = 0
        self.tid = 0
        self.span_id = 0
        self.parent_id = None
        self.attrs = attrs if attrs is not None else {}

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._rec._enter(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._rec._exit(self)

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, ts={self.ts}, dur={self.dur}, "
                f"attrs={self.attrs!r})")


class _NullSpan:
    """Falsy no-op stand-in used whenever the recorder is disabled."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Recorder:
    """Collects finished spans.  Disabled by default; ``enable()`` sets
    the epoch so all timestamps in one recording share a base."""

    def __init__(self) -> None:
        self.enabled = False
        self.epoch = 0
        self.spans: List[Span] = []
        self._local = threading.local()
        self._lock = threading.Lock()
        self._next_id = 1

    # -- lifecycle -----------------------------------------------------
    def enable(self) -> None:
        if not self.enabled:
            self.epoch = time.perf_counter_ns()
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self.spans.clear()
        self._next_id = 1
        self.epoch = time.perf_counter_ns()

    # -- span creation -------------------------------------------------
    def span(self, name: str, **attrs):
        """A context manager timing the enclosed block.  Returns
        ``NULL_SPAN`` (falsy, no-op) when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def add_span(self, name: str, t0_ns: int, t1_ns: int, **attrs):
        """Record an externally-timed span (e.g. recovery windows whose
        endpoints were captured with ``time.perf_counter_ns``)."""
        if not self.enabled:
            return NULL_SPAN
        sp = Span(self, name, attrs)
        sp.ts = t0_ns - self.epoch
        sp.dur = max(int(t1_ns) - int(t0_ns), 0)
        sp.tid = threading.get_ident()
        stack = getattr(self._local, "stack", None)
        with self._lock:
            sp.span_id = self._next_id
            self._next_id += 1
            if stack:
                sp.parent_id = stack[-1].span_id
            self.spans.append(sp)
        return sp

    # -- span protocol internals --------------------------------------
    def _enter(self, sp: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        sp.tid = threading.get_ident()
        with self._lock:
            sp.span_id = self._next_id
            self._next_id += 1
        if stack:
            sp.parent_id = stack[-1].span_id
        stack.append(sp)
        sp.ts = time.perf_counter_ns() - self.epoch

    def _exit(self, sp: Span) -> None:
        sp.dur = time.perf_counter_ns() - self.epoch - sp.ts
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is sp:
            stack.pop()
        elif stack and sp in stack:  # tolerate mispaired exits
            stack.remove(sp)
        with self._lock:
            self.spans.append(sp)

    # -- queries -------------------------------------------------------
    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


__all__ = ["Recorder", "Span", "NULL_SPAN"]
