"""repro_torch.obs — telemetry: tracing spans, metrics registry, latency
histograms.

One process-global :class:`Recorder` (``RECORDER``) backs the tracing
API.  It is **disabled by default**; instrumentation sites call
``RECORDER.span(...)`` unconditionally and get the falsy no-op
``NULL_SPAN`` back when tracing is off, so the disabled path costs one
method call and no allocation.  Enable around a region of interest::

    from repro_torch import obs

    obs.enable()
    ... run workload ...
    kernel_spans = obs.spans("kernel.clht_probe")
    obs.disable()

Span names and attributes are those of the JAX package (``plan.*``,
``pmem.group_commit``, ``kernel.clht_probe``).  The Chrome-trace
exporter is not ported yet.
"""

from __future__ import annotations

from .histogram import Histogram, bucket_index, bucket_upper
from .metrics import Counter, Gauge, MetricsRegistry, MetricsView
from .recorder import NULL_SPAN, Recorder, Span

#: the process-global recorder every instrumented layer reports to
RECORDER = Recorder()


def enable() -> None:
    """Turn tracing on (sets the timestamp epoch if newly enabled)."""
    RECORDER.enable()


def disable() -> None:
    RECORDER.disable()


def enabled() -> bool:
    return RECORDER.enabled


def reset() -> None:
    """Drop collected spans and restart the epoch."""
    RECORDER.reset()


def span(name: str, **attrs):
    """Context manager timing a block on the global recorder."""
    return RECORDER.span(name, **attrs)


def add_span(name: str, t0_ns: int, t1_ns: int, **attrs):
    """Record an externally-timed span on the global recorder."""
    return RECORDER.add_span(name, t0_ns, t1_ns, **attrs)


def spans(name=None):
    """Collected spans, optionally filtered by exact name."""
    if name is None:
        return list(RECORDER.spans)
    return RECORDER.find(name)


__all__ = [
    "RECORDER", "Recorder", "Span", "NULL_SPAN",
    "Histogram", "bucket_index", "bucket_upper",
    "Counter", "Gauge", "MetricsRegistry", "MetricsView",
    "enable", "disable", "enabled", "reset", "span", "add_span", "spans",
]
