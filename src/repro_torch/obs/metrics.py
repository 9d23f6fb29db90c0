"""Named counters, gauges, and histograms — the metrics registry that
subsumes the ad-hoc stats dicts (serving engine, sessions).

Merge semantics across shards/workers: counters and histograms add,
gauges take the maximum (a conservative high-water mark — gauges are
point-in-time values, so addition would fabricate totals).

``MetricsView`` is a read-only ``Mapping`` over a registry's counters
and gauges, so code that used to read ``server.stats["decode_steps"]``
keeps working unchanged while every write goes through typed metric
objects.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator

from .histogram import Histogram


class Counter:
    """A monotonically increasing named value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Counter({self.name!r}, {self.value})"


class Gauge:
    """A named point-in-time value (last write wins)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def set(self, v: int) -> None:
        self.value = v

    def __repr__(self) -> str:
        return f"Gauge({self.name!r}, {self.value})"


class MetricsRegistry:
    """Get-or-create home for named metrics.  A name belongs to one
    metric type; asking for it as another type is a bug and raises."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def _check_free(self, name: str, own: dict) -> None:
        for kind in (self.counters, self.gauges, self.histograms):
            if kind is not own and name in kind:
                raise ValueError(f"metric {name!r} already registered "
                                 f"as a different type")

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            self._check_free(name, self.counters)
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            self._check_free(name, self.gauges)
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            self._check_free(name, self.histograms)
            h = self.histograms[name] = Histogram(name)
        return h

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry (a shard's, a worker's) into this one:
        counters and histograms add, gauges take the max."""
        for name, c in other.counters.items():
            self.counter(name).inc(c.value)
        for name, g in other.gauges.items():
            mine = self.gauge(name)
            mine.set(max(mine.value, g.value))
        for name, h in other.histograms.items():
            self.histogram(name).merge(h)
        return self

    def as_dict(self) -> Dict[str, int]:
        """Counter and gauge values by name (histograms excluded — read
        those via ``histograms`` for percentiles)."""
        out = {name: c.value for name, c in self.counters.items()}
        out.update({name: g.value for name, g in self.gauges.items()})
        return out


class MetricsView(Mapping):
    """Read-only dict-shaped view over a registry's counters and
    gauges — the compatibility surface for legacy ``stats`` dicts."""

    __slots__ = ("_registry",)

    def __init__(self, registry: MetricsRegistry) -> None:
        self._registry = registry

    def __getitem__(self, name: str) -> int:
        r = self._registry
        if name in r.counters:
            return r.counters[name].value
        if name in r.gauges:
            return r.gauges[name].value
        raise KeyError(name)

    def __iter__(self) -> Iterator[str]:
        r = self._registry
        yield from r.counters
        yield from r.gauges

    def __len__(self) -> int:
        r = self._registry
        return len(r.counters) + len(r.gauges)

    def __setitem__(self, name: str, value) -> None:
        raise TypeError("stats is a read-only view; use the metrics "
                        "registry (metrics.counter(name).inc(), "
                        "metrics.gauge(name).set())")

    def __delitem__(self, name: str) -> None:
        raise TypeError("stats is a read-only view")

    def __repr__(self) -> str:
        return f"MetricsView({dict(self)!r})"


__all__ = ["Counter", "Gauge", "MetricsRegistry", "MetricsView"]
