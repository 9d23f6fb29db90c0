"""Serving runtime: the continuous-batching engine (``engine``) and
the double-buffered pipeline layer (``pipeline``).

``pipeline`` imports eagerly (plans + obs only); the engine — which
pulls in the model stack — resolves lazily on first attribute access,
so plan-level drivers can use ``AsyncExporter``/``PlanPipeline``
without paying the model stack import.  The port of
``repro.serving``.
"""

from .pipeline import AsyncExporter, PlanPipeline, PlanTicket

_ENGINE_NAMES = ("Server", "ServerSession", "PagedKVManager", "Request")


def __getattr__(name):
    if name in _ENGINE_NAMES:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["AsyncExporter", "PlanPipeline", "PlanTicket",
           *_ENGINE_NAMES]
