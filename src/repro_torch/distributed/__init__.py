"""Scale-out layer: ``ShardedIndex`` plan execution with the mesh read
path, and the multi-stream workload driver.

The port of ``repro.distributed`` without ``sharding``, the LLM-side
partition rules, which come with the LLM scaffold.  Submodules import
lazily, as in the JAX package.
"""

import importlib

_SUBMODULES = ("mesh", "sharded", "streams")
_EXPORTS = {
    "ClientStream": "streams",
    "ShardedIndex": "sharded",
    "ShardedPMem": "sharded",
    "ShardedPlanResult": "sharded",
    "StreamDriver": "streams",
    "StreamTicket": "streams",
}

__all__ = sorted(_SUBMODULES) + sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _EXPORTS:
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
