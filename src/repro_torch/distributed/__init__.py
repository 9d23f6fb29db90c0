"""Scale-out layer: ``ShardedIndex`` plan execution with the mesh read
path, the multi-stream workload runner (``streams``), and ``sharding``,
the models' partition rules over the production mesh (specs only: the
dry run reads them; nothing places a tensor across cards yet).

The port of ``repro.distributed``.  Submodules import lazily, as in the
JAX package.
"""

import importlib

_SUBMODULES = ("mesh", "sharded", "sharding", "streams")
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
