"""Host front-end for shard routing + stable sort-by-shard.

``partition_writes`` is what ``RecipeIndex._write_batch`` calls: route
every op's key to a shard, then produce the stable sort-by-shard
permutation and per-shard run offsets.  Routing runs on the host, as
the JAX package's default path does: a write batch is consumed op by
op by the numpy PM simulator anyway.  The device form of the router
(the JAX package's ``shard_route`` kernel) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ...obs import RECORDER as _OBS
from .ref import mix64_ref, partition_ref, route_ref


def route_shards(keys: np.ndarray, n_shards: int,
                 scheme: str = "hash") -> np.ndarray:
    """Shard id per key: [Q] int32 in [0, n_shards)."""
    return route_ref(np.asarray(keys, np.int64), n_shards, scheme)


def partition_writes(keys: np.ndarray, n_shards: int, scheme: str = "hash"
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(shards, order, offsets) for a write batch — see partition_ref."""
    keys = np.asarray(keys, np.int64)
    with _OBS.span("kernel.partition", batch=int(keys.size),
                   n_shards=n_shards):
        return partition_ref(keys, n_shards, scheme)


__all__ = ["mix64_ref", "partition_writes", "route_ref", "route_shards"]
