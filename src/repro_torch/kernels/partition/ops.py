"""Host front-end for shard routing + stable sort-by-shard.

``route_shards`` is what ``distributed.ShardedIndex.route`` calls for
every plan.  With ``device=None`` it is the host oracle ``route_ref``,
as the JAX package's default is; with a torch device it uploads the
keys and runs ``kernel.shard_route`` there (the CUDA kernel on the
card, its plain PyTorch version on the CPU), and the ids come back to
the host, which splits the plan.

``partition_writes`` is what ``RecipeIndex._write_batch`` calls: route
every op's key to a shard, then produce the stable sort-by-shard
permutation and per-shard run offsets.  It stays on the host: a write
batch is consumed op by op by the numpy PM simulator anyway.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...obs import RECORDER as _OBS
from .kernel import shard_route
from .ref import mix64_ref, partition_ref, route_params, route_ref


def route_shards(keys: np.ndarray, n_shards: int, scheme: str = "hash", *,
                 device: Optional[torch.device] = None) -> np.ndarray:
    """Shard id per key: [Q] int32 in [0, n_shards)."""
    keys = np.asarray(keys, np.int64)
    if device is None:
        return route_ref(keys, n_shards, scheme)
    bits, shift = route_params(n_shards, scheme)
    out = shard_route(torch.from_numpy(np.ascontiguousarray(keys))
                      .to(device), bits=bits, shift=shift)
    return out.cpu().numpy()


def partition_writes(keys: np.ndarray, n_shards: int, scheme: str = "hash"
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(shards, order, offsets) for a write batch — see partition_ref."""
    keys = np.asarray(keys, np.int64)
    with _OBS.span("kernel.partition", batch=int(keys.size),
                   n_shards=n_shards):
        return partition_ref(keys, n_shards, scheme)


__all__ = ["mix64_ref", "partition_writes", "route_ref", "route_shards"]
