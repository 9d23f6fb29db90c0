"""Shard routing: splitmix64 / key-prefix routes on the host or, for
the sharded plan path, in ``csrc/shard_route.cu``: ``shard_route`` (ids
only) and ``shard_partition`` (ids, the stable sort-by-shard permutation
and the run offsets, on the card); plus the write path's partition, on
the host."""

from .kernel import (LAUNCHES, MAX_PARTITION_BITS, reset_launches,
                     shard_partition, shard_route)
from .ops import mix64_ref, partition_writes, route_ref, route_shards
from .ref import (partition_ref, route_params, shard_partition_plain,
                  shard_route_plain)

__all__ = ["LAUNCHES", "MAX_PARTITION_BITS", "mix64_ref", "partition_ref",
           "partition_writes", "reset_launches", "route_params", "route_ref",
           "route_shards", "shard_partition", "shard_partition_plain",
           "shard_route", "shard_route_plain"]
