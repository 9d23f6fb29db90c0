"""Shard routing: splitmix64 / key-prefix routes on the host or, for
the sharded plan path, in the ``shard_route`` kernel; plus the stable
sort-by-shard partition of the write path, on the host."""

from .kernel import LAUNCHES, reset_launches, shard_route
from .ops import mix64_ref, partition_writes, route_ref, route_shards
from .ref import route_params, shard_route_plain

__all__ = ["LAUNCHES", "mix64_ref", "partition_writes", "reset_launches",
           "route_params", "route_ref", "route_shards", "shard_route",
           "shard_route_plain"]
