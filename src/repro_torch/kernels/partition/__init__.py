"""Shard routing for the batched write path: splitmix64 / key-prefix
routes plus the stable sort-by-shard partition, on the host."""

from .ops import mix64_ref, partition_writes, route_ref, route_shards

__all__ = ["mix64_ref", "partition_writes", "route_ref", "route_shards"]
