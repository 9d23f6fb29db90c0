"""Batched P-CLHT lookups: the splitmix64 bucket hash and the snapshot
front-end of the chained probe kernel."""

from .ops import mix64, snapshot_lookup

__all__ = ["mix64", "snapshot_lookup"]
