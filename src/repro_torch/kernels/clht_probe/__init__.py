"""Batched P-CLHT lookups: the splitmix64 bucket hash and the snapshot
front-end of the chained probe kernel; the 32-bit tag probe kernels
(``tag_probe``, the whole lookup; ``clht_probe``, its window form),
their plain versions and the ``tag_lookup`` front-end."""

from .kernel import LAUNCHES, clht_probe, reset_launches, tag_probe
from .ops import mix64, snapshot_lookup, tag_hash, tag_lookup, tag_windows
from .ref import probe_plain, tag_lookup_np, tag_probe_plain, tag_table_np

__all__ = ["LAUNCHES", "clht_probe", "mix64", "probe_plain",
           "reset_launches", "snapshot_lookup", "tag_hash", "tag_lookup",
           "tag_lookup_np", "tag_probe", "tag_probe_plain", "tag_table_np",
           "tag_windows"]
