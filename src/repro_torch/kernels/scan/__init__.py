"""Batched sorted-run search for the ordered indexes (P-Masstree and
P-BwTree lookups, every ordered index's range scans): the CUDA kernel
wrapper, its plain PyTorch version, the numpy oracles and the snapshot
front-end."""

from .kernel import (LAUNCHES, WINDOWS, reset_launches, scan_window,
                     scan_window_rows)
from .ops import (SCAN_LANES, prepare_sorted, snapshot_lookup, snapshot_scan,
                  sorted_lookup, sorted_scan)
from .ref import (lookup_ref, scan_ref, scan_window_plain,
                  scan_window_rows_plain)

__all__ = ["LAUNCHES", "SCAN_LANES", "WINDOWS", "lookup_ref", "prepare_sorted",
           "reset_launches", "scan_ref", "scan_window", "scan_window_plain",
           "scan_window_rows", "scan_window_rows_plain", "snapshot_lookup",
           "snapshot_scan", "sorted_lookup", "sorted_scan"]
