"""Batched radix descent for P-ART and P-HOT: the CUDA kernel wrapper,
its plain PyTorch version, the numpy oracle and the snapshot
front-end."""

from .kernel import LAUNCHES, art_descend, reset_launches
from .ops import batched_lookup, key_units, pack_children, snapshot_lookup
from .ref import descend_fp_ref, descend_plain, leaf_fp_lane

__all__ = ["LAUNCHES", "art_descend", "batched_lookup", "descend_fp_ref",
           "descend_plain", "key_units", "leaf_fp_lane", "pack_children",
           "reset_launches", "snapshot_lookup"]
