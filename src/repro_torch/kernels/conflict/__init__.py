"""Plan-conflict detection: the op kind codes, the pairwise conflict
relation, the admission check of the multi-stream driver (host oracle,
or the ``conflict_any`` kernel on a device) and the O(n²) peeling
oracle."""

from .kernel import LAUNCHES, reset_launches
from .ops import (DELETE, GET, PUT, SCAN, UPDATE, conflict_any,
                  conflict_any_ref, conflict_matrix_ref, is_write_kind,
                  wave_levels_ref)
from .ref import conflict_any_plain

__all__ = ["DELETE", "GET", "LAUNCHES", "PUT", "SCAN", "UPDATE",
           "conflict_any", "conflict_any_plain", "conflict_any_ref",
           "conflict_matrix_ref", "is_write_kind", "reset_launches",
           "wave_levels_ref"]
