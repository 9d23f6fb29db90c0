"""Plan-conflict rules for the wave scheduler: the op kind codes, the
pairwise conflict relation and the O(n²) peeling oracle."""

from .ref import (DELETE, GET, PUT, SCAN, UPDATE, conflict_matrix_ref,
                  is_write_kind, wave_levels_ref)

__all__ = ["DELETE", "GET", "PUT", "SCAN", "UPDATE", "conflict_matrix_ref",
           "is_write_kind", "wave_levels_ref"]
