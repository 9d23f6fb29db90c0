"""Fingerprint lane primitives (Dash-style).

A fingerprint is a 1-byte digest of a slot's key that rides the
snapshot export next to the full 64-bit words.  The probe kernels
compare the fingerprint lane first and read (and full-compare) the
64-bit key word only of slots whose fingerprint matches the query's.

Two lanes exist:

* ``fp64`` — the splitmix64 top byte, for hash-bucket and sorted-run
  slot arrays (P-CLHT buckets, P-Masstree / P-BwTree sorted runs);
* ``fp_partial`` — the low key byte, for radix node pages (P-ART /
  P-HOT leaves): the partial-key byte a real radix node keeps inline.

Value 0 is reserved for *empty* (an empty slot or a non-leaf node): a
live key's fingerprint is remapped ``0 -> 1``.
Query fingerprints use the same function, so a true hit always
fingerprint-matches.  The one query whose fingerprint is 0 is key 0
(the NULL word): it matches empty slots and the lanes past a chain's
end, exactly as in the JAX package.

Both run in numpy ``uint64``: splitmix64 needs logical right shifts,
and torch's int64 ``>>`` is arithmetic.

``account`` is the shared probe-traffic model: a full-key candidate
verification costs 2 PM words (key + value), the fingerprint lane
costs 1 byte per compared lane.  It feeds the ``probe_stats`` dict on
``RecipeIndex`` (same key set as ``conditions.PROBE_STAT_KEYS``) and is
copied from the JAX package unchanged, fingerprints-off branch
included, because ``probe_stats`` is held bit-exact against it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..partition.ref import mix64_ref

_U64 = np.uint64

#: fingerprint value reserved for empty slots
FP_EMPTY = 0


def fp64(keys: np.ndarray) -> np.ndarray:
    """1-byte hash fingerprints: splitmix64 top byte, 0 reserved for
    empty (NULL-keyed) slots, live fingerprints remapped 0 -> 1."""
    k = np.asarray(keys)
    fp = (mix64_ref(k) >> _U64(56)).astype(np.uint8)
    fp = fp + (fp == 0)
    return np.where(k == 0, np.uint8(FP_EMPTY), fp).astype(np.uint8)


def fp_partial(keys: np.ndarray) -> np.ndarray:
    """1-byte partial-key fingerprints (the low key byte) for radix
    leaf pages; the 0 -> 1 remap reserves 0 for non-leaf rows."""
    b = (np.asarray(keys).astype(np.uint64) & _U64(0xFF)).astype(np.uint8)
    return (b + (b == 0)).astype(np.uint8)


def account(stats: Optional[dict], *, lanes: int, fp_candidates: int,
            fp_hits: int, fp_false: int, fingerprints: bool) -> None:
    """Fold one probe dispatch into a ``probe_stats`` dict.

    ``lanes`` is the number of candidate lanes the fingerprint lane
    compared (or, with fingerprints off, full-compared); with
    fingerprints on, ``fp_candidates`` lanes survived the filter and
    were fully verified, ``fp_hits`` of them matched the full key and
    ``fp_false`` did not (``fp_candidates == fp_hits + fp_false``).
    The modeled PM traffic charges 2 words (key + value) per full
    verification plus 1 byte per fingerprint-lane compare."""
    if stats is None:
        return
    if fingerprints:
        assert fp_candidates == fp_hits + fp_false, \
            (fp_candidates, fp_hits, fp_false)
        stats["fp_compares"] += int(lanes)
        stats["candidates"] += int(fp_candidates)
        stats["fp_hits"] += int(fp_hits)
        stats["fp_false_positives"] += int(fp_false)
        stats["pm_load_words"] += (int(lanes) + 7) // 8 + 2 * int(fp_candidates)
    else:
        stats["candidates"] += int(lanes)
        stats["pm_load_words"] += 2 * int(lanes)


__all__ = ["FP_EMPTY", "account", "fp64", "fp_partial"]
