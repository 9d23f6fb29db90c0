"""Numpy oracle for operation-plan conflict detection.

Two plan ops *conflict* when they must not share a conflict-free wave
— executing them in the same batched dispatch could change an
observable result.  The rules (see ``core/plan.py``):

* reads never conflict with reads: GET–GET, GET–SCAN and SCAN–SCAN
  pairs are always wave-compatible, *including scans over identical
  start keys* (a scan window is read-only state);
* a GET conflicts with a write (PUT/UPDATE/DELETE) of the same key —
  whichever comes first in program order must be in an earlier wave;
* a SCAN conflicts with a write whose key falls in the scan's window.
  A window is "the first ``count`` live entries at or above ``start``"
  — its upper edge depends on live state, so the detector uses the
  conservative closure ``[start, +inf)``: a write with
  ``key >= start`` conflicts;
* two writes of the same key do NOT conflict *for wave membership*:
  the per-wave write primitive routes same-key ops to the same shard
  and applies them in arrival order (stable partition), so their
  program order survives inside one wave.  ``writes_conflict=True``
  switches this off for callers that need the strict relation.

``conflict_matrix_ref``/``conflict_any_ref`` are the vectorized
pairwise forms; ``wave_levels_ref`` is the O(n²) peeling oracle for
wave scheduling — the ground truth ``core.plan.schedule_waves``'s fast
paths are tested against.  Copied from the JAX package's
``kernels/conflict/ref.py``.  ``conflict_any_plain`` is the plain
PyTorch version of the CUDA kernel (``csrc/conflict_any.cu``): the same
relation on tensors, reduced over the reference set.
"""

from __future__ import annotations

import numpy as np
import torch

# op kind codes — shared with core.plan (kept dependency-free here so
# the kernel package imports nothing from core)
GET, PUT, UPDATE, DELETE, SCAN = 0, 1, 2, 3, 4


def is_write_kind(kinds: np.ndarray) -> np.ndarray:
    kinds = np.asarray(kinds)
    return (kinds == PUT) | (kinds == UPDATE) | (kinds == DELETE)


def conflict_matrix_ref(kinds_a: np.ndarray, keys_a: np.ndarray,
                        kinds_b: np.ndarray, keys_b: np.ndarray, *,
                        writes_conflict: bool = False) -> np.ndarray:
    """[A, B] bool: ``out[i, j]`` iff op ``a_i`` conflicts with ``b_j``.

    The relation is symmetric in the pair (order of the two sets does
    not matter); program order is the *scheduler's* concern, not the
    detector's.
    """
    kinds_a = np.asarray(kinds_a)
    kinds_b = np.asarray(kinds_b)
    keys_a = np.asarray(keys_a, np.int64)[:, None]
    keys_b = np.asarray(keys_b, np.int64)[None, :]
    wa = is_write_kind(kinds_a)[:, None]
    wb = is_write_kind(kinds_b)[None, :]
    ga = (kinds_a == GET)[:, None]
    gb = (kinds_b == GET)[None, :]
    sa = (kinds_a == SCAN)[:, None]
    sb = (kinds_b == SCAN)[None, :]
    same_key = keys_a == keys_b
    out = same_key & ((ga & wb) | (wa & gb))
    out |= sa & wb & (keys_b >= keys_a)  # write lands in a's window
    out |= wa & sb & (keys_a >= keys_b)  # a's write lands in b's window
    if writes_conflict:
        out |= same_key & wa & wb
    return out


def conflict_any_ref(kinds_a: np.ndarray, keys_a: np.ndarray,
                     kinds_b: np.ndarray, keys_b: np.ndarray, *,
                     writes_conflict: bool = False) -> np.ndarray:
    """[A] bool: does ``a_i`` conflict with ANY op in the B set."""
    if np.asarray(kinds_b).size == 0:
        return np.zeros(np.asarray(kinds_a).shape, bool)
    return conflict_matrix_ref(kinds_a, keys_a, kinds_b, keys_b,
                               writes_conflict=writes_conflict).any(axis=1)


def conflict_any_plain(kinds_a: torch.Tensor, keys_a: torch.Tensor,
                       kinds_b: torch.Tensor, keys_b: torch.Tensor, *,
                       writes_conflict: bool = False) -> torch.Tensor:
    """kinds: int32, keys: int64 tensors, [A] and [B].  Returns [A]
    bool, ``conflict_any_ref`` on tensors: the [A, B] relation of
    ``conflict_matrix_ref`` (its ``>=`` the signed int64 order), then
    any over B."""
    if kinds_b.numel() == 0:
        return torch.zeros(kinds_a.shape, dtype=torch.bool,
                           device=kinds_a.device)

    def is_write(k):
        return (k == PUT) | (k == UPDATE) | (k == DELETE)

    ka, kb = kinds_a.unsqueeze(1), kinds_b.unsqueeze(0)
    a, b = keys_a.unsqueeze(1), keys_b.unsqueeze(0)
    wa, wb = is_write(ka), is_write(kb)
    same = a == b
    out = same & (((ka == GET) & wb) | (wa & (kb == GET)))
    out |= (ka == SCAN) & wb & (b >= a)
    out |= wa & (kb == SCAN) & (a >= b)
    if writes_conflict:
        out |= same & wa & wb
    return out.any(dim=1)


def wave_levels_ref(kinds: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """[N] wave level per op — the peeling oracle.

    Level of op ``i`` = 1 + max level over earlier ops it conflicts
    with (0 when none): repeatedly peel the set of ops whose earlier
    conflicts have all been peeled.  O(n²) — this is the testing
    oracle; ``core.plan.schedule_waves`` computes the same levels with
    vectorized per-key alternation counting plus per-level range
    summaries.
    """
    kinds = np.asarray(kinds)
    keys = np.asarray(keys, np.int64)
    n = kinds.shape[0]
    levels = np.full(n, -1, np.int64)
    if n == 0:
        return levels
    conf = conflict_matrix_ref(kinds, keys, kinds, keys)
    conf &= np.tri(n, k=-1, dtype=bool)  # keep only earlier-op edges
    remaining = np.ones(n, bool)
    level = 0
    while remaining.any():
        ready = remaining & ~(conf & remaining[None, :]).any(axis=1)
        assert ready.any(), "conflict peeling stalled"
        levels[ready] = level
        remaining &= ~ready
        level += 1
    return levels
