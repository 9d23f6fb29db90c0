"""Host front-end: sorted (keys, vals) exports -> ``scan_window``
launches.

The prepared form of a sorted run is the run on the index's device,
memoized on the ``IndexSnapshot`` under the ``"scan"`` cache key (with
the ``_EMPTY`` sentinel for an empty structure), so steady-state
batches pay one upload of the queries, one launch and one copy back.
The run is used at its own length: the JAX package pads it to a power
of two so its traced shapes survive epoch changes, and pads query
batches to whole blocks; the port has neither to keep, and launches
exactly Q queries.  Results and the fingerprint accounting are the JAX
package's, bit for bit.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...obs import RECORDER as _OBS
from ..probe.fingerprint import account, fp64
from .kernel import scan_window

# window widths are rounded up to whole lane rows (YCSB-E counts are
# 1..100 -> always 128), as in the JAX package
SCAN_LANES = 128

_EMPTY = ("scan-empty",)  # cache sentinel for an empty structure


def prepare_sorted(keys: np.ndarray, vals: np.ndarray, *,
                   device: torch.device) -> tuple:
    """The sorted run on ``device``: (keys [N] int64, vals [N] int64)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int64))
                 .to(device) for a in (keys, vals))


def _run_kernel(queries: np.ndarray, counts: np.ndarray, prepared: tuple,
                *, lane_round: int = SCAN_LANES
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    keys, vals = prepared
    q = np.asarray(queries, np.int64)
    c = np.asarray(counts, np.int32)
    n_q = q.shape[0]
    width = max(1, int(c.max()) if c.size else 1)
    width = -(-width // lane_round) * lane_round
    with _OBS.span("kernel.scan", batch=n_q, padded=n_q, pad_ratio=0.0,
                   window=width):
        valid, okeys, ovals = scan_window(
            torch.from_numpy(q).to(keys.device),
            torch.from_numpy(c).to(keys.device), keys, vals,
            max_count=width)
        valid = valid.cpu().numpy()
        okeys = okeys.cpu().numpy()
        ovals = ovals.cpu().numpy()
    return valid, okeys, ovals


def sorted_lookup(queries: np.ndarray, prepared: tuple, *,
                  fingerprints: bool = True, stats: Optional[dict] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Point lookups over a prepared sorted run: lower bound + window of
    1 + key-equality check.  Returns (found [Q] bool, values [Q] int64),
    bit-identical to a scalar binary search.

    The fingerprint lane of a sorted-run export is ``fp64(keys)`` by
    protocol, so the filter outcome at the lower-bound entry is exactly
    ``fp64(q) == fp64(okeys)``: the accounting reconstructs it on the
    host from the gathered candidate keys, in numpy ``uint64`` (the
    search path itself touches index words, not key lanes, and is not
    fingerprinted)."""
    q = np.asarray(queries, np.int64)
    # lane_round=1: a lookup needs a window of exactly one entry
    valid, okeys, ovals = _run_kernel(q, np.ones(q.shape[0], np.int32),
                                      prepared, lane_round=1)
    live = valid[:, 0]
    found = live & (okeys[:, 0] == q)
    lanes = int(live.sum())
    if fingerprints:
        # empty lanes gather key 0 whose fp is FP_EMPTY; query fps are
        # >= 1, so the lane mask is already folded into the compare
        fpmatch = live & (fp64(q) == fp64(okeys[:, 0]))
        cand = int(fpmatch.sum())
        false = int((fpmatch & ~found).sum())
        account(stats, lanes=lanes, fp_candidates=cand,
                fp_hits=cand - false, fp_false=false, fingerprints=True)
    else:
        account(stats, lanes=lanes, fp_candidates=0, fp_hits=0,
                fp_false=0, fingerprints=False)
    return found, np.where(found, ovals[:, 0], 0)


def sorted_scan(starts: np.ndarray, counts: np.ndarray, prepared: tuple
                ) -> List[List[Tuple[int, int]]]:
    """Range scans over a prepared sorted run: per query, the first
    ``counts[i]`` entries with key >= starts[i] in ascending order."""
    valid, okeys, ovals = _run_kernel(starts, counts, prepared)
    out: List[List[Tuple[int, int]]] = []
    for m, row_k, row_v in zip(valid.sum(axis=1).tolist(), okeys, ovals):
        # prefix mask: the first m lanes are live
        out.append(list(zip(row_k[:m].tolist(), row_v[:m].tolist())))
    return out


Exporter = Callable[[], Optional[Tuple[np.ndarray, np.ndarray]]]


def _prepared_from(snap, exporter: Exporter, device: torch.device):
    prepared = snap.cache.get("scan")
    if prepared is None:
        arrays = exporter()
        prepared = (_EMPTY if arrays is None
                    else prepare_sorted(*arrays, device=device))
        snap.cache["scan"] = prepared
    return None if prepared is _EMPTY else prepared


def snapshot_lookup(snap, queries: np.ndarray, *, device: torch.device,
                    fingerprints: bool = True, stats: Optional[dict] = None
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Batched lookup against an ``IndexSnapshot`` whose ``arrays`` is
    the sorted {"keys", "vals"} export (P-Masstree / P-BwTree); the
    upload to ``device`` is memoized on the snapshot."""
    prepared = _prepared_from(
        snap, lambda: None if snap.arrays is None
        else (snap.arrays["keys"], snap.arrays["vals"]), device)
    if prepared is None:
        return None
    return sorted_lookup(queries, prepared, fingerprints=fingerprints,
                         stats=stats)


def snapshot_scan(snap, starts: Sequence[int], counts: Sequence[int],
                  exporter: Exporter, *, device: torch.device
                  ) -> Optional[List[List[Tuple[int, int]]]]:
    """Batched range scans against an ``IndexSnapshot``; ``exporter``
    supplies the sorted run on first use (None for an empty structure)
    and its upload to ``device`` is memoized on the snapshot."""
    prepared = _prepared_from(snap, exporter, device)
    if prepared is None:
        return None
    return sorted_scan(np.asarray(starts, np.int64),
                       np.asarray(counts, np.int64), prepared)


__all__ = ["SCAN_LANES", "prepare_sorted", "snapshot_lookup",
           "snapshot_scan", "sorted_lookup", "sorted_scan"]
