"""Host front-end: radix node-page exports -> ``art_descend`` launches.

Per epoch, the export's node pages (``children``, ``level``,
``is_leaf``, the ``leaf_fp`` lane and the leaf words) are uploaded to
the index's device once and memoized on the snapshot under
``"art_probe"``; the export's ``unit_bits`` (8 for P-ART, 4 for P-HOT,
a plain int) selects the unit width.  Per batch: the queries go to the
device, one kernel launch descends them all, and three summed counts
come back with the results.

The descent carries the export's partial-key fingerprint lane: each
leaf's inline byte is compared before the full 64-bit key, and the
filter's hit/false-positive counts plus the modeled PM gather traffic
fold into the caller's ``stats`` dict exactly as the JAX package's
``kernels/art_probe/ops.py`` folds them (see
``kernels.probe.fingerprint.account``).  The JAX wrapper pads the batch
to whole kernel blocks and slices the padding off before summing; the
port launches exactly Q threads, so the counts are the same.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...obs import RECORDER as _OBS
from ..probe.fingerprint import account
from .kernel import art_descend
from .ref import leaf_fp_lane


def key_units(keys: np.ndarray, unit_bits: int = 8) -> np.ndarray:
    """[Q] int64 -> [Q, 64//unit_bits] int32 big-endian key units
    (core.art.key_byte for unit_bits=8, core.hot.nibble for 4).  The
    kernel takes its units from the key word itself; this host form is
    for callers and tests."""
    u = np.asarray(keys).astype(np.uint64)
    n_units = 64 // unit_bits
    shifts = np.uint64(unit_bits) * np.arange(n_units - 1, -1, -1,
                                              dtype=np.uint64)
    mask = np.uint64((1 << unit_bits) - 1)
    return ((u[:, None] >> shifts[None, :]) & mask).astype(np.int32)


def _prepare(arrays: Dict[str, np.ndarray], device: torch.device) -> tuple:
    """The node pages on ``device``: (unit_bits, children [N, fan]
    int32, level [N] int32, is_leaf [N] uint8, lfp [N] uint8, leaf_key,
    leaf_val [N] int64)."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return (int(arrays.get("unit_bits", 8)),
            put(arrays["children"], np.int32),
            put(arrays["level"], np.int32),
            put(np.asarray(arrays["is_leaf"]) != 0, np.uint8),
            put(leaf_fp_lane(arrays), np.uint8),
            put(arrays["leaf_key"], np.int64),
            put(arrays["leaf_val"], np.int64))


def _descend(queries: np.ndarray, pages: tuple, *, fingerprints: bool,
             stats: Optional[dict]) -> Tuple[np.ndarray, np.ndarray]:
    unit_bits, *node_pages = pages
    q = np.asarray(queries, np.int64)
    n_q = q.shape[0]
    device = node_pages[0].device
    with _OBS.span("kernel.art_probe", batch=n_q, padded=n_q,
                   pad_ratio=0.0, unit_bits=unit_bits,
                   fingerprints=fingerprints) as sp:
        found, values, nenc, nfp, nfalse = art_descend(
            torch.from_numpy(q).to(device), *node_pages,
            unit_bits=unit_bits)
        # lanes = leaves actually reached (the radix descent has no
        # fixed window; internal hops are index words, not key lanes)
        lanes, cand, false = (int(c) for c in torch.stack(
            [nenc.sum(), nfp.sum(), nfalse.sum()]).tolist())
        found = found.cpu().numpy()
        values = values.cpu().numpy()
        if fingerprints:
            account(stats, lanes=lanes, fp_candidates=cand,
                    fp_hits=cand - false, fp_false=false, fingerprints=True)
            if sp:
                sp.set(fp_candidates=cand, fp_false_positives=false)
        else:
            account(stats, lanes=lanes, fp_candidates=0, fp_hits=0,
                    fp_false=0, fingerprints=False)
    return found, np.where(found, values, 0)


def batched_lookup(queries: np.ndarray, arrays: Dict[str, np.ndarray], *,
                   device: torch.device, fingerprints: bool = True,
                   stats: Optional[dict] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """queries: [Q] int64; arrays: PART/PHOT ``export_arrays`` output.
    Returns (found [Q] bool, values [Q] int64), bit-identical to the
    scalar ``lookup`` against the same snapshot."""
    return _descend(queries, _prepare(arrays, device),
                    fingerprints=fingerprints, stats=stats)


def snapshot_lookup(snap, queries: np.ndarray, *, device: torch.device,
                    fingerprints: bool = True, stats: Optional[dict] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched lookup against an ``IndexSnapshot`` of PART or PHOT node
    pages; the upload to ``device`` is memoized on the snapshot."""
    pages = snap.cache.get("art_probe")
    if pages is None:
        pages = snap.cache["art_probe"] = _prepare(snap.arrays, device)
    return _descend(queries, pages, fingerprints=fingerprints, stats=stats)


__all__ = ["batched_lookup", "key_units", "snapshot_lookup"]
