"""Host front-end: radix node-page exports -> ``art_descend`` launches.

Per epoch, the export's node pages are uploaded to the index's device
once and memoized on the snapshot under ``"art_probe"``: the child
table with each child's level and leaf bit packed into its parent's
entry (``pack_children``, so a step of the descent is one load), the
``leaf_fp`` lane and the leaf words; the export's ``unit_bits`` (8 for
P-ART, 4 for P-HOT, a plain int) selects the unit width.  Per batch:
the queries go to the device, one kernel launch descends them all, and
the results and counts come back in one copy (``readback.to_host``).

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
from ..readback import to_host
from .kernel import art_descend, pack_entries
from .ref import LEAF_BIT, ROW_BITS, leaf_fp_lane

#: rows a packed child entry can name (bits 0-25)
MAX_ROWS = 1 << ROW_BITS


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


def _put(a, dtype, device: torch.device, copy: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device,
                                                                copy=copy)


def upload_children(children: np.ndarray, level: np.ndarray,
                    is_leaf: np.ndarray, *, unit_bits: int,
                    device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The child table on ``device`` as the export holds it (a copy, even
    on the CPU, since the packing rewrites it in place), each row's
    header ([N] int32: its level, clamped to [0, U - 1] as the kernel
    clamps it, | its leaf bit << 4) and the root's header: the inputs of
    ``kernel.pack_entries``.  Raises above ``MAX_ROWS`` rows, which 26
    bits cannot name."""
    n_nodes = children.shape[0]
    if n_nodes > MAX_ROWS:
        raise ValueError(f"{n_nodes} node rows: packed child entries name "
                         f"at most {MAX_ROWS}")
    n_units = 64 // unit_bits
    level = np.asarray(level)
    leaf = np.asarray(is_leaf) != 0
    root = int(np.clip(level[0], 0, n_units - 1)) | int(leaf[0]) * LEAF_BIT
    table = _put(children, np.int32, device, copy=True)
    hdr = torch.bitwise_or(
        _put(level, np.int32, device).clamp(0, n_units - 1),
        _put(leaf, np.uint8, device).to(torch.int32) * LEAF_BIT)
    return table, hdr, root


def pack_children(children: np.ndarray, level: np.ndarray,
                  is_leaf: np.ndarray, *, unit_bits: int,
                  device: torch.device) -> Tuple[torch.Tensor, int]:
    """The child table on ``device`` with each child's header packed into
    its parent's entry, and the root's header.

    An entry naming a child in [0, N) becomes the child's row | its
    clamped level << 26 | its leaf bit << 30; every other entry becomes
    -1.  The table is uploaded once and rewritten in place
    (``kernel.pack_entries``: one pass on the card), so no second copy
    of it is made.  A header is an entry shifted down by 26."""
    table, hdr, root = upload_children(children, level, is_leaf,
                                       unit_bits=unit_bits, device=device)
    pack_entries(table, hdr)
    return table, root


def _prepare(arrays: Dict[str, np.ndarray], device: torch.device) -> tuple:
    """The node pages on ``device``: (unit_bits, children [N, fan]
    int32 packed entries, the root's header, lfp [N] uint8, leaf_key,
    leaf_val [N] int64)."""
    unit_bits = int(arrays.get("unit_bits", 8))
    children, root = pack_children(arrays["children"], arrays["level"],
                                   arrays["is_leaf"], unit_bits=unit_bits,
                                   device=device)
    return (unit_bits, children, root,
            _put(leaf_fp_lane(arrays), np.uint8, device),
            _put(arrays["leaf_key"], np.int64, device),
            _put(arrays["leaf_val"], np.int64, device))


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
        # one copy to the host.  lanes = leaves actually reached (the
        # radix descent has no fixed window; internal hops are index
        # words, not key lanes)
        values, nenc, nfp, nfalse, found = to_host(values, nenc, nfp,
                                                   nfalse, found)
        lanes, cand, false = (int(c.sum()) for c in (nenc, nfp, nfalse))
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


__all__ = ["MAX_ROWS", "batched_lookup", "key_units", "pack_children",
           "snapshot_lookup", "upload_children"]
