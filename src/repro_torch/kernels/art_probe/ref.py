"""The batched radix descent (P-ART and P-HOT): the numpy oracle and
the plain PyTorch version of the CUDA kernel.

``descend_fp_ref`` is the JAX package's scalar oracle, copied: per
query, walk from node 0 by key unit, trusting ``level``, and verify
the full key at the leaf.  ``descend_plain`` computes what
``csrc/art_descend.cu`` computes, with torch indexing and no custom
kernel: the kernel's lockstep loop of ``U + 1`` steps over the whole
batch, on the packed child entries (each carries its child's level,
clamped to ``[0, U - 1]`` as the TPU kernel clamps it, and leaf bit).  The
CPU tests hold it against the JAX package; ``chip_smoke.py`` holds the
CUDA kernel against it.

Key units: ``key_unit`` masks torch's arithmetic ``>>`` to the unit's
width, and the sign bits it shifts in fall outside that mask, so keys
of 2^63 and above (negative as int64) give the units of the uint64 key
(the kernel shifts a ``uint64_t``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..probe.fingerprint import fp_partial

KEY_BITS = 64
# a packed child entry (``ops.pack_children``): the row in bits 0-25, the
# child's clamped level in bits 26-29, its leaf bit in bit 30; a header
# is an entry shifted down by ROW_BITS
ROW_BITS = 26
ROW_MASK = (1 << ROW_BITS) - 1
LEVEL_MASK = 15
LEAF_BIT = 16
PACK_CHUNK = 1 << 24


def leaf_fp_lane(arrays: Dict[str, np.ndarray]) -> np.ndarray:
    """The export's partial-key fingerprint lane, or the canonical
    reconstruction when the export predates it: ``fp_partial`` of each
    leaf's key, 0 (FP_EMPTY) on non-leaf rows."""
    lane = arrays.get("leaf_fp")
    if lane is not None:
        return np.asarray(lane, np.int64)
    is_leaf = np.asarray(arrays["is_leaf"]) != 0
    return np.where(is_leaf, fp_partial(arrays["leaf_key"]), 0)


def descend_fp_ref(queries: np.ndarray, arrays: Dict[str, np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
    """Scalar descent mirroring the fingerprinted kernel lane for lane.

    Returns (found [Q] bool, vals [Q] int64, n_leaf_checks, n_fp_match,
    n_fp_false [Q] int64): per query, the number of leaves whose
    fingerprint byte was compared, how many matched, and how many of
    those the full 64-bit key (or a tombstone value) rejected."""
    children = arrays["children"]
    level = arrays["level"]
    is_leaf = arrays["is_leaf"]
    leaf_key = arrays["leaf_key"]
    leaf_val = arrays["leaf_val"]
    leaf_fp = leaf_fp_lane(arrays)
    unit_bits = int(arrays.get("unit_bits", 8))
    n_units = KEY_BITS // unit_bits
    mask = (1 << unit_bits) - 1
    q = np.asarray(queries, np.int64)
    qfp = fp_partial(q)
    n_q = len(q)
    found = np.zeros(n_q, bool)
    vals = np.zeros(n_q, np.int64)
    nenc = np.zeros(n_q, np.int64)
    nfp = np.zeros(n_q, np.int64)
    nfalse = np.zeros(n_q, np.int64)
    for i, key in enumerate(q):
        node = 0
        for _ in range(n_units + 1):
            if is_leaf[node]:
                nenc[i] += 1
                if leaf_fp[node] == qfp[i]:
                    nfp[i] += 1
                    if leaf_key[node] == key and leaf_val[node] != 0:
                        found[i] = True
                        vals[i] = leaf_val[node]
                    else:
                        nfalse[i] += 1
                break
            shift = unit_bits * (n_units - 1 - int(level[node]))
            child = children[node, (int(key) >> shift) & mask]
            if child < 0:
                break
            node = child
    return found, vals, nenc, nfp, nfalse


def pack_entries_plain(children: torch.Tensor, hdr: torch.Tensor) -> None:
    """What ``csrc/art_descend.cu``'s ``pack_entries_kernel`` does, in
    place: each entry of ``children`` ([N, fan] int32) naming a row in
    [0, N) gains that row's header from ``hdr`` ([N] int32, clamped
    level | leaf << 4) shifted up by ROW_BITS; every other entry becomes
    -1.  In slices of about PACK_CHUNK entries, so no copy of the table
    is made."""
    n_nodes, fan = children.shape
    none = torch.full((), -1, dtype=torch.int32, device=children.device)
    step = max(1, PACK_CHUNK // fan)
    for lo in range(0, n_nodes, step):
        rows = children[lo:lo + step]
        child = rows.clamp(0, n_nodes - 1)
        entry = hdr.index_select(0, child.view(-1)).view_as(child)
        entry.bitwise_left_shift_(ROW_BITS).bitwise_or_(child)
        torch.where(child == rows, entry, none, out=rows)


def key_unit(queries: torch.Tensor, lvl: torch.Tensor,
             unit_bits: int) -> torch.Tensor:
    """The big-endian ``unit_bits``-wide unit of each query at ``lvl``
    (the int64 tensors carry uint64 bit patterns)."""
    n_units = KEY_BITS // unit_bits
    shift = unit_bits * (n_units - 1 - lvl)
    return (queries >> shift) & ((1 << unit_bits) - 1)


def descend_plain(queries: torch.Tensor, children: torch.Tensor, root: int,
                  lfp: torch.Tensor, leaf_key: torch.Tensor,
                  leaf_val: torch.Tensor, *, unit_bits: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """queries: [Q] int64; children: [N, 2^unit_bits] int32 packed
    entries (``ops.pack_children``: row in bits 0-25, clamped level in
    26-29, leaf bit 30, -1 none); root: the root's header (clamped level
    | leaf << 4); lfp: [N] uint8; leaf_key, leaf_val: [N] int64.
    Returns (found [Q] bool, values [Q] int64, nenc, nfp, nfalse [Q]
    int32).  An entry whose row lies outside [0, N) ends the walk, as -1
    does."""
    n_units = KEY_BITS // unit_bits
    n_nodes = children.shape[0]
    dev = queries.device
    n_q = queries.shape[0]
    qfp = queries & 0xFF
    qfp = qfp + (qfp == 0)
    node = torch.zeros(n_q, dtype=torch.int64, device=dev)
    hdr = torch.full((n_q,), root, dtype=torch.int64, device=dev)
    active = torch.ones(n_q, dtype=torch.bool, device=dev)
    found = torch.zeros(n_q, dtype=torch.bool, device=dev)
    values = torch.zeros(n_q, dtype=torch.int64, device=dev)
    nenc = torch.zeros(n_q, dtype=torch.int32, device=dev)
    nfp = torch.zeros(n_q, dtype=torch.int32, device=dev)
    nfalse = torch.zeros(n_q, dtype=torch.int32, device=dev)
    for _ in range(n_units + 1):
        leaf = active & ((hdr & LEAF_BIT) != 0)
        fpmatch = leaf & (lfp[node].to(torch.int64) == qfp)
        hit = fpmatch & (leaf_key[node] == queries) & (leaf_val[node] != 0)
        found |= hit
        values = torch.where(hit, leaf_val[node], values)
        nenc += leaf
        nfp += fpmatch
        nfalse += fpmatch & ~hit
        active &= ~leaf
        lvl = (hdr & LEVEL_MASK).clamp(max=n_units - 1)
        entry = children[node, key_unit(queries, lvl, unit_bits)]
        entry = entry.to(torch.int64)
        active &= (entry >= 0) & ((entry & ROW_MASK) < n_nodes)
        node = torch.where(active, entry & ROW_MASK, node)
        hdr = torch.where(active, entry >> ROW_BITS, hdr)
    return found, values, nenc, nfp, nfalse


__all__ = ["LEAF_BIT", "LEVEL_MASK", "ROW_BITS", "ROW_MASK", "descend_fp_ref",
           "descend_plain", "key_unit", "leaf_fp_lane", "pack_entries_plain"]
