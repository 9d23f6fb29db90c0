"""The batched radix descent (P-ART and P-HOT): the numpy oracle and
the plain PyTorch version of the CUDA kernel.

``descend_fp_ref`` is the JAX package's scalar oracle, copied: per
query, walk from node 0 by key unit, trusting ``level``, and verify
the full key at the leaf.  ``descend_plain`` computes what
``csrc/art_descend.cu`` computes, with torch indexing and no custom
kernel: the kernel's lockstep loop of ``U + 1`` steps over the whole
batch (gathers of ``is_leaf``, ``lfp``, ``level`` and ``children``),
the level clamped to ``[0, U - 1]`` as the TPU kernel clamps it.  The
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


def key_unit(queries: torch.Tensor, lvl: torch.Tensor,
             unit_bits: int) -> torch.Tensor:
    """The big-endian ``unit_bits``-wide unit of each query at ``lvl``
    (the int64 tensors carry uint64 bit patterns)."""
    n_units = KEY_BITS // unit_bits
    shift = unit_bits * (n_units - 1 - lvl)
    return (queries >> shift) & ((1 << unit_bits) - 1)


def descend_plain(queries: torch.Tensor, children: torch.Tensor,
                  level: torch.Tensor, is_leaf: torch.Tensor,
                  lfp: torch.Tensor, leaf_key: torch.Tensor,
                  leaf_val: torch.Tensor, *, unit_bits: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """queries: [Q] int64; children: [N, 2^unit_bits] int32 (-1 none);
    level: [N] int32; is_leaf, lfp: [N] uint8; leaf_key, leaf_val: [N]
    int64.  Returns (found [Q] bool, values [Q] int64, nenc, nfp,
    nfalse [Q] int32).  A child index outside [0, N) ends the walk, as
    -1 does."""
    n_units = KEY_BITS // unit_bits
    n_nodes = children.shape[0]
    dev = queries.device
    n_q = queries.shape[0]
    qfp = queries & 0xFF
    qfp = qfp + (qfp == 0)
    node = torch.zeros(n_q, dtype=torch.int64, device=dev)
    active = torch.ones(n_q, dtype=torch.bool, device=dev)
    found = torch.zeros(n_q, dtype=torch.bool, device=dev)
    values = torch.zeros(n_q, dtype=torch.int64, device=dev)
    nenc = torch.zeros(n_q, dtype=torch.int32, device=dev)
    nfp = torch.zeros(n_q, dtype=torch.int32, device=dev)
    nfalse = torch.zeros(n_q, dtype=torch.int32, device=dev)
    for _ in range(n_units + 1):
        leaf = active & (is_leaf[node] != 0)
        fpmatch = leaf & (lfp[node].to(torch.int64) == qfp)
        hit = fpmatch & (leaf_key[node] == queries) & (leaf_val[node] != 0)
        found |= hit
        values = torch.where(hit, leaf_val[node], values)
        nenc += leaf
        nfp += fpmatch
        nfalse += fpmatch & ~hit
        active &= ~leaf
        lvl = level[node].to(torch.int64).clamp(0, n_units - 1)
        child = children[node, key_unit(queries, lvl, unit_bits)]
        child = child.to(torch.int64)
        active &= (child >= 0) & (child < n_nodes)
        node = torch.where(active, child, node)
    return found, values, nenc, nfp, nfalse


__all__ = ["descend_fp_ref", "descend_plain", "key_unit", "leaf_fp_lane"]
