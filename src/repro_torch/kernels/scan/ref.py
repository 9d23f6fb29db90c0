"""The batched sorted-run search: the numpy oracles and the plain
PyTorch version of the CUDA kernel.

``lookup_ref`` and ``scan_ref`` are the JAX package's oracles, copied.
``scan_window_plain`` computes what ``csrc/scan_window.cu`` computes,
with torch indexing and no custom kernel: per query a lockstep lower
bound over the run (the first index whose key is >= the query), then a
[Q, C] window gather with a prefix-valid mask.  The order is signed
int64, the order of ``np.searchsorted`` on int64 and of the TPU
kernel's (signed high half, biased low half) compare: a query of 2^63
or above (negative as int64) has lower bound 0.  The CPU tests hold it
against the JAX package; ``chip_smoke.py`` holds the CUDA kernel
against it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def lookup_ref(queries: np.ndarray, keys: np.ndarray, vals: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Binary-search point lookups over a sorted run: the semantics
    ``scan_window`` + ``sorted_lookup`` reproduce bit for bit."""
    q = np.asarray(queries, np.int64)
    idx = np.searchsorted(keys, q, side="left")
    safe = np.clip(idx, 0, max(len(keys) - 1, 0))
    found = (idx < len(keys)) & (len(keys) > 0)
    found &= np.where(found, keys[safe] == q, False)
    out = np.where(found, vals[safe] if len(keys) else 0, 0)
    return found, out.astype(np.int64)


def scan_ref(starts: np.ndarray, counts: np.ndarray, keys: np.ndarray,
             vals: np.ndarray) -> List[List[Tuple[int, int]]]:
    """Per query, the first counts[i] entries with key >= starts[i]."""
    out = []
    for s, c in zip(np.asarray(starts, np.int64),
                    np.asarray(counts, np.int64)):
        i = int(np.searchsorted(keys, s, side="left"))
        j = min(i + int(c), len(keys))
        out.append(list(zip(keys[i:j].tolist(), vals[i:j].tolist())))
    return out


def lower_bound_plain(queries: torch.Tensor, keys: torch.Tensor
                      ) -> torch.Tensor:
    """[Q] int64 index of the first key >= each query: ceil(log2(N+1))
    lockstep halvings of [lo, hi), lanes idle once lo == hi."""
    n = keys.shape[0]
    lo = torch.zeros_like(queries)
    hi = torch.full_like(queries, n)
    for _ in range(n.bit_length()):
        act = lo < hi
        mid = (lo + hi) // 2
        less = keys[mid.clamp(max=n - 1)] < queries
        lo = torch.where(act & less, mid + 1, lo)
        hi = torch.where(act & ~less, mid, hi)
    return lo


def scan_window_plain(queries: torch.Tensor, counts: torch.Tensor,
                      keys: torch.Tensor, vals: torch.Tensor, *,
                      max_count: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """queries: [Q] int64 start keys; counts: [Q] int32 window widths;
    keys, vals: [N] int64, keys ascending (signed).  Returns (valid
    [Q, C] bool, keys, vals [Q, C] int64) with C = ``max_count``: lane
    ``j`` of row ``i`` holds entry ``lb(i) + j`` when ``j < counts[i]``
    and that entry exists, else (False, 0, 0)."""
    n_q, n = queries.shape[0], keys.shape[0]
    dev = queries.device
    off = torch.arange(max_count, dtype=torch.int64, device=dev)
    if n == 0:
        valid = torch.zeros((n_q, max_count), dtype=torch.bool, device=dev)
        zero = torch.zeros((n_q, max_count), dtype=torch.int64, device=dev)
        return valid, zero, zero.clone()
    pos = lower_bound_plain(queries, keys).unsqueeze(1) + off
    valid = (off < counts.to(torch.int64).unsqueeze(1)) & (pos < n)
    safe = pos.clamp(max=n - 1)
    okeys = torch.where(valid, keys[safe], 0)
    ovals = torch.where(valid, vals[safe], 0)
    return valid, okeys, ovals


__all__ = ["lookup_ref", "lower_bound_plain", "scan_ref",
           "scan_window_plain"]
