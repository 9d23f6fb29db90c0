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
against it.  ``ways_lower_bound`` is a numpy model of the CUDA kernel's
33-way warp search, which counts each query's dependent rounds.
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


#: sub-ranges a round of csrc/scan_window.cu's search splits into
#: (kWays): 32 pivots, one a lane of a warp
WAYS = 33


def ways_lower_bound(keys: np.ndarray, queries: np.ndarray,
                     base=None, length=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The CUDA kernel's search on the host: (lb [Q], rounds [Q]).

    Row ``i`` searches ``keys[base[i]:base[i] + length[i]]`` (the whole
    run without ``base``).  While its range holds more than 32 entries,
    a round reads the pivots ``lo + (j + 1) * len // 33``, j < 32, and
    the count c of pivots below the query keeps ``[p_{c-1} + 1, p_c)``;
    a last round reads the <= 32 entries left and adds the count below
    the query.  An empty range makes no round."""
    keys = np.asarray(keys, np.int64)
    q = np.asarray(queries, np.int64)
    lo = (np.zeros(q.size, np.int64) if base is None
          else np.asarray(base, np.int64).copy())
    hi = (np.full(q.size, keys.size, np.int64) if base is None
          else lo + np.asarray(length, np.int64))
    rounds = np.zeros(q.size, np.int64)
    lane = np.arange(WAYS - 1, dtype=np.int64)
    while True:
        act = np.nonzero(hi - lo > WAYS - 1)[0]
        if not act.size:
            break
        a_lo, a_hi = lo[act], hi[act]
        piv = a_lo[:, None] + (lane + 1) * (a_hi - a_lo)[:, None] // WAYS
        c = (keys[piv] < q[act, None]).sum(axis=1)
        last = WAYS - 2
        lo[act] = np.where(c > 0, piv[np.arange(act.size),
                                      np.maximum(c - 1, 0)] + 1, a_lo)
        hi[act] = np.where(c <= last, piv[np.arange(act.size),
                                          np.minimum(c, last)], a_hi)
        rounds[act] += 1
    act = np.nonzero(hi > lo)[0]
    if act.size:
        idx = lo[act, None] + lane
        live = lane < (hi - lo)[act, None]
        less = live & (keys[np.where(live, idx, lo[act, None])]
                       < q[act, None])
        lo[act] += less.sum(axis=1)
        rounds[act] += 1
    return lo, rounds


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


def scan_window_rows_plain(queries: torch.Tensor, counts: torch.Tensor,
                           base: torch.Tensor, length: torch.Tensor,
                           keys: torch.Tensor, vals: torch.Tensor, *,
                           max_count: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """``scan_window_plain`` per run: row ``i`` searches
    ``keys[base[i]:base[i] + length[i]]``, and its window stops at that
    run's end.  Rows that share a run go through one call."""
    n_q = queries.shape[0]
    dev = queries.device
    valid = torch.zeros((n_q, max_count), dtype=torch.bool, device=dev)
    okeys = torch.zeros((n_q, max_count), dtype=torch.int64, device=dev)
    ovals = torch.zeros((n_q, max_count), dtype=torch.int64, device=dev)
    if n_q == 0:
        return valid, okeys, ovals
    runs = torch.unique(torch.stack([base, length], dim=1), dim=0)
    for b, n in runs.tolist():
        rows = torch.nonzero((base == b) & (length == n)).squeeze(1)
        got = scan_window_plain(queries[rows], counts[rows],
                                keys[b:b + n], vals[b:b + n],
                                max_count=max_count)
        for out, part in zip((valid, okeys, ovals), got):
            out[rows] = part
    return valid, okeys, ovals


__all__ = ["WAYS", "lookup_ref", "lower_bound_plain", "scan_ref",
           "scan_window_plain", "scan_window_rows_plain", "ways_lower_bound"]
