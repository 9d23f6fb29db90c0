"""Plain versions of the 32-bit tag probe.

``probe_plain`` is the port of the JAX package's
``kernels/clht_probe/ref.py`` ``probe_ref`` in PyTorch: what
``csrc/clht_probe.cu``'s window form (``clht_probe``) computes over
pre-gathered windows.  ``tag_probe_plain`` is the plain version of its
whole lookup (``tag_probe``): the 32-bit hash (``tag_hash``), each
query's window gathered from the table (``tag_windows``, the JAX
package's ``tag_lookup`` gather), then ``probe_plain``.  The tests and
the CPU path run them; on the card the kernels run instead.

``tag_lookup_np`` reads ``ops.tag_lookup`` in numpy, a query at a time:
the 32-bit hash, the chain walk and the first hit in the window, with
no torch in between.  ``chip_smoke.py`` and the card tests hold the
kernel's path to it, over tables that ``tag_table_np`` lays out.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

SLOTS = 3
CHAIN_DEPTH = 4  # the bucket and up to 3 chained buckets
WINDOW = 128     # lanes of a window; those past CHAIN_DEPTH * SLOTS are 0
HASH_MUL = 0x9E3779B9


def probe_plain(queries: torch.Tensor, bucket_keys: torch.Tensor,
                bucket_vals: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries: [Q]; bucket_keys, bucket_vals: [Q, W] (each query's
    window).  Returns (found [Q] bool, the first hit's value [Q], 0
    where nothing hits)."""
    hit = bucket_keys == queries[:, None]
    found = hit.any(dim=1)
    idx = hit.to(torch.int8).argmax(dim=1)  # the first True
    vals = torch.gather(bucket_vals, 1, idx[:, None])[:, 0]
    return found, torch.where(found, vals, torch.zeros_like(vals))


_M32 = 0xFFFFFFFF


def tag_hash(queries: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Bucket of each int32 query, the JAX package's 32-bit hash:
    z = uint32(q) * 0x9E3779B9 mod 2^32, z ^= z >> 16, z % n_buckets, all
    unsigned.  Computed in int64: the product is formed from the query's
    16-bit halves so no intermediate passes 2^49."""
    q = queries.to(torch.int64) & _M32
    z = ((q & 0xFFFF) * HASH_MUL
         + ((((q >> 16) * HASH_MUL) & 0xFFFF) << 16)) & _M32
    z = z ^ (z >> 16)
    return z % n_buckets


def tag_windows(queries: torch.Tensor, keys: torch.Tensor,
                vals: torch.Tensor, nxt: torch.Tensor, *, n_buckets: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's window: its bucket and up to ``CHAIN_DEPTH - 1``
    chained rows (keys, vals [R, SLOTS] int32; nxt [R] int32 row index,
    -1 none), ``WINDOW`` lanes of keys and of values [Q, WINDOW] int32.
    Dead rows and the lanes past the chain are key 0, value 0."""
    row = tag_hash(queries, n_buckets)
    rows = [row]
    for _ in range(CHAIN_DEPTH - 1):
        row = torch.where(row >= 0, nxt[row.clamp_min(0)].to(torch.int64),
                          -1)
        rows.append(row)
    rows = torch.stack(rows, dim=1)                     # [Q, CHAIN_DEPTH]
    live = (rows >= 0)[:, :, None]
    n_q = queries.shape[0]
    windows = []
    for table in (keys, vals):
        w = torch.zeros(n_q, WINDOW, dtype=torch.int32, device=keys.device)
        lanes = torch.where(live, table[rows.clamp_min(0)], 0)
        w[:, :CHAIN_DEPTH * SLOTS] = lanes.reshape(n_q, -1)
        windows.append(w)
    return windows[0], windows[1]


def tag_probe_plain(queries: torch.Tensor, keys: torch.Tensor,
                    vals: torch.Tensor, nxt: torch.Tensor, *, n_buckets: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tag lookup in plain PyTorch: ``tag_windows``, then
    ``probe_plain``.  Returns (found [Q] bool, values [Q] int32)."""
    return probe_plain(queries, *tag_windows(queries, keys, vals, nxt,
                                             n_buckets=n_buckets))


def tag_hash_np(queries: np.ndarray, n_buckets: int) -> np.ndarray:
    """Bucket of each int32 query: z = uint32(q) * 0x9E3779B9 mod 2^32,
    z ^= z >> 16, z % n_buckets, all unsigned 32-bit."""
    z = queries.astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    z = (z * np.uint64(HASH_MUL)) & np.uint64(0xFFFFFFFF)
    z = z ^ (z >> np.uint64(16))
    return (z % np.uint64(n_buckets)).astype(np.int64)


def tag_table_np(tags: np.ndarray, values: np.ndarray, n_buckets: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The chained table ``tag_lookup`` reads, holding ``tags[i] ->
    values[i]`` (int32) in insertion order: row b is bucket b, each
    row holds SLOTS lanes (empty lanes key 0, value 0), and a bucket's
    k-th extra row of SLOTS keys is chained through ``nxt`` to a row
    past ``n_buckets``.  Returns (keys [R, SLOTS], vals [R, SLOTS],
    nxt [R]) int32.  A tag inserted twice keeps both lanes; the first
    is the one a lookup finds."""
    tags = np.asarray(tags, np.int32)
    bucket = tag_hash_np(tags, n_buckets)
    order = np.argsort(bucket, kind="stable")
    b = bucket[order]
    rank = np.arange(b.shape[0]) - np.searchsorted(b, b, side="left")
    hop, slot = rank // SLOTS, rank % SLOTS
    span = int(hop.max()) + 1 if hop.size else 1
    code = b * span + hop
    extra = np.unique(code[hop >= 1])  # (bucket, hop) rows, in order
    row = np.where(hop == 0, b, n_buckets + np.searchsorted(extra, code))
    n_rows = n_buckets + extra.shape[0]
    keys = np.zeros((n_rows, SLOTS), np.int32)
    vals = np.zeros((n_rows, SLOTS), np.int32)
    keys[row, slot] = tags[order]
    vals[row, slot] = np.asarray(values, np.int32)[order]
    nxt = np.full(n_rows, -1, np.int32)
    eb, eh = extra // span, extra % span
    prev = np.where(eh == 1, eb,
                    n_buckets + np.searchsorted(extra, extra - 1))
    nxt[prev] = n_buckets + np.arange(extra.shape[0])
    return keys, vals, nxt


def tag_lookup_np(queries: np.ndarray, keys: np.ndarray, vals: np.ndarray,
                  nxt: np.ndarray, n_buckets: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``tag_lookup`` query by query: walk CHAIN_DEPTH rows from the
    query's bucket (a dead row, and every lane past the chain, is key 0
    and value 0), return the first lane whose key equals the query."""
    queries = np.asarray(queries, np.int32)
    found = np.zeros(queries.shape[0], bool)
    values = np.zeros(queries.shape[0], np.int32)
    for i, (q, row) in enumerate(zip(queries.tolist(),
                                     tag_hash_np(queries, n_buckets))):
        lanes = []
        for _ in range(CHAIN_DEPTH):
            if row >= 0:
                lanes += list(zip(keys[row].tolist(), vals[row].tolist()))
                row = int(nxt[row])
            else:
                lanes += [(0, 0)] * SLOTS
        lanes += [(0, 0)] * (WINDOW - len(lanes))
        for k, v in lanes:
            if k == q:
                found[i], values[i] = True, v
                break
    return found, values


__all__ = ["CHAIN_DEPTH", "HASH_MUL", "SLOTS", "WINDOW", "probe_plain",
           "tag_hash", "tag_hash_np", "tag_lookup_np", "tag_probe_plain",
           "tag_table_np", "tag_windows"]
