"""Batched P-CLHT lookup over the arrays ``PCLHT.export_arrays`` produces.

This module contributes what is CLHT-specific: the bucket hash
(``mix64``, the splitmix64 finalizer of ``kernels/partition``,
bit-for-bit ``core.clht._mix``) so a batched query probes exactly the
bucket the scalar reader would, and the per-epoch upload of the
snapshot to the index's device as the probe's line table.  The probe
itself is ``kernels.probe.probe_chain``: the CUDA kernel on the card,
its plain PyTorch version on the CPU.  Results are bit-identical to scalar
``lookup``, values above 32 bits included.

``tag_lookup`` keeps the JAX package's 32-bit-tag data plane (one int32
lane per key, collisions possible): a 32-bit hash, a fixed chain depth,
windows gathered here and compared by the ``clht_probe`` kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...obs import RECORDER as _OBS
from ..partition.ref import mix64_ref as mix64
from ..probe import account, pack_lines, probe_chain
from ..readback import to_host
from .kernel import clht_probe
from .ref import CHAIN_DEPTH, HASH_MUL, SLOTS, WINDOW

_U64 = np.uint64


def _prepare(snap, device: torch.device):
    """Per epoch: the snapshot's line table on ``device``
    (``probe.pack_lines``), the depth a probe walks (its longest chain,
    at most 64) and the bucket count."""
    keys, vals, nxt, n, fps = snap.arrays
    n_rows = np.shape(nxt)[0]
    if not 0 < n <= n_rows:
        raise ValueError("snapshot bucket count out of range")
    lines, depth = pack_lines(keys, vals, fps, nxt, device=device)
    return lines, depth, int(n)


def snapshot_lookup(snap, queries: np.ndarray, *, device: torch.device,
                    fingerprints: bool = True, stats: Optional[dict] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched lookup against an ``IndexSnapshot`` of PCLHT arrays.

    Per epoch (memoized on the snapshot): the line table on ``device``
    and its longest chain.  Per batch: the 64-bit bucket hash on the
    host, then one ``probe_chain`` launch over ``depth`` hops —
    fingerprint pre-pass first when ``fingerprints`` is on, with filter
    counts folded into ``stats`` — and one copy of the results and the
    counts back to the host (``readback.to_host``).  Returns (found [Q]
    bool, values [Q] int64) as numpy arrays."""
    prepared = snap.cache.get("clht_probe")
    if prepared is None:
        prepared = snap.cache["clht_probe"] = _prepare(snap, device)
    lines, depth, n = prepared
    q = np.asarray(queries, np.int64)
    n_q = q.shape[0]
    lanes = n_q * depth * SLOTS
    with _OBS.span("kernel.clht_probe", batch=n_q, padded=n_q,
                   pad_ratio=0.0, depth=depth,
                   fingerprints=fingerprints) as sp:
        bucket = (mix64(q) % _U64(n)).astype(np.int64)
        found, values, nfp, nfalse = probe_chain(
            torch.from_numpy(q).to(device),
            torch.from_numpy(bucket).to(device), lines, depth,
            use_fp=fingerprints)
        if fingerprints:
            values, nfp, nfalse, found = to_host(values, nfp, nfalse, found)
            cand, false = int(nfp.sum()), int(nfalse.sum())
            account(stats, lanes=lanes, fp_candidates=cand,
                    fp_hits=cand - false, fp_false=false, fingerprints=True)
            if sp:
                sp.set(fp_candidates=cand, fp_false_positives=false)
        else:
            values, found = to_host(values, found)
            account(stats, lanes=lanes, fp_candidates=0, fp_hits=0,
                    fp_false=0, fingerprints=False)
    return found, values


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


def tag_lookup(queries: torch.Tensor, keys: torch.Tensor,
               vals: torch.Tensor, nxt: torch.Tensor, *, n_buckets: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 32-bit-tag data plane: queries [Q] int32 hashed with the
    32-bit mix, their windows gathered (``tag_windows``), then one
    ``clht_probe`` launch.  Returns (found [Q] bool, values [Q] int32).
    Query 0 hits a zero lane and comes back found with value 0, as in the
    JAX package.  Tags collide: a hit is to be verified against the
    authoritative index."""
    return clht_probe(queries, *tag_windows(queries, keys, vals, nxt,
                                            n_buckets=n_buckets))


__all__ = ["CHAIN_DEPTH", "SLOTS", "WINDOW", "mix64", "snapshot_lookup",
           "tag_hash", "tag_lookup", "tag_windows"]
