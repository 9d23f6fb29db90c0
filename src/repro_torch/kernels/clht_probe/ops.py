"""Batched P-CLHT lookup over the arrays ``PCLHT.export_arrays`` produces.

This module contributes what is CLHT-specific: the bucket hash
(``mix64``, the splitmix64 finalizer of ``kernels/partition``,
bit-for-bit ``core.clht._mix``) so a batched query probes exactly the
bucket the scalar reader would, and the per-epoch upload of the
snapshot to the index's device.  The probe itself is
``kernels.probe.probe_chain``: the CUDA kernel on the card, its plain
PyTorch version on the CPU.  Results are bit-identical to scalar
``lookup``, values above 32 bits included.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...obs import RECORDER as _OBS
from ..partition.ref import mix64_ref as mix64
from ..probe import account, probe_chain

SLOTS = 3

_U64 = np.uint64


def _prepare(snap, device: torch.device):
    """Per epoch: ship the table to ``device`` (keys, vals [R, 3]
    int64, fps [R, 3] uint8, nxt [R] int64) and measure the longest
    overflow chain."""
    keys, vals, nxt, n, fps = snap.arrays
    nxt = np.asarray(nxt, np.int64)
    n_rows = nxt.shape[0]
    if not 0 < n <= n_rows or ((nxt < -1) | (nxt >= n_rows)).any():
        raise ValueError("snapshot chain pointers or bucket count out of "
                         "range")
    depth, cur = 1, nxt[nxt >= 0]
    while cur.size and depth < 64:  # longest chain in this epoch
        depth += 1
        hops = nxt[cur]
        cur = hops[hops >= 0]
    table = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (np.asarray(keys, np.int64),
                            np.asarray(vals, np.int64),
                            np.asarray(fps, np.uint8), nxt))
    return table, depth, int(n)


def snapshot_lookup(snap, queries: np.ndarray, *, device: torch.device,
                    fingerprints: bool = True, stats: Optional[dict] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched lookup against an ``IndexSnapshot`` of PCLHT arrays.

    Per epoch (memoized on the snapshot): the table on ``device`` and
    its longest chain.  Per batch: the 64-bit bucket hash on the host,
    then one ``probe_chain`` launch over ``depth`` hops — fingerprint
    pre-pass first when ``fingerprints`` is on, with filter counts
    folded into ``stats``.  Returns (found [Q] bool, values [Q] int64)
    as numpy arrays."""
    prepared = snap.cache.get("clht_probe")
    if prepared is None:
        prepared = snap.cache["clht_probe"] = _prepare(snap, device)
    table, depth, n = prepared
    q = np.asarray(queries, np.int64)
    n_q = q.shape[0]
    lanes = n_q * depth * SLOTS
    with _OBS.span("kernel.clht_probe", batch=n_q, padded=n_q,
                   pad_ratio=0.0, depth=depth,
                   fingerprints=fingerprints) as sp:
        bucket = (mix64(q) % _U64(n)).astype(np.int64)
        found, values, nfp, nfalse = probe_chain(
            torch.from_numpy(q).to(device),
            torch.from_numpy(bucket).to(device), *table, depth,
            use_fp=fingerprints)
        found = found.cpu().numpy()
        values = values.cpu().numpy()
        if fingerprints:
            cand, false = (int(c) for c in
                           torch.stack([nfp.sum(), nfalse.sum()]).tolist())
            account(stats, lanes=lanes, fp_candidates=cand,
                    fp_hits=cand - false, fp_false=false, fingerprints=True)
            if sp:
                sp.set(fp_candidates=cand, fp_false_positives=false)
        else:
            account(stats, lanes=lanes, fp_candidates=0, fp_hits=0,
                    fp_false=0, fingerprints=False)
    return found, values


__all__ = ["mix64", "snapshot_lookup"]
