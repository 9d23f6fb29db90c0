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
lane per key, collisions possible): a 32-bit hash and a fixed chain
depth, walked by the ``tag_probe`` kernel.  ``tag_hash`` and
``tag_windows`` (the JAX package's gather, which the window form
``clht_probe`` takes) live with the plain versions in ``ref``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...obs import RECORDER as _OBS
from ..partition.ref import mix64_ref as mix64
from ..probe import account, pack_lines, probe_chain
from ..readback import to_host
from .kernel import tag_probe
from .ref import CHAIN_DEPTH, SLOTS, WINDOW, tag_hash, tag_windows

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


def tag_lookup(queries: torch.Tensor, keys: torch.Tensor,
               vals: torch.Tensor, nxt: torch.Tensor, *, n_buckets: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 32-bit-tag data plane: queries [Q] int32 hashed with the
    32-bit mix and their chains walked, in one ``tag_probe`` launch (no
    windows are built).  Returns (found [Q] bool, values [Q] int32).
    Query 0 hits a zero lane and comes back found with value 0, as in the
    JAX package.  Tags collide: a hit is to be verified against the
    authoritative index."""
    return tag_probe(queries, keys, vals, nxt, n_buckets=n_buckets)


__all__ = ["CHAIN_DEPTH", "SLOTS", "WINDOW", "mix64", "snapshot_lookup",
           "tag_hash", "tag_lookup", "tag_windows"]
