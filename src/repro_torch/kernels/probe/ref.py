"""Plain PyTorch version of the chained probe kernel.

``probe_chain_plain`` computes what ``csrc/probe.cu`` computes, with
torch indexing and no custom kernel: it gathers each query's probe
window (``depth`` hops of its bucket chain, 3 slots a hop, zeros past
the chain's end) and then runs the JAX package's
``probe64_fp_ref`` / ``probe64_ref`` arithmetic on it (fingerprint
pre-pass, full 64-bit compare on survivors, first hit in hop-major,
slot-minor order wins, per-query fingerprint-match and false-positive
counts over all ``depth * 3`` lanes).  The CPU tests hold it against
the JAX package; ``chip_smoke.py`` holds the CUDA kernel against it.

``mix64`` and ``fp64`` here are the torch forms of splitmix64 and the
fingerprint: int64 tensors carry the uint64 bit patterns, multiplies
wrap modulo 2^64, and each right shift is masked to make it logical.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SLOTS = 3

_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)  # the uint64 constants as int64
_MUL1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MUL2 = 0x94D049BB133111EB - (1 << 64)


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix64(keys: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 tensors (uint64 bit patterns)."""
    z = keys + _GOLDEN
    z = (z ^ _shr(z, 30)) * _MUL1
    z = (z ^ _shr(z, 27)) * _MUL2
    return z ^ _shr(z, 31)


def fp64(keys: torch.Tensor) -> torch.Tensor:
    """1-byte fingerprints as uint8, bit-identical to
    ``fingerprint.fp64``: 0 for key 0, else the splitmix64 top byte
    with 0 remapped to 1."""
    fp = _shr(mix64(keys), 56)
    fp = fp + (fp == 0)
    return torch.where(keys == 0, 0, fp).to(torch.uint8)


def probe_chain_plain(queries: torch.Tensor, bucket: torch.Tensor,
                      keys: torch.Tensor, vals: torch.Tensor,
                      fps: torch.Tensor, nxt: torch.Tensor, depth: int, *,
                      use_fp: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """queries, bucket: [Q] int64; keys, vals: [R, 3] int64; fps:
    [R, 3] uint8; nxt: [R] int64 (-1 ends a chain).  Returns (found [Q]
    bool, values [Q] int64, nfp [Q] int32, nfalse [Q] int32); the two
    counts are None when ``use_fp`` is off."""
    n_q = queries.shape[0]
    rows = []
    cur = bucket
    for _ in range(depth):
        rows.append(cur)
        cur = torch.where(cur >= 0, nxt[cur.clamp(min=0)], -1)
    hops = torch.stack(rows, dim=1)  # [Q, depth]
    live = (hops >= 0).unsqueeze(2)
    safe = hops.clamp(min=0)

    def window(arr: torch.Tensor) -> torch.Tensor:
        zero = torch.zeros((), dtype=arr.dtype, device=arr.device)
        return torch.where(live, arr[safe], zero).reshape(n_q, depth * SLOTS)

    q = queries.unsqueeze(1)
    hit = window(keys) == q
    fphit = None
    if use_fp:
        fphit = window(fps) == fp64(queries).unsqueeze(1)
        hit = fphit & hit
    found = hit.any(dim=1)
    first = hit.to(torch.int32).argmax(dim=1, keepdim=True)  # first hit wins
    values = torch.where(found, window(vals).gather(1, first).squeeze(1), 0)
    if not use_fp:
        return found, values, None, None
    nfp = fphit.sum(dim=1, dtype=torch.int32)
    nfalse = (fphit & ~hit).sum(dim=1, dtype=torch.int32)
    return found, values, nfp, nfalse


__all__ = ["fp64", "mix64", "probe_chain_plain"]
