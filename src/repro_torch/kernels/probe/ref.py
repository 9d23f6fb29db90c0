"""Plain PyTorch version of the chained probe kernel.

``probe_chain_plain`` computes what ``csrc/probe.cu`` computes, with
torch indexing and no custom kernel: it reads each query's probe window
from the line table (``layout.pack_lines``: ``depth`` hops of its chain,
3 slots a hop, zeros past the chain's end) and then runs the JAX
package's ``probe64_fp_ref`` / ``probe64_ref`` arithmetic on it
(fingerprint pre-pass, full 64-bit compare on survivors, first hit in
hop-major, slot-minor order wins, per-query fingerprint-match and
false-positive counts over all ``depth * 3`` lanes).  The CPU tests hold
it against the JAX package; ``chip_smoke.py`` holds the CUDA kernel
against it.

``mix64`` and ``fp64`` here are the torch forms of splitmix64 and the
fingerprint: int64 tensors carry the uint64 bit patterns, multiplies
wrap modulo 2^64, and each right shift is masked to make it logical.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .layout import COUNT_SHIFT

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


def chain_window(bucket: torch.Tensor, lines: torch.Tensor, depth: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's ``depth`` lines and which of them are live: the
    start line ``bucket``, then the chain's remaining rows, at most
    ``depth - 1``, from the consecutive lines its w6 names.  A start, or
    a rest, outside the table ends the chain (memory safety only:
    ``pack_lines`` never produces one).  Returns ([Q, depth, 8] int64,
    [Q, depth] bool)."""
    n_lines = lines.shape[0]
    live0 = (bucket >= 0) & (bucket < n_lines)
    first = lines[bucket.clamp(0, max(n_lines - 1, 0))]
    rest = (first[:, 7] >> COUNT_SHIFT).clamp(max=depth - 1)
    nxt = first[:, 6]
    rest = torch.where(live0 & (nxt >= 0) & (nxt + rest <= n_lines), rest, 0)
    hop = torch.arange(1, depth, device=bucket.device)
    live = torch.cat([live0[:, None], hop <= rest[:, None]], dim=1)
    idx = torch.where(live[:, 1:], nxt[:, None] + hop - 1, 0)
    return torch.cat([first[:, None], lines[idx]], dim=1), live


def probe_chain_plain(queries: torch.Tensor, bucket: torch.Tensor,
                      lines: torch.Tensor, depth: int, *, use_fp: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """queries, bucket: [Q] int64 (bucket = each query's start row);
    lines: [L, 8] int64 line table.  Returns (found [Q] bool, values [Q]
    int64, nfp [Q] int32, nfalse [Q] int32); the two counts are None
    when ``use_fp`` is off."""
    n_q = queries.shape[0]
    win, live = chain_window(bucket, lines, depth)
    live = live.unsqueeze(2)

    def window(words: torch.Tensor) -> torch.Tensor:
        return torch.where(live, words, 0).reshape(n_q, depth * SLOTS)

    q = queries.unsqueeze(1)
    hit = window(win[:, :, 0:3]) == q
    fphit = None
    if use_fp:
        shifts = torch.tensor([0, 8, 16], device=lines.device)
        fps = (win[:, :, 7:8] >> shifts) & 0xFF
        fphit = window(fps) == fp64(queries).to(torch.int64).unsqueeze(1)
        hit = fphit & hit
    found = hit.any(dim=1)
    first = hit.to(torch.int32).argmax(dim=1, keepdim=True)  # first hit wins
    values = torch.where(found,
                         window(win[:, :, 3:6]).gather(1, first).squeeze(1),
                         0)
    if not use_fp:
        return found, values, None, None
    nfp = fphit.sum(dim=1, dtype=torch.int32)
    nfalse = (fphit & ~hit).sum(dim=1, dtype=torch.int32)
    return found, values, nfp, nfalse


__all__ = ["chain_window", "fp64", "mix64", "probe_chain_plain"]
