"""Plain PyTorch version of the paged decode-attention kernel.

``paged_attention_plain`` computes what ``csrc/paged_attention.cu``
computes: for each sequence b and query head h, attention of q[b, h]
over the keys j < seq_lens[b] (at most MAXP * PS), and with a
``window`` only the last ``window`` of them (j >= seq_lens[b] -
window, the JAX package's ``kpos > pos - window`` at seq_len = pos + 1),
key j read from slot j % PS of page max(block_table[b, j // PS], 0), kv
head h // (H // Hk).
fp32 throughout, output in q's dtype, as in the JAX package's Pallas
kernel (``kernels/paged_attention/kernel.py``); a sequence of length 0
gives zeros, where the JAX package's ``paged_attention_ref`` gives NaN.
With ``return_lse`` it also returns each (sequence, query head)'s
log-sum-exp of its live scores (-inf where none is live), by which
attention computed over slot shards merges (``models/attention.py``).
A length past MAXP * PS reads the table's keys, its window still
starting at seq_lens[b] - window; a length of 0 or less reads none.
int8 pages (the ``kv_int8`` cache) are read as int8 * ``kv_scale``, the
JAX package's dequantization ``k.astype(bf16) * (1 / KV_QSCALE)``: at a
power-of-two scale the products are exact in bf16 and fp32 alike.

``merge_partials`` is the plain form of the kernel's last step: the
kernel cuts the keys into splits, each of which leaves its running max,
sum and unnormalised output, and merges them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def paged_attention_plain(q: torch.Tensor, pages_k: torch.Tensor,
                          pages_v: torch.Tensor, block_table: torch.Tensor,
                          seq_lens: torch.Tensor,
                          window: Optional[int] = None, *,
                          kv_scale: Optional[float] = None,
                          return_lse: bool = False):
    """q: [B, H, dh]; pages_k, pages_v: [NP, PS, Hk, dh] with H % Hk == 0,
    in q's dtype, or int8 with ``kv_scale`` (each element read as its
    value times ``kv_scale``); block_table: [B, MAXP] int32 (physical
    page per logical page, -1 unused); seq_lens: [B] int32; ``window``:
    None, or the live keys' count from the end (at least 1).  Returns
    [B, H, dh] in q's dtype, and with ``return_lse`` also the log-sum-exp
    [B, H] fp32 of the live scores s = q.k / sqrt(dh).  The query heads
    of a kv head are taken as a group, so no copy of the keys is made per
    query head."""
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive width, got {window}")
    if (pages_k.dtype == torch.int8) != (kv_scale is not None):
        raise ValueError("int8 pages take a kv_scale, other pages none")
    B, H, dh = q.shape
    _, PS, Hk, _ = pages_k.shape
    MAXP = block_table.shape[1]
    safe = block_table.long().clamp_min(0)
    k = pages_k[safe].reshape(B, MAXP * PS, Hk, dh).float()
    v = pages_v[safe].reshape(B, MAXP * PS, Hk, dh).float()
    if kv_scale is not None:
        k, v = k * kv_scale, v * kv_scale
    qg = q.float().reshape(B, Hk, H // Hk, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * (1.0 / math.sqrt(dh))
    pos = torch.arange(MAXP * PS, device=q.device)[None, :]
    valid = pos < seq_lens.long()[:, None]
    if window is not None:
        valid &= pos >= seq_lens.long()[:, None] - window
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    l = p.sum(dim=-1)
    out = (out / l[..., None].clamp_min(1e-30)).reshape(B, H, dh).to(q.dtype)
    if not return_lse:
        return out
    return out, (m[..., 0] + torch.log(l)).reshape(B, H)  # log 0 = -inf


def merge_partials(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """Merge per-split softmax partials over the split axis: m, l [...,
    n_splits] (each split's max score, -1e30 for a split with no live
    key, and its sum of exp(s - m)), acc [..., n_splits, dh] (its sum of
    exp(s - m) v).  Returns sum_s e^(m_s - M) acc_s / max(sum_s
    e^(m_s - M) l_s, 1e-30) with M the largest m_s, in fp32: zeros when
    every split is empty."""
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    num = (w[..., None] * acc).sum(dim=-2)
    return num / (w * l).sum(dim=-1, keepdim=True).clamp_min(1e-30)


__all__ = ["merge_partials", "paged_attention_plain"]
