"""Plain PyTorch version of the flash-attention kernel.

``attention_plain`` computes what ``csrc/flash_attention.cu`` computes,
in the kernel's layout: q [B, T, H, dh], k and v [B, S, Hk, dh], query
head h reading kv head h // (H // Hk).  q, k and v are upcast to fp32,
the softmax and the P.V product are fp32, and the output is in q's
dtype, as in the JAX package's Pallas kernel
(``kernels/flash_attention/kernel.py``).  Masking is that of its
``attention_ref``: causal with right-aligned queries (query i sits at
position i + S - T), and with a window w also key > position - w.  A
row that sees no key (T > S) is 0, where ``attention_ref`` gives NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B, T, H, dh]; k, v: [B, S, Hk, dh] with H % Hk == 0.
    Returns [B, T, H, dh] in q's dtype."""
    B, T, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    head = torch.arange(H, device=q.device) // (H // Hk)
    qf = q.float().transpose(1, 2)                  # [B, H, T, dh]
    kf = k.float()[:, :, head].transpose(1, 2)      # [B, H, S, dh]
    vf = v.float()[:, :, head].transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    if causal:
        q_pos = torch.arange(T, device=q.device)[:, None] + (S - T)
        k_pos = torch.arange(S, device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    out = torch.matmul(p, vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype).contiguous()


__all__ = ["attention_plain"]
