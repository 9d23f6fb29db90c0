"""Plain PyTorch version of the WKV6 kernel.

``wkv6_plain`` is the step-by-step recurrence of the JAX package's
``kernels/rwkv6_scan/ref.py`` ``wkv6_ref`` in fp32, in the model's
layout ([B, T, H, dh], every head at once) and with the state carried
in and out, as ``csrc/wkv6.cu`` computes it:

    o_t = r_t . (S + u (x) k_t^T v_t);   S <- diag(exp(w_t)) S + k_t^T v_t

The tests and the CPU path run it; on the card the kernel runs instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: [B, T, H, dh]; logw: [B, T, H, dh] log decay (<= 0);
    u: [H, dh] bonus; state: [B, H, dh_k, dh_v] fp32, zeros when None.
    Returns (o [B, T, H, dh] in r's dtype, final state fp32)."""
    B, T, H, dh = r.shape
    S = (torch.zeros(B, H, dh, dh, dtype=torch.float32, device=r.device)
         if state is None else state.float().clone())
    rf, kf, vf = r.float(), k.float(), v.float()
    w = logw.float().exp()
    uf = u.float()[None, :, :, None]
    out = torch.empty(B, T, H, dh, dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # [B, H, dk, dv]
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv)
        S = w[:, t, :, :, None] * S + kv
    return out.to(r.dtype), S


__all__ = ["wkv6_plain"]
