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
With ``return_lse`` it also returns each row's log-sum-exp of its
scaled scores, [B, H, T] in natural-log units (+inf for a row that sees
no key), what the CUDA forward writes for the backward kernel.

``attention_bwd_plain`` is the gradient the backward kernel
(``csrc/flash_attention_bwd.cu``) computes, written out as the kernel's
formulas in torch ops (not autograd of ``attention_plain``): P from the
scores, D = rowsum(dO * O) from the forward's output as given, dP =
dO . V^T, dS = P * (dP - D), dq = scale * dS . K, dk = scale * dS^T . Q
and dv = P^T . dO, the query heads of a kv head's group summed into it.
It rebuilds P from the scores and reads no log-sum-exp: the kernel's
LSE input is held to ``attention_plain``'s on the card, not trusted here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    return_lse: bool = False):
    """q: [B, T, H, dh]; k, v: [B, S, Hk, dh] with H % Hk == 0.
    Returns [B, T, H, dh] in q's dtype, and with ``return_lse`` also the
    rows' log-sum-exp [B, H, T] (fp32; float64 for float64 inputs)."""
    qf, kf, vf = _heads(q, k, v)
    p, l, m = _weights(qf, kf, causal, window)
    out = torch.matmul(p, vf) / l
    out = out.transpose(1, 2).to(q.dtype).contiguous()
    if not return_lse:
        return out
    # a live row's largest weight is exp(0) = 1, so l >= 1; a row that
    # sees no key has l clamped to 1e-30
    lse = torch.where(l >= 1, m + torch.log(l), float("inf"))
    return out, lse.squeeze(-1).contiguous()


def _acc(t: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute in: fp32, or float64."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _heads(q, k, v):
    """q as [B, H, T, dh] and k, v as [B, H, S, dh] (each query head's kv
    head), upcast."""
    H, Hk = q.shape[2], k.shape[2]
    head = torch.arange(H, device=q.device) // (H // Hk)
    acc = _acc(q)
    return (q.to(acc).transpose(1, 2), k.to(acc)[:, :, head].transpose(1, 2),
            v.to(acc)[:, :, head].transpose(1, 2))


def _weights(qf, kf, causal: bool, window: Optional[int]):
    """exp(s - rowmax) [B, H, T, S], its row sums clamped to 1e-30 and
    the row max clamped to -1e30 [B, H, T, 1]: the softmax weights are
    the quotient of the first two, and a row that sees no key has
    weights 0."""
    T, S, dh = qf.shape[2], kf.shape[2], qf.shape[3]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    if causal:
        q_pos = torch.arange(T, device=qf.device)[:, None] + (S - T)
        k_pos = torch.arange(S, device=qf.device)[None, :]
        mask = k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    return p, p.sum(dim=-1, keepdim=True).clamp_min(1e-30), m


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None):
    """q, out, dout: [B, T, H, dh]; k, v: [B, S, Hk, dh].  Returns (dq,
    dk, dv) in q's dtype, computed in fp32 (float64 for float64 inputs)
    from ``out`` as given."""
    B, T, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    qf, kf, vf = _heads(q, k, v)
    acc = qf.dtype
    of = out.to(acc).transpose(1, 2)
    dof = dout.to(acc).transpose(1, 2)
    p, l, _ = _weights(qf, kf, causal, window)
    p = p / l
    d = (dof * of).sum(dim=-1, keepdim=True)        # [B, H, T, 1]
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - d)
    scale = 1.0 / math.sqrt(dh)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale   # [B, H, S, dh]
    dv = torch.matmul(p.transpose(-1, -2), dof)

    def fold(g):  # the group's query heads summed into their kv head
        return g.reshape(B, Hk, H // Hk, S, dh).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype).contiguous(),
            fold(dk).to(q.dtype).contiguous(),
            fold(dv).to(q.dtype).contiguous())


__all__ = ["attention_bwd_plain", "attention_plain"]
