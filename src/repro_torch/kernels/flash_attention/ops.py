"""Public attention op over the flash-attention kernels.

``mha`` is the port's form of the JAX package's
``kernels/flash_attention/ops.py`` ``mha``: the same [B, T, H, dh] /
[B, S, Hk, dh] layout at its surface.  The JAX wrapper repeats the kv
heads and folds batch and heads before its kernel; the port's kernel
takes the layout as it is and indexes kv head h // (H // Hk), so ``mha``
makes no copy.  The Pallas block sizes (``q_block``, ``kv_block``) have
no counterpart: the CUDA kernel's tiles are fixed and it masks ragged
edges itself.

``mha`` is a ``torch.autograd.Function``: its forward is
``flash_attention`` (q, k, v, the output and its log-sum-exp saved),
its backward ``flash_attention_bwd`` on the same tensors, so a training
step differentiates through the kernels (the JAX package
differentiates its jnp attention with XLA).  The forward asks for the
log-sum-exp only when a gradient can follow (grad enabled and some
input requiring it), so inference (``LM.prefill`` under ``no_grad``)
runs the forward as it always did.  On the CPU both run their plain
versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention, flash_attention_bwd


class _MHA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, need_lse):
        if need_lse:
            out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = flash_attention(q, k, v, causal=causal, window=window)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand the gradient over strided
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse=lse, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: [B, T, H, dh]; k, v: [B, S, Hk, dh] (GQA: H % Hk == 0).
    Returns [B, T, H, dh], differentiable in q, k and v."""
    need_lse = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return _MHA.apply(q, k, v, causal, window, need_lse)


__all__ = ["mha"]
