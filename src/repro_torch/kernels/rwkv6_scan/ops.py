"""Public WKV op over the WKV6 kernels.

``wkv6_heads`` is the port's form of the JAX package's
``kernels/rwkv6_scan/ops.py`` ``wkv6_heads``: the same [B, T, H, dh]
layout at its surface.  The JAX wrapper loops over heads in Python,
one kernel call each, and returns only the output; the port's kernel
covers every head in one launch and carries the state, so
``wkv6_heads`` returns (output, final state) and takes a state in.  The
Pallas ``chunk`` has no counterpart: the CUDA kernel's chunk is fixed
and it masks the ragged last chunk itself.

``wkv6_heads`` is a ``torch.autograd.Function``: its forward is
``wkv6`` (its inputs saved, and on the card the states entering each
chunk that its bf16 prefill computed: 33.5 MB a layer at RWKV6-7B's
training shape), its backward ``wkv6_bwd`` on the same inputs and those
states, so a training step differentiates through the kernels (the JAX
package differentiates its jnp chunked form with XLA).  The final
state's gradient arrives as zeros, or as None when autograd has none,
and the backward takes both.  On the CPU both run their plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import wkv6, wkv6_bwd


class _WKV6(torch.autograd.Function):

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state):
        out, final, saved = wkv6(r, k, v, logw, u, state, keep_states=True)
        # the chunk states the bf16 prefill computed, for the backward
        ctx.save_for_backward(r, k, v, logw, u, state, saved, final)
        return out, final

    @staticmethod
    def backward(ctx, dout, dfinal):
        r, k, v, logw, u, state, saved, final = ctx.saved_tensors
        # autograd may hand the gradients over strided
        dr, dk, dv, dlogw, du, dstate = wkv6_bwd(
            r, k, v, logw, u, dout.contiguous(), state,
            dfinal.contiguous() if dfinal is not None else None,
            saved=saved, final=final)
        return dr, dk, dv, dlogw, du, dstate


def wkv6_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: [B, T, H, dh]; u: [H, dh]; state: [B, H, dh, dh]
    or None.  Returns (o [B, T, H, dh], state [B, H, dh, dh]),
    differentiable in every input."""
    return _WKV6.apply(r, k, v, logw, u, state)


__all__ = ["wkv6_heads"]
