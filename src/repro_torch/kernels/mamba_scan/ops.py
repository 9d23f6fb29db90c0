"""Public SSD op over the SSD kernels.

``ssd_heads`` is the port's form of the JAX package's
``kernels/mamba_scan/ops.py`` ``ssd_heads``: the same layout at its
surface (xh [B, T, H, dh], dt [B, T, H], B_ and C_ [B, T, N] shared
across heads, A [H]).  The JAX wrapper folds batch and heads into rows
and copies B_ and C_ into every head before one kernel call, and
returns only the output; the port's kernel reads B_ and C_ once per
batch row for every head and carries the state, so ``ssd_heads``
returns (output, final state) and takes a state in.  The Pallas
``chunk`` has no counterpart: the CUDA kernel's chunk is fixed and it
masks the ragged last chunk itself.

``ssd_heads`` is a ``torch.autograd.Function``: its forward is ``ssd``
(its inputs saved, and on the card the states entering each chunk that
its bf16 prefill computed), its backward ``ssd_bwd`` on the same inputs
and those states, so a training step differentiates through the kernels
(the JAX package differentiates its jnp chunked form with XLA).  The
final state's gradient arrives as zeros, or as None when autograd has
none, and the backward takes both.  On the CPU both run their plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import ssd, ssd_bwd


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xh, dt, B_, C_, A, state):
        y, final, saved = ssd(xh, dt, B_, C_, A, state, keep_states=True)
        # the chunk states the bf16 prefill computed, for the backward
        ctx.save_for_backward(xh, dt, B_, C_, A, state, saved)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        xh, dt, B_, C_, A, state, saved = ctx.saved_tensors
        # autograd may hand the gradients over strided
        return ssd_bwd(xh, dt, B_, C_, A, dy.contiguous(), state,
                       dfinal.contiguous() if dfinal is not None else None,
                       saved=saved)


def ssd_heads(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
              C_: torch.Tensor, A: torch.Tensor,
              state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh: [B, T, H, dh]; dt: [B, T, H]; B_, C_: [B, T, N]; A: [H];
    state: [B, H, dh, N] or None.  Returns (y [B, T, H, dh],
    state [B, H, dh, N]), differentiable in every input."""
    return _SSD.apply(xh, dt, B_, C_, A, state)


__all__ = ["ssd_heads"]
