"""Public SSD op over the SSD kernel.

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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import ssd


def ssd_heads(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
              C_: torch.Tensor, A: torch.Tensor,
              state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh: [B, T, H, dh]; dt: [B, T, H]; B_, C_: [B, T, N]; A: [H];
    state: [B, H, dh, N] or None.  Returns (y [B, T, H, dh],
    state [B, H, dh, N])."""
    return ssd(xh, dt, B_, C_, A, state)


__all__ = ["ssd_heads"]
