"""Public attention op over the flash-attention kernel.

``mha`` is the port's form of the JAX package's
``kernels/flash_attention/ops.py`` ``mha``: the same [B, T, H, dh] /
[B, S, Hk, dh] layout at its surface.  The JAX wrapper repeats the kv
heads and folds batch and heads before its kernel; the port's kernel
takes the layout as it is and indexes kv head h // (H // Hk), so ``mha``
makes no copy.  The Pallas block sizes (``q_block``, ``kv_block``) have
no counterpart: the CUDA kernel's tiles are fixed and it masks ragged
edges itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: [B, T, H, dh]; k, v: [B, S, Hk, dh] (GQA: H % Hk == 0).
    Returns [B, T, H, dh]."""
    return flash_attention(q, k, v, causal=causal, window=window)


__all__ = ["mha"]
