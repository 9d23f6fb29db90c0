"""Public WKV op over the WKV6 kernel.

``wkv6_heads`` is the port's form of the JAX package's
``kernels/rwkv6_scan/ops.py`` ``wkv6_heads``: the same [B, T, H, dh]
layout at its surface.  The JAX wrapper loops over heads in Python,
one kernel call each, and returns only the output; the port's kernel
covers every head in one launch and carries the state, so
``wkv6_heads`` returns (output, final state) and takes a state in.  The
Pallas ``chunk`` has no counterpart: the CUDA kernel's chunk is fixed
and it masks the ragged last chunk itself.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import wkv6


def wkv6_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: [B, T, H, dh]; u: [H, dh]; state: [B, H, dh, dh]
    or None.  Returns (o [B, T, H, dh], state [B, H, dh, dh])."""
    return wkv6(r, k, v, logw, u, state)


__all__ = ["wkv6_heads"]
