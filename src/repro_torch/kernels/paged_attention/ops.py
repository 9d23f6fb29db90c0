"""Public decode-attention op over the paged-attention kernel.

``paged_mqa`` is the port's form of the JAX package's
``kernels/paged_attention/ops.py`` ``paged_mqa``, with the same
arguments and a sliding ``window`` (the JAX package masks the window in
``models/attention.py``'s decode, outside its kernel).  The JAX wrapper
repeats the kv heads of every page to H before its kernel; the port's
kernel indexes kv head h // (H // Hk) itself, so ``paged_mqa`` makes no
copy.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import paged_attention


def paged_mqa(q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
              block_table: torch.Tensor,
              seq_lens: torch.Tensor,
              window: Optional[int] = None, *,
              kv_scale: Optional[float] = None, return_lse: bool = False):
    """q: [B, H, dh]; pages_*: [NP, PS, Hk, dh] with H % Hk == 0, in q's
    dtype or int8 (then ``kv_scale`` dequantizes them); block_table:
    [B, MAXP] int32; seq_lens: [B] int32; ``window``: a sliding window's
    width, or None.  Returns [B, H, dh], and with ``return_lse`` also the
    log-sum-exp [B, H] fp32 of the live scores."""
    return paged_attention(q, pages_k, pages_v, block_table, seq_lens,
                           window, kv_scale=kv_scale, return_lse=return_lse)


__all__ = ["paged_mqa"]
