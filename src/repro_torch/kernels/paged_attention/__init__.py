"""Decode attention over KV pages: the paged-attention CUDA kernel
wrapper, its plain PyTorch version and the ``paged_mqa`` op."""

from .kernel import LAUNCHES, paged_attention, reset_launches
from .ops import paged_mqa
from .ref import paged_attention_plain

__all__ = ["LAUNCHES", "paged_attention", "paged_attention_plain",
           "paged_mqa", "reset_launches"]
