"""Decode attention over KV pages: the paged-attention CUDA kernel
wrapper, its plain PyTorch version and the ``paged_mqa`` op."""

from .kernel import (LAUNCHES, WINDOWED, paged_attention, reset_launches,
                     split_plan)
from .ops import paged_mqa
from .ref import merge_partials, paged_attention_plain

__all__ = ["LAUNCHES", "WINDOWED", "merge_partials", "paged_attention",
           "paged_attention_plain", "paged_mqa", "reset_launches",
           "split_plan"]
