"""Prefill attention: the flash-attention CUDA kernel wrapper, its plain
PyTorch version and the ``mha`` op."""

from .kernel import LAUNCHES, flash_attention, reset_launches
from .ops import mha
from .ref import attention_plain

__all__ = ["LAUNCHES", "attention_plain", "flash_attention", "mha",
           "reset_launches"]
