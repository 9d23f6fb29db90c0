"""Prefill and training attention: the flash-attention CUDA kernels'
wrappers (the forward and its gradient), their plain PyTorch versions
and the differentiable ``mha`` op."""

from .kernel import LAUNCHES, flash_attention, flash_attention_bwd, \
    reset_launches
from .ops import mha
from .ref import attention_bwd_plain, attention_plain

__all__ = ["LAUNCHES", "attention_bwd_plain", "attention_plain",
           "flash_attention", "flash_attention_bwd", "mha", "reset_launches"]
