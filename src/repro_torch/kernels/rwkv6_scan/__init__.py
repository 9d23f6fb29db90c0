"""RWKV6 time mixing: the WKV6 CUDA kernel wrapper, its plain PyTorch
version and the ``wkv6_heads`` op."""

from .kernel import LAUNCHES, reset_launches, wkv6
from .ops import wkv6_heads
from .ref import wkv6_plain

__all__ = ["LAUNCHES", "reset_launches", "wkv6", "wkv6_heads",
           "wkv6_plain"]
