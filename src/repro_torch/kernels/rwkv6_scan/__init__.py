"""RWKV6 time mixing: the WKV6 CUDA kernels' wrappers (the scan and its
gradient), their plain PyTorch versions and the differentiable
``wkv6_heads`` op."""

from .kernel import LAUNCHES, reset_launches, wkv6, wkv6_bwd
from .ops import wkv6_heads
from .ref import wkv6_bwd_plain, wkv6_plain

__all__ = ["LAUNCHES", "reset_launches", "wkv6", "wkv6_bwd",
           "wkv6_bwd_plain", "wkv6_heads", "wkv6_plain"]
