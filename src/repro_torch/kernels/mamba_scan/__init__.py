"""Mamba-2 SSD scan: the SSD CUDA kernel wrapper, its plain PyTorch
version and the ``ssd_heads`` op."""

from .kernel import LAUNCHES, reset_launches, ssd
from .ops import ssd_heads
from .ref import ssd_plain

__all__ = ["LAUNCHES", "reset_launches", "ssd", "ssd_heads", "ssd_plain"]
