"""Mamba-2 SSD scan: the SSD CUDA kernels' wrappers (the scan and its
gradient), their plain PyTorch versions and the differentiable
``ssd_heads`` op."""

from .kernel import LAUNCHES, reset_launches, ssd, ssd_bwd
from .ops import ssd_heads
from .ref import ssd_bwd_plain, ssd_plain

__all__ = ["LAUNCHES", "reset_launches", "ssd", "ssd_bwd", "ssd_bwd_plain",
           "ssd_heads", "ssd_plain"]
