"""The chained 64-bit probe: CUDA kernel wrapper, plain PyTorch version,
the per-epoch line table it reads, and the fingerprint lanes of every
probe kernel."""

from .fingerprint import FP_EMPTY, account, fp64, fp_partial
from .kernel import LAUNCHES, probe_chain, reset_launches
from .layout import pack_lines
from .ref import probe_chain_plain

__all__ = ["FP_EMPTY", "LAUNCHES", "account", "fp64", "fp_partial",
           "pack_lines", "probe_chain", "probe_chain_plain",
           "reset_launches"]
