"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a usable card
    raises: the port never falls back to the CPU on its own, because a
    CPU run is the plain PyTorch versions, not the kernels.  Pass
    ``device="cpu"`` to run those on purpose, or ``device="meta"`` for
    shapes alone (the dry run: nothing is allocated or computed, and the
    kernels' wrappers charge their work instead of launching)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions of its kernels on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu' (or 'meta' "
                         f"for the dry run), not {dev}")
    return dev


__all__ = ["resolve_device"]
