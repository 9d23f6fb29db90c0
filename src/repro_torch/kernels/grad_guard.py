"""The guard of the kernels that have no backward yet.

A kernel launched through ctypes returns a tensor with no ``grad_fn``,
so autograd through it would drop every gradient behind it without a
word on the card, while on the CPU the plain versions are
differentiable: the two devices would disagree silently.  The wrappers
of ``wkv6``, ``ssd`` and ``paged_attention`` therefore refuse, on both
devices, a call made with grad mode on and a floating input that
requires grad.  Serving runs under ``no_grad`` and never meets it.
"""

from __future__ import annotations

from typing import Optional

import torch


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.is_floating_point() and t.requires_grad
           for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel yet: call it under "
            "torch.no_grad(), or with inputs that do not require grad")


__all__ = ["refuse_grad"]
