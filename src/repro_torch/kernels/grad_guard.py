"""The guard of the raw kernel wrappers under grad.

A kernel launched through ctypes returns a tensor with no ``grad_fn``,
so autograd through a raw wrapper would drop every gradient behind it
without a word on the card, while on the CPU the plain versions are
differentiable: the two devices would disagree silently.  The raw
wrappers of ``wkv6``, ``ssd`` and ``paged_attention``, and the scans'
backward wrappers ``wkv6_bwd`` and ``ssd_bwd``, therefore refuse, on
both devices, a call made with grad mode on and a floating input that
requires grad.  The public ops carry the gradient: ``wkv6_heads``,
``ssd_heads`` and ``mha`` are autograd Functions whose forward calls
the raw wrapper with grad mode off and whose backward launches the
backward kernel.  ``paged_attention`` (decode) has no backward; serving
runs under ``no_grad`` and never meets the guard.
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
            f"{name} has no backward kernel of its own: call the "
            "differentiable op (wkv6_heads, ssd_heads, mha), or call it "
            "under torch.no_grad() or with inputs that do not require grad")


__all__ = ["refuse_grad"]
