"""Dense MLP (SwiGLU / GELU): the port of ``repro.models.ffn``'s
``init_mlp`` and ``mlp_forward``.  The matrix products are
``torch.matmul``, as the JAX package leaves them to XLA.  The MoE
layers (``init_moe``, ``moe_forward``) are not yet ported."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import dense_init

Params = Dict[str, torch.Tensor]


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             kind: str) -> Params:
    p = {"w_up": dense_init(gen, (d_model, d_ff)),
         "w_down": dense_init(gen, (d_ff, d_model))}
    if kind == "swiglu":
        p["w_gate"] = dense_init(gen, (d_model, d_ff))
    return p


def mlp_forward(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    up = torch.matmul(x, p["w_up"])
    if kind == "swiglu":
        h = F.silu(torch.matmul(x, p["w_gate"])) * up
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return torch.matmul(h, p["w_down"])


__all__ = ["init_mlp", "mlp_forward"]
