"""Shared model building blocks: the port of ``repro.models.common``.

Parameters are plain tensors (held by the model in ``nn.ParameterDict``s
under the JAX package's names).  The numerics follow the JAX package:
norms in fp32 and cast back to the input's dtype, the *interleaved*
rotary embedding (pairs ``x[..., 0::2]``, ``x[..., 1::2]``, not the
rotate-half layout), weights drawn in fp32 and cast to bf16.  Random
init draws from an explicit ``torch.Generator``; it gives other numbers
than ``jax.random`` from the same seed, so tests carry the JAX
package's parameters over (``convert.lm_params_from_arrays``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


def norm(x: torch.Tensor, p: Params, kind: str, eps: float) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"], eps)
    return rmsnorm(x, p["w"], eps)


def norm_params(d: int, kind: str, device=None) -> Params:
    if kind == "layernorm":
        return {"w": torch.ones(d, dtype=torch.float32, device=device),
                "b": torch.zeros(d, dtype=torch.float32, device=device)}
    return {"w": torch.ones(d, dtype=torch.float32, device=device)}


class MetaGenerator:
    """The stand-in for a ``torch.Generator`` on ``meta``, where PyTorch
    has none: ``dense_init`` reads its device and draws nothing."""

    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Normal(0, 1) in fp32 times ``scale`` (1/sqrt(fan_in) by default),
    cast to ``dtype``; drawn on the generator's device.  On ``meta``
    (``MetaGenerator``) nothing is drawn: an empty tensor of the shape."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, Dh]; positions: [..., T] (broadcastable).  Rotates
    the interleaved pairs (x[..., 2i], x[..., 2i + 1]) by position *
    theta^(-2i / Dh), in fp32, and casts back to x's dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def causal_mask(q_len: int, kv_len: int, *, window: Optional[int] = None,
                q_offset: int = 0, device=None) -> torch.Tensor:
    """[q_len, kv_len] boolean mask (True = attend). ``q_offset`` is the
    absolute position of query 0 (for prefill continuation/decode)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, fp32 accumulation (logits [..., V],
    labels [...] int)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


__all__ = ["MetaGenerator", "Params", "apply_rope", "causal_mask",
           "dense_init", "layernorm", "norm", "norm_params", "rmsnorm",
           "rope_freqs", "softmax_xent"]
