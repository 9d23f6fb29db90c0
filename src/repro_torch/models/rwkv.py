"""RWKV6 "Finch" block (arXiv:2404.05892): attention-free time mixing
with data-dependent decay, plus channel mixing.  The port of
``repro.models.rwkv``.

Per head, with S the [dh, dh] state,

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t S_{t-1} + u * (r_t . k_t) v_t

The JAX package computes it over a sequence with the jnp chunked form
(``_wkv_chunked``) and in decode with a one-step outer product and
einsum (``rwkv_decode``).  The port runs both on the WKV6 kernel
(``kernels.rwkv6_scan.wkv6_heads``): over the prompt from a zero state,
and in decode at T = 1 from the carried state, one launch per layer per
step; in training ``wkv6_heads``' backward runs the WKV6 gradient
kernel (``wkv6_bwd``), one launch per layer per step.  On the card those
are the CUDA kernels, on the CPU their plain PyTorch versions.  The kernel keeps the whole WKV in fp32 and rounds the
output once, where ``_wkv_chunked`` rounds its in-chunk terms to the
activations' dtype: in fp32 the two agree, in bf16 they differ by bf16
rounding.

Finch's token-shift LoRAs are simplified to a learned per-channel blend
(``mu``) and a data-dependent decay projection, as in the JAX package.
Parameter names and dtypes are the JAX package's: bf16 projections,
fp32 ``decay_bias``, ``bonus_u``, ``mu`` and ``cm_mu``.  The matrix
products are ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.rwkv6_scan import wkv6_heads
from ..distributed.sharding import placed_as
from .common import dense_init, local_heads, merge_heads, split_heads

Params = Dict[str, torch.Tensor]


def init_rwkv(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    r = cfg.rwkv
    H = d // r.head_dim
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "w_r": dense_init(gen, (d, d)),
        "w_k": dense_init(gen, (d, d)),
        "w_v": dense_init(gen, (d, d)),
        "w_o": dense_init(gen, (d, d)),
        "w_decay": dense_init(gen, (d, d), scale=0.01),
        "decay_bias": full((d,), -6.0),
        "bonus_u": full((H, r.head_dim), 0.0),
        "mu": full((4, d), 0.5),  # token-shift blend of r, k, v, w
        "cm_k": dense_init(gen, (d, cfg.d_ff)),
        "cm_v": dense_init(gen, (cfg.d_ff, d)),
        "cm_r": dense_init(gen, (d, d)),
        "cm_mu": full((2, d), 0.5),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The x_{t-1} stream; ``prev`` is the carry token."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _blend(x: torch.Tensor, xprev: torch.Tensor, mu: torch.Tensor,
           i: int) -> torch.Tensor:
    return x * mu[i] + xprev * (1 - mu[i])


def _time_mix_inputs(p: Params, x: torch.Tensor, xprev: torch.Tensor, cfg):
    """r, k, v [B, T, H, dh] in x's dtype and the log decay logw
    [B, T, H, dh] fp32 (below 0) for inputs x and x_{t-1}: [B, T, D]."""
    D = x.shape[-1]
    dh = cfg.rwkv.head_dim
    mu = p["mu"].to(x.dtype)
    r, k, v = (split_heads(torch.matmul(_blend(x, xprev, mu, i), p[name]),
                           D // dh, dh)
               for i, name in enumerate(("w_r", "w_k", "w_v")))
    # data-dependent decay (Finch): w_t = exp(-exp(decay(x_t)))
    dd = torch.matmul(_blend(x, xprev, mu, 3), p["w_decay"]).float()
    logw = -torch.exp(dd + p["decay_bias"])
    return r, k, v, split_heads(logw, D // dh, dh)


# (batch, heads) dimensions of wkv6_heads' r, k, v, logw [B, T, H, dh],
# u [H, dh] (and a state [B, H, dh, dh]), and of its y and final state
_WKV_DIMS = ((0, 2),) * 4 + ((None, 0),)
_WKV_OUT = ((0, 2), (0, 1))


def rwkv_forward(p: Params, x: torch.Tensor, cfg, *,
                 prev_token: Optional[torch.Tensor] = None,
                 return_state: bool = False):
    """Time mixing over a full sequence from a zero WKV state.
    x: [B, T, D] (post-norm input).  With ``return_state`` also returns
    {"wkv": [B, H, dh, dh] fp32, "shift": x[:, -1]}."""
    B, _, D = x.shape
    prev = prev_token if prev_token is not None \
        else torch.zeros(B, D, dtype=x.dtype, device=x.device)
    r, k, v, logw = _time_mix_inputs(p, x, _token_shift(x, prev), cfg)
    y, final = local_heads(wkv6_heads, (r, k, v, logw, p["bonus_u"]),
                           _WKV_DIMS, _WKV_OUT)
    out = torch.matmul(merge_heads(y), p["w_o"])
    if return_state:
        return out, {"wkv": final, "shift": x[:, -1]}
    return out


def _channel_mix(p: Params, x: torch.Tensor,
                 xprev: torch.Tensor) -> torch.Tensor:
    mu = p["cm_mu"].to(x.dtype)
    k = torch.square(torch.relu(torch.matmul(_blend(x, xprev, mu, 0),
                                             p["cm_k"])))
    kv = torch.matmul(k, p["cm_v"])
    rgate = torch.sigmoid(torch.matmul(_blend(x, xprev, mu, 1), p["cm_r"]))
    # placed: kv's partial sums scattered to rgate's shards of D, which
    # leaves the tokens where they are
    return rgate * placed_as(kv, rgate)


def channel_mix(p: Params, x: torch.Tensor,
                prev_token: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, _, D = x.shape
    prev = prev_token if prev_token is not None \
        else torch.zeros(B, D, dtype=x.dtype, device=x.device)
    return _channel_mix(p, x, _token_shift(x, prev))


def init_rwkv_state(cfg, batch: int, dtype: torch.dtype = torch.bfloat16,
                    device=None) -> Params:
    r = cfg.rwkv
    D = cfg.d_model
    H = D // r.head_dim
    return {
        "wkv": torch.zeros(batch, H, r.head_dim, r.head_dim,
                           dtype=torch.float32, device=device),
        "shift_tm": torch.zeros(batch, D, dtype=dtype, device=device),
        "shift_cm": torch.zeros(batch, D, dtype=dtype, device=device),
    }


def rwkv_decode(p: Params, x: torch.Tensor, state: Params, cfg
                ) -> Tuple[torch.Tensor, Params]:
    """One-token time mix with O(1) state: the WKV kernel at T = 1 from
    ``state["wkv"]``.  x: [B, 1, D] is the post-norm input; channel
    mixing is applied by the caller with its own shift state.  Returns
    (y [B, 1, D], {"wkv", "shift_tm"}), new tensors."""
    B, _, D = x.shape
    xprev = state["shift_tm"].to(x.dtype)[:, None]
    r, k, v, logw = _time_mix_inputs(p, x, xprev, cfg)
    o, wkv = local_heads(wkv6_heads,
                         (r, k, v, logw, p["bonus_u"], state["wkv"]),
                         _WKV_DIMS + ((0, 1),), _WKV_OUT)
    out = torch.matmul(o.reshape(B, 1, D), p["w_o"])
    return out, {"wkv": wkv,
                 "shift_tm": x[:, 0].to(state["shift_tm"].dtype)}


def channel_mix_decode(p: Params, x: torch.Tensor, shift: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, 1, D]; shift: [B, D].  Returns (y [B, 1, D], new shift)."""
    y = _channel_mix(p, x, shift.to(x.dtype)[:, None])
    return y, x[:, 0].to(shift.dtype)


__all__ = ["channel_mix", "channel_mix_decode", "init_rwkv",
           "init_rwkv_state", "rwkv_decode", "rwkv_forward"]
