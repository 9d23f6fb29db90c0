"""FFN layers: the port of ``repro.models.ffn``.  The dense MLP (SwiGLU
/ GELU) and the MoE layer with capacity-factor dispatch, in both of
the JAX package's forms: GShard's one-hot dispatch and combine
(``moe_forward_gshard``) and the sort-based dispatch
(``moe_forward_sorted``).  Both return (y, aux) with the same capacity
``cap = max(K, ceil(cf * S * K / E))``, the same drop rule (an
assignment past its expert's ``cap`` slots, in token order, is dropped)
and the same Switch load-balancing loss; ``moe_forward`` picks one by
``cfg.moe.impl``.

The top-K experts of a token are taken by a stable descending sort, so
of two equal router probabilities the lower expert index comes first,
as ``jax.lax.top_k`` orders them (``torch.topk`` promises no order for
ties).  The matrix products are ``torch.matmul`` and ``einsum``, as the
JAX package leaves them to XLA: the JAX package has no Pallas kernel
here.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def _act(up: torch.Tensor, gate) -> torch.Tensor:
    if gate is not None:
        return F.silu(gate) * up
    return F.gelu(up, approximate="tanh")  # jax.nn.gelu's default


def mlp_forward(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    up = torch.matmul(x, p["w_up"])
    gate = torch.matmul(x, p["w_gate"]) if kind == "swiglu" else None
    return torch.matmul(_act(up, gate), p["w_down"])


def init_moe(gen: torch.Generator, cfg) -> Params:
    """Router, the experts' stacked weights [E, ...] and, for
    configurations with shared experts, a nested ``shared`` MLP."""
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": dense_init(gen, (d, m.n_experts), scale=0.02),
        "w_up": dense_init(gen, (m.n_experts, d, m.d_expert)),
        "w_down": dense_init(gen, (m.n_experts, m.d_expert, d)),
    }
    if cfg.mlp == "swiglu":
        p["w_gate"] = dense_init(gen, (m.n_experts, d, m.d_expert))
    if m.n_shared:
        p["shared"] = init_mlp(gen, d, m.n_shared * m.d_expert, cfg.mlp)
    return p


def moe_forward(p: Params, x: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if getattr(cfg.moe, "impl", "gshard") == "sorted":
        return moe_forward_sorted(p, x, cfg)
    return moe_forward_gshard(p, x, cfg)


def _route(p: Params, xt: torch.Tensor, cfg):
    """Capacity, router probabilities [S, E] fp32, and each token's top-K
    gates (renormalised) and experts [S, K]."""
    m = cfg.moe
    S = xt.shape[0]
    E, K = m.n_experts, m.top_k
    # ceil + floor of K so tiny decode batches never drop tokens
    cap = max(K, -(-int(m.capacity_factor * S * K) // E))
    probs = torch.softmax(torch.matmul(xt, p["router"]).float(), dim=-1)
    gate_vals, experts = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    gate_vals, experts = gate_vals[:, :K], experts[:, :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return cap, probs, gate_vals, experts


def _experts(p: Params, ebuf: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN over its buffer: [E, cap, D] -> [E, cap, D]."""
    up = torch.einsum("ecd,edf->ecf", ebuf, p["w_up"])
    gate = torch.einsum("ecd,edf->ecf", ebuf, p["w_gate"]) \
        if "w_gate" in p else None
    return torch.einsum("ecf,efd->ecd", _act(up, gate), p["w_down"])


def _aux(experts: torch.Tensor, probs: torch.Tensor, E: int,
         K: int) -> torch.Tensor:
    """Switch load-balancing loss: E * sum_e f_e * p_e."""
    density = F.one_hot(experts, E).sum(1).float().mean(0)
    return E * torch.sum(density / K * probs.mean(0))


def _shared(p: Params, x: torch.Tensor, y: torch.Tensor,
            cfg) -> torch.Tensor:
    return y + mlp_forward(p["shared"], x, cfg.mlp) if "shared" in p else y


def moe_forward_gshard(p: Params, x: torch.Tensor, cfg
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-limited dispatch (GShard), with explicit one-hot
    dispatch [S, E, cap] and combine tensors.  Returns (y, aux)."""
    m = cfg.moe
    B, T, D = x.shape
    S = B * T
    E, K = m.n_experts, m.top_k
    xt = x.reshape(S, D)
    cap, probs, gate_vals, experts = _route(p, xt, cfg)
    # position of each (token, k) within its expert's buffer
    onehot = F.one_hot(experts, E)  # [S, K, E] int64
    flat = onehot.reshape(S * K, E)
    pos_in_expert = (torch.cumsum(flat, 0) - flat).reshape(S, K, E)
    within_cap = (pos_in_expert < cap) & (onehot > 0)
    pos = (pos_in_expert * onehot).sum(-1)  # [S, K]
    # one_hot of a position past cap is all zeros, as in jax.nn.one_hot
    pos_oh = F.one_hot(pos.clamp(max=cap - 1), cap) * (pos < cap)[..., None]
    keep = within_cap.float() * onehot.float()
    disp = torch.einsum("ske,skc->sec", keep.to(x.dtype), pos_oh.to(x.dtype))
    comb = torch.einsum("ske,skc,sk->sec", keep, pos_oh.float(),
                        gate_vals).to(x.dtype)
    # expert buffers [E, cap, D]
    buf = torch.einsum("sec,sd->ecd", disp, xt)
    y = torch.einsum("sec,ecd->sd", comb, _experts(p, buf)).reshape(B, T, D)
    return _shared(p, x, y, cfg), _aux(experts, probs, E, K)


def moe_forward_sorted(p: Params, x: torch.Tensor, cfg
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch: assignments sorted by expert (stable, so
    ties keep token order), scattered into the expert buffers and
    gathered back.  The same function as ``moe_forward_gshard``."""
    m = cfg.moe
    B, T, D = x.shape
    S = B * T
    E, K = m.n_experts, m.top_k
    xt = x.reshape(S, D)
    cap, probs, gate_vals, experts = _route(p, xt, cfg)
    flat_e = experts.reshape(S * K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # position of each assignment within its expert's buffer
    starts = torch.searchsorted(sorted_e,
                                torch.arange(E, device=x.device))
    pos = torch.arange(S * K, device=x.device) - starts[sorted_e]
    slot = torch.where(pos < cap, sorted_e * cap + pos,
                       torch.full_like(pos, E * cap))  # overflow bin
    token = order // K
    buf = torch.zeros(E * cap + 1, D, dtype=x.dtype, device=x.device)
    buf[slot] = xt[token]
    out = _experts(p, buf[:E * cap].reshape(E, cap, D))
    flat_out = torch.cat([out.reshape(E * cap, D),
                          out.new_zeros(1, D)], dim=0)
    # gather back per assignment, weight by gate, sum over K
    contrib = flat_out[slot] * gate_vals.reshape(S * K)[order][:, None] \
        .to(out.dtype)
    y = out.new_zeros(S, D).index_add_(0, token, contrib).reshape(B, T, D)
    return _shared(p, x, y, cfg), _aux(experts, probs, E, K)


__all__ = ["init_mlp", "init_moe", "mlp_forward", "moe_forward",
           "moe_forward_gshard", "moe_forward_sorted"]
