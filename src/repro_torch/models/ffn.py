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

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import is_placed
from .common import contiguous_meta, dense_init

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
    if is_placed(x):
        return _moe_placed(p, x, cfg)
    if getattr(cfg.moe, "impl", "gshard") == "sorted":
        return moe_forward_sorted(p, x, cfg)
    return moe_forward_gshard(p, x, cfg)


_EXPERT_WEIGHTS = ("w_up", "w_gate", "w_down")


def _moe_placed(p: Params, x: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer over placed tensors, each device on its shard
    (``local_map``): it routes its tokens (replicated over "model") to
    every expert, as the whole layer does, and runs the experts whose
    weights it holds (expert parallel: E over "model") or its slice of
    every expert's FFN (the rules' expert-TP fallback); its output is
    a partial sum over "model", reduced by the residual.  Capacity is
    each data shard's (its tokens' share), as GShard's groups dispatch.
    The load balancing loss is formed from the tokens' mean densities
    and probabilities over the whole batch.  DTensor has no sharding
    rule for the dispatch's data-dependent positions."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    m = cfg.moe
    E, K = m.n_experts, m.top_k
    names = ("router",) + tuple(n for n in _EXPERT_WEIGHTS if n in p)
    w = p["w_up"]
    mesh = w.device_mesh
    model = [i for i, pl in enumerate(w.placements) if pl.is_shard()]
    sorted_impl = getattr(m, "impl", "gshard") == "sorted"

    def routed(x, router, *weights):
        lw = dict(zip(names[1:], weights))
        n = lw["w_up"].shape[0]  # this device's experts
        lo = sum(mesh.get_local_rank(i) for i in model) * n if n < E else 0
        lp = {"router": router, **lw}
        fwd = moe_forward_sorted if sorted_impl else moe_forward_gshard
        y, density, pmean = fwd(lp, x, cfg, experts_at=(lo, n),
                                with_means=True)
        return y, density / shares, pmean / shares

    bx = x.placements
    y_pl = [Partial() if i in model else bx[i] for i in range(mesh.ndim)]
    # the means as sums of equal shares over the data shards (a mean of
    # their means) and the expert shards (each holds the same means), so
    # that their gradients reach each share in its part
    split = [i for i in range(mesh.ndim) if bx[i].is_shard() or i in model]
    shares = math.prod(mesh.size(i) for i in split)
    mean_pl = [Partial() if i in split else Replicate()
               for i in range(mesh.ndim)]
    # gradients: x's over "model" and the router's are partial sums over
    # the devices' experts; the weights' over the data shards' tokens
    x_grad = [Partial() if i in model else bx[i] for i in range(mesh.ndim)]

    def w_grad(t, expert_split):
        return [Partial() if bx[i].is_shard()
                or (i in model and not expert_split) else pl
                for i, pl in enumerate(t.placements)]

    y, density, pmean = local_map(
        routed, out_placements=(y_pl, mean_pl, mean_pl),
        in_placements=(bx,) + tuple(p[n].placements for n in names),
        in_grad_placements=(x_grad,) + tuple(
            w_grad(p[n], n != "router") for n in names),
        device_mesh=mesh, redistribute_inputs=True)(
            x, *(p[n] for n in names))
    aux = E * torch.sum(density / K * pmean)
    return _shared(p, x, contiguous_meta(y), cfg), aux


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


def _means(experts: torch.Tensor, probs: torch.Tensor, E: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The aux loss's two means over the tokens: each expert's share of
    the assignments (times K) and its mean router probability."""
    return F.one_hot(experts, E).sum(1).float().mean(0), probs.mean(0)


def _shared(p: Params, x: torch.Tensor, y: torch.Tensor,
            cfg) -> torch.Tensor:
    return y + mlp_forward(p["shared"], x, cfg.mlp) if "shared" in p else y


def moe_forward_gshard(p: Params, x: torch.Tensor, cfg, *,
                       experts_at: Optional[Tuple[int, int]] = None,
                       with_means: bool = False):
    """Top-k capacity-limited dispatch (GShard), with explicit one-hot
    dispatch [S, E, cap] and combine tensors.  Returns (y, aux).

    ``experts_at`` (lo, n): ``p``'s expert weights are experts lo ..
    lo + n - 1 of E, and y sums those experts' contributions alone;
    ``with_means`` returns (y, the assignments' density [E], the mean
    router probabilities [E]) in place of the aux loss, without the
    shared experts (``_moe_placed``)."""
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
    if experts_at is not None and experts_at[1] != E:
        lo, n = experts_at
        disp, comb = disp[:, lo:lo + n], comb[:, lo:lo + n]
    # expert buffers [E, cap, D]
    buf = torch.einsum("sec,sd->ecd", disp, xt)
    y = torch.einsum("sec,ecd->sd", comb, _experts(p, buf)).reshape(B, T, D)
    if with_means:
        return (y,) + _means(experts, probs, E)
    return _shared(p, x, y, cfg), _aux(experts, probs, E, K)


def moe_forward_sorted(p: Params, x: torch.Tensor, cfg, *,
                       experts_at: Optional[Tuple[int, int]] = None,
                       with_means: bool = False):
    """Sort-based dispatch: assignments sorted by expert (stable, so
    ties keep token order), scattered into the expert buffers and
    gathered back.  The same function as ``moe_forward_gshard``, whose
    ``experts_at`` and ``with_means`` it takes."""
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
    lo, n = experts_at if experts_at is not None else (0, E)
    if n == E:
        slot = torch.where(pos < cap, sorted_e * cap + pos,
                           torch.full_like(pos, E * cap))  # overflow bin
    else:  # another device's experts go to the overflow bin too
        mine = (pos < cap) & (sorted_e >= lo) & (sorted_e < lo + n)
        slot = torch.where(mine, (sorted_e - lo) * cap + pos,
                           torch.full_like(pos, n * cap))
    token = order // K
    buf = torch.zeros(n * cap + 1, D, dtype=x.dtype, device=x.device)
    buf[slot] = xt[token]
    out = _experts(p, buf[:n * cap].reshape(n, cap, D))
    flat_out = torch.cat([out.reshape(n * cap, D),
                          out.new_zeros(1, D)], dim=0)
    # gather back per assignment, weight by gate, sum over K
    contrib = flat_out[slot] * gate_vals.reshape(S * K)[order][:, None] \
        .to(out.dtype)
    y = out.new_zeros(S, D).index_add_(0, token, contrib).reshape(B, T, D)
    if with_means:
        return (y,) + _means(experts, probs, E)
    return _shared(p, x, y, cfg), _aux(experts, probs, E, K)


__all__ = ["init_mlp", "init_moe", "mlp_forward", "moe_forward",
           "moe_forward_gshard", "moe_forward_sorted"]
