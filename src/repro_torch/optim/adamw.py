"""AdamW with fp32 master weights and moments for (possibly bf16)
parameters, and global-norm gradient clipping: the port of
``repro.optim.adamw``.

Parameters, gradients and the state's ``m``, ``v`` and ``master`` are
dicts of tensors keyed by the model's parameter names (the port
``LM``'s state-dict names).  ``update`` works leaf by leaf, in place
under ``no_grad``: the JAX package builds a new tree, whose whole-tree
``g.astype(float32) * scale`` alone would be 12 GB more at MiniCPM-2B;
here one leaf's fp32 gradient is alive at a time.  The arithmetic is the
JAX package's, in fp32.

Over a production mesh the parameters, gradients and state are
DTensors, and ``update`` does the ZeRO step that XLA's partitioner
inserts in the JAX program: each gradient is redistributed to its
moment's placement (``launch.steps.place_opt_state``: a reduce-scatter
over the data axes), the norm and m, v and master are computed on those
shards, and the new master, cast to the parameter's dtype, is
redistributed to the parameter's placement (an all-gather) before it is
copied in.  The JAX package's ``init_spec`` (an
``eval_shape`` for the dry run) has no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..distributed.sharding import is_placed, placed_as

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    m: Params
    v: Params
    master: Params  # fp32 copy of the (possibly bf16) params


def init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    """Zero moments and an fp32 master copy of each parameter, on its
    device."""
    with torch.no_grad():
        return AdamWState(
            step=0,
            m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
            v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
            master={k: p.detach().to(torch.float32, copy=True)
                    for k, p in params.items()})


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (a 0-d tensor on
    the leaves' device); over placed leaves, their shards' sums reduced
    over the mesh."""
    with torch.no_grad():
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree.values()))


def _f32(x: float) -> float:
    """x rounded to fp32, as the JAX package's fp32 scalars hold it."""
    return float(torch.tensor(x, dtype=torch.float32))


def update(grads: Mapping[str, torch.Tensor], state: AdamWState,
           params: Mapping[str, torch.Tensor], *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           clip_norm: Optional[float] = 1.0) -> Tuple[Params, AdamWState]:
    """One AdamW step at learning rate ``lr`` (a float or a 0-d tensor).
    Writes ``state``'s moments and master weights and ``params`` in
    place and returns (params, the state with its step advanced)."""
    step = state.step + 1
    lr = _f32(float(lr))
    with torch.no_grad():
        grads = {k: placed_as(grads[k], state.m[k]) for k in params}
        scale = None
        if clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
        b1c = _f32(1.0 - float(torch.tensor(b1, dtype=torch.float32)
                               ** float(step)))
        b2c = _f32(1.0 - float(torch.tensor(b2, dtype=torch.float32)
                               ** float(step)))
        for k, p in params.items():
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            m, v, w = state.m[k], state.v[k], state.master[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(g * g, alpha=1 - b2)
            del g
            upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(eps))
            w.sub_(upd.add_(w, alpha=weight_decay).mul_(lr))
            del upd
            p.copy_(placed_as(w.to(p.dtype), p) if is_placed(p) else w)
    return dict(params), AdamWState(step=step, m=state.m, v=state.v,
                                    master=state.master)


__all__ = ["AdamWState", "global_norm", "init", "update"]
