"""Shared model building blocks: the port of ``repro.models.common``.

Parameters are plain tensors (held by the model in ``nn.ParameterDict``s
under the JAX package's names).  The numerics follow the JAX package:
norms in fp32 and cast back to the input's dtype, the *interleaved*
rotary embedding (pairs ``x[..., 0::2]``, ``x[..., 1::2]``, not the
rotate-half layout), weights drawn in fp32 and cast to bf16.  Random
init draws from an explicit ``torch.Generator``; it gives other numbers
than ``jax.random`` from the same seed, so tests carry the JAX
package's parameters over (``convert.lm_params_from_arrays``).

The models also run over DTensors (``launch.steps.lower_cell`` on a
production mesh).  On plain tensors the helpers below are the plain ops
they name; over placed tensors they partition as Megatron does where
DTensor's own rules would not: ``local_heads`` runs a kernel on each
device's batch and heads (``local_map``, the counterpart of
``shard_map``), ``lookup`` and ``softmax_xent`` are vocabulary
parallel, ``residual`` keeps the residual stream replicated over
"model", ``split_heads``, ``merge_heads`` and ``reduce_like`` place a
reshape's or an add's operand where the next op can take it, and
``row_matmul`` gives a row-parallel product its input sharded on the
weight's rows.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..distributed.sharding import is_placed, placed_as

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
    if is_placed(logits):
        return torch.mean(_xent_placed(logits, labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


Dims = Optional[Tuple[Optional[int], Optional[int]]]


def split_heads(t: torch.Tensor, heads: int, dh: int) -> torch.Tensor:
    """[..., heads * dh] -> [..., heads, dh].  Placed with the last
    dimension sharded over more devices than divide ``heads``, that
    dimension is gathered first: the rules' replication fallback, for
    heads that do not divide the "model" axis (DTensor does not move a
    shard from the heads into the head dimension, as XLA does)."""
    if is_placed(t):
        from torch.distributed.tensor import Replicate, Shard

        last = Shard(t.ndim - 1)
        n = math.prod(t.device_mesh.size(i)
                      for i, p in enumerate(t.placements) if p == last)
        if heads % n:
            t = t.redistribute(t.device_mesh, [
                Replicate() if p == last else p for p in t.placements])
    return t.reshape(*t.shape[:-1], heads, dh)


def reduce_like(t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A placed ``t`` [..., n] whose partial sums are reduced to the
    placements of ``v`` [n] along the last dimension (scattered where
    ``v`` is sharded, all-reduced where it is not), so that ``t + v``
    needs nothing more; DTensor would also shard the tokens over an
    axis the batch leaves idle, which the sequence's reshapes cannot
    take."""
    if not is_placed(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    last = Shard(t.ndim - 1)
    want = [(last if q.is_shard() else Replicate()) if p.is_partial() else p
            for p, q in zip(t.placements, v.placements)]
    return t.redistribute(t.device_mesh, want)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[..., heads, dh] -> [..., heads * dh].  Placed, the result's
    gradient comes back at its placements (``keep_grad``), so that a
    gradient sharded over the merged dimension is gathered before it is
    split into heads that do not divide its shards."""
    out = t.reshape(*t.shape[:-2], -1)
    return keep_grad(out) if is_placed(out) else out


def row_matmul(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``t @ w`` for a row-parallel ``w`` [n, m] (attention's ``wo``).
    Placed, ``t`` [..., n] is first sharded on its last dimension over
    each mesh dimension where ``w`` is sharded on its rows and ``t`` is
    replicated (a local slice, no collective), as Megatron's row-parallel
    product takes its input: each device multiplies its slice by its
    rows into partial sums, and ``w``'s gradient comes out placed as
    ``w``.  ``t`` arrives replicated where the heads fall back to
    replication (``split_heads``); DTensor would then gather ``w`` and
    give its gradient whole."""
    if is_placed(t) and is_placed(w):
        from torch.distributed.tensor import Replicate, Shard

        want = [Shard(t.ndim - 1) if q == Shard(0) and p == Replicate()
                else p for p, q in zip(t.placements, w.placements)]
        if tuple(want) != tuple(t.placements):
            t = t.redistribute(t.device_mesh, want)
    return torch.matmul(t, w)


def keep_grad(t: torch.Tensor) -> torch.Tensor:
    """A placed ``t`` whose gradient is redistributed to ``t``'s own
    placements as it flows back (partial sums reduced, shards
    gathered), where DTensor would pass it on as it comes."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.to_local(grad_placements=t.placements),
                              t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y``.  Placed, the residual stream keeps the batch's
    placements (sharded over the data axes, replicated over "model") as
    Megatron's does: ``y`` is given ``x``'s placements first (a row-
    parallel product's partial sums all-reduced once), and the sum's
    gradient is made whole (all-reduced) as it flows back
    (``keep_grad``), where DTensor would carry it as partial sums into
    the weights' gradients and gather the activations there."""
    if not is_placed(y):
        return x + y
    return keep_grad(x + placed_as(y, x))


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  Placed, vocabulary parallel as Megatron's
    embedding: each device looks up the ids its shard of the table's rows
    holds, zeroes the others, and the rows are summed over the shards
    (an all-reduce of [..., D]) into the ids' placements, where DTensor
    would gather the whole table."""
    if not is_placed(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]

    def rows(tab, idx):
        V = tab.shape[0]
        idx = idx.long() - sum(mesh.get_local_rank(i) for i in vocab) * V
        hit = (idx >= 0) & (idx < V)
        return tab[idx.clamp(0, V - 1)] * hit[..., None].to(tab.dtype)

    out = [Partial() if i in vocab else p
           for i, p in enumerate(ids.placements)]
    # each device's rows' gradient covers its tokens alone
    grad = [Partial() if q.is_shard() else p
            for p, q in zip(table.placements, ids.placements)]
    x = local_map(rows, out_placements=out,
                  in_placements=(table.placements, ids.placements),
                  in_grad_placements=(grad, ids.placements),
                  device_mesh=mesh, redistribute_inputs=True)(table, ids)
    return contiguous_meta(x).redistribute(mesh, ids.placements)


def local_heads(fn: Callable, tensors: Sequence[torch.Tensor],
                dims: Sequence[Dims], out_dims: Sequence[Dims],
                in_place: Sequence[int] = ()):
    """``fn(*tensors)`` on each device's shard where the tensors are
    DTensors (``torch.distributed.tensor.experimental.local_map``, the
    counterpart of ``shard_map``); ``fn(*tensors)`` itself on plain
    tensors.  ``dims`` gives each tensor's (batch dimension, head
    dimension), either None where it has none, and ``out_dims`` each
    output's.  Each mesh dimension splits the batch where every tensor
    with a batch dimension is sharded on it there, else the heads where
    every tensor with a head dimension is, else nothing (the tensors are
    redistributed to that: an all-gather where, say, the query's heads
    are sharded and the keys' are not).  A tensor without the dimension
    a mesh dimension splits (RWKV's bonus u [H, dh] where the batch is
    split) gets its gradient as partial sums over it.  The tensors at
    ``in_place`` are written by ``fn`` and must have those placements
    already."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    placed = [t for t in tensors if is_placed(t)]
    if not placed:
        return fn(*tensors)
    mesh = placed[0].device_mesh
    modes = []
    for i in range(mesh.ndim):
        def split(which):
            have = [(t, d[which]) for t, d in zip(tensors, dims)
                    if d is not None and d[which] is not None]
            return bool(have) and all(
                isinstance(t, DTensor) and t.placements[i] == Shard(d)
                for t, d in have)
        modes.append(0 if split(0) else 1 if split(1) else None)

    def placements(d: Dims):
        return tuple(Replicate() if m is None or d[m] is None
                     else Shard(d[m]) for m in modes)

    want = tuple(placements(d) for d in dims)
    grads = tuple(tuple(Partial() if m is not None and d[m] is None else p
                        for m, p in zip(modes, w))
                  for d, w in zip(dims, want))
    for i in in_place:
        if tensors[i].placements != want[i]:
            raise ValueError(f"a tensor written in place is placed "
                             f"{tensors[i].placements}, not {want[i]}")
    outs = tuple(placements(d) for d in out_dims)
    got = local_map(fn, out_placements=outs if len(outs) > 1
                    else list(outs[0]),
                    in_placements=want, in_grad_placements=grads,
                    device_mesh=mesh, redistribute_inputs=True)(*tensors)
    return tuple(map(contiguous_meta, got)) if isinstance(got, tuple) \
        else contiguous_meta(got)


def contiguous_meta(t: torch.Tensor) -> torch.Tensor:
    """A placed ``t`` made of contiguous shards, described with a whole
    tensor's contiguous strides.  ``local_map`` derives its outputs'
    strides from their shards', which over a sharded dimension are not a
    whole tensor's (a size-1 dimension's included): a later reshape
    would copy it and a product would not fold into one ``mm``."""
    if not is_placed(t):
        return t
    stride, n = [], 1  # a whole tensor's, with no tensor made for them
    for d in reversed(t.shape):
        stride.insert(0, n)
        n *= max(d, 1)
    stride = tuple(stride)
    if t.stride() == stride:
        return t
    from torch.distributed.tensor import DTensor

    local = t.to_local()
    assert local.is_contiguous()
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape, stride=stride)


def _xent_placed(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Each token's cross-entropy over placed fp32 ``logits``, vocabulary
    parallel as Megatron computes it: the max and the sum of exponentials
    are reduced over the vocabulary's shards (all-reduces of [B, T]) and
    each device picks the gold logits that its shard holds, where DTensor
    would gather the whole [B, T, V] logits for ``logsumexp``.  The same
    function as ``logsumexp(logits) - logits[labels]``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, last = logits.device_mesh, logits.ndim - 1

    def whole(t):
        return t.redistribute(mesh, [Replicate() if p.is_partial() else p
                                     for p in t.placements])

    m = whole(logits.detach().amax(-1, keepdim=True))
    logz = torch.log(whole(torch.exp(logits - m).sum(-1))) + m[..., 0]
    vocab = [i for i, p in enumerate(logits.placements) if p == Shard(last)]

    def gold(lg, lab):
        V = lg.shape[-1]
        off = sum(mesh.get_local_rank(i) for i in vocab) * V
        idx = lab.long() - off
        hit = (idx >= 0) & (idx < V)
        g = torch.gather(lg, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
        return g * hit

    out = [Partial() if p == Shard(last) else p for p in logits.placements]
    g = local_map(gold, out_placements=out,
                  in_placements=(logits.placements, labels.placements),
                  device_mesh=mesh)(logits, labels)
    return logz - whole(g)


__all__ = ["MetaGenerator", "Params", "apply_rope", "causal_mask",
           "contiguous_meta", "dense_init", "keep_grad", "layernorm",
           "local_heads", "lookup", "merge_heads", "norm", "norm_params",
           "reduce_like", "residual", "rmsnorm", "rope_freqs", "row_matmul",
           "softmax_xent", "split_heads"]
