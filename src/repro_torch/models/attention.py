"""GQA attention: full-sequence attention for training
(``attn_forward``), prefill (causal), single-token decode against a
dense per-request KV cache, and Whisper's decoder-to-encoder cross
attention (``cross_attn_forward``).  The port of
``repro.models.attention``.

Training, prefill and cross attention (at decode too) run on the
flash-attention kernel (``kernels.flash_attention.mha``) and decode
self-attention on the paged kernel
(``kernels.paged_attention.paged_mqa``): on the card their CUDA
kernels, on the CPU their plain PyTorch versions.  The JAX package runs
both as jnp (``_sdpa`` and the einsums of ``attn_decode``); its Pallas
kernels compute the same function.  The kernels keep the softmax
weights in fp32 for the P.V product, where the JAX jnp path casts them
to the cache's dtype first, so in bf16 the two differ by bf16
rounding; in fp32 they agree.

A request's cache is dense and padded, as in the JAX package's serving
engine: ``attn_decode`` writes the new key and value at ``pos`` *in
place* (the JAX package updates functionally and donates the buffer)
and reads the cache as contiguous pages of ``page_size`` slots through
an identity block table, with ``seq_len = pos + 1``.  The cache's slot
count must be a multiple of ``page_size``; slots past ``pos`` are
masked by the length.  With a sliding window (``cfg.sliding_window``)
prefill and decode see each query's last ``window`` keys, the JAX
package's mask ``kpos > pos - window``: the kernels take the window and
read no page wholly before it.

An int8 cache (``LM.cache_dtype = torch.int8``, the ``kv_int8``
variant) holds k and v quantized as the JAX package quantizes them,
``clip(round(x * KV_QSCALE), -127, 127)`` in fp32 (``torch.round``
rounds half to even, as ``jnp.round`` does).  q stays in the
activations' dtype, and the paged kernel reads the int8 pages and
dequantizes each key and value in registers (times ``1 / KV_QSCALE``,
exact in bf16 and fp32), so no dequantized copy is made.  The JAX
package dequantizes the whole cache to bf16 first and casts the softmax
weights to bf16; the kernel keeps them in fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import mha
from ..kernels.paged_attention import paged_mqa
from ..distributed.sharding import is_placed
from .common import (apply_rope, contiguous_meta, dense_init, local_heads,
                     merge_heads, row_matmul, split_heads)

Params = Dict[str, torch.Tensor]

PAGE_SIZE = 16  # default slots per page of a dense cache
KV_QSCALE = 32.0  # int8 KV-cache quantization scale (kv_int8 variant)


def quantize_kv(x: torch.Tensor) -> torch.Tensor:
    """x in int8 steps of 1 / KV_QSCALE: clip(round(x * KV_QSCALE),
    -127, 127), computed in fp32."""
    return torch.clamp(torch.round(x.float() * KV_QSCALE),
                       -127, 127).to(torch.int8)


def init_attn(gen: torch.Generator, cfg) -> Params:
    d, dh = cfg.d_model, cfg.head_dim
    h, hk = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, h * dh)),
        "wk": dense_init(gen, (d, hk * dh)),
        "wv": dense_init(gen, (d, hk * dh)),
        "wo": dense_init(gen, (h * dh, d)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", hk * dh), ("bv", hk * dh)):
            p[name] = torch.zeros(width, dtype=torch.float32,
                                  device=gen.device)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dh = cfg.head_dim
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:  # fp32 biases cast to the activations' dtype
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = split_heads(q, cfg.n_heads, dh)
    k = split_heads(k, cfg.n_kv_heads, dh)
    v = split_heads(v, cfg.n_kv_heads, dh)
    return q, k, v


def attn_forward(p: Params, x: torch.Tensor, cfg, *,
                 positions: Optional[torch.Tensor] = None,
                 causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (a training step's): causal, with the
    config's sliding window, or bidirectional; differentiable through
    ``mha``, whose backward runs the flash-attention backward kernel.
    x: [B, T, D]; returns [B, T, D]."""
    T = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _mha(q, k, v, causal=causal,
               window=cfg.sliding_window if causal else None)
    return row_matmul(merge_heads(out), p["wo"])


_BHD = (0, 2)  # [B, T, H, dh]: the batch and the heads


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, window: Optional[int]) -> torch.Tensor:
    """``mha`` on each device's batch and heads (``local_heads``)."""
    return local_heads(lambda q, k, v: mha(q, k, v, causal=causal,
                                           window=window),
                       (q, k, v), (_BHD,) * 3, (_BHD,))


def attn_prefill(p: Params, x: torch.Tensor, cfg
                 ) -> Tuple[torch.Tensor, Params]:
    """Prefill: causal attention over the prompt (``mha``), and this
    layer's KV cache ({"k", "v"}: [B, T, Hk, dh], after RoPE)."""
    T = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    positions = torch.arange(T, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _mha(q, k, v, causal=True, window=cfg.sliding_window)
    y = row_matmul(merge_heads(out), p["wo"])
    return y, {"k": k, "v": v}


def identity_pages(batch: int, slots: int, page_size: int,
                   device) -> torch.Tensor:
    """The block table that reads each sequence's dense cache of
    ``slots`` slots as its own contiguous pages: [batch, slots /
    page_size] int32, row b holding b * (slots / page_size) + i."""
    if slots % page_size:
        raise ValueError(f"a cache of {slots} slots is not a whole number "
                         f"of {page_size}-slot pages")
    n = slots // page_size
    return torch.arange(batch * n, dtype=torch.int32,
                        device=device).reshape(batch, n)


def attn_decode(p: Params, x: torch.Tensor, cache: Params, cfg, *,
                pos: torch.Tensor, page_size: int = PAGE_SIZE,
                block_table: Optional[torch.Tensor] = None,
                seq_lens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x: [B, 1, D]; cache k/v: [B, S, Hk, dh] with S
    a multiple of ``page_size``; pos: [B] int64 (the current absolute
    position; slots >= pos are not yet written).  Writes k/v at ``pos``
    in place and returns (y [B, 1, D], cache).  With a sliding window
    the keys at pos - window + 1 .. pos are live.  ``block_table`` and
    ``seq_lens`` (the identity table and pos + 1) may be passed in when
    every layer shares them.  An int8 cache takes the new k and v
    quantized (``quantize_kv``) and is read dequantized by the kernel."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    quant = cache["k"].dtype == torch.int8
    q_dtype = x.dtype if quant else cache["k"].dtype

    def store_and_attend(q, k_new, v_new, ck, cv, pos):
        """One device's share: its sequences and heads."""
        b, S, Hk, dh = ck.shape
        rows = torch.arange(b, device=q.device)
        store = quantize_kv if quant else (lambda t: t.to(ck.dtype))
        ck[rows, pos] = store(k_new[:, 0])
        cv[rows, pos] = store(v_new[:, 0])
        table, lens = block_table, seq_lens
        if table is None:
            table = identity_pages(b, S, page_size, q.device)
        if lens is None:
            lens = (pos + 1).to(torch.int32)
        return paged_mqa(q[:, 0].to(q_dtype).contiguous(),
                         ck.reshape(-1, page_size, Hk, dh),
                         cv.reshape(-1, page_size, Hk, dh), table, lens,
                         cfg.sliding_window,
                         kv_scale=1.0 / KV_QSCALE if quant else None)

    args = (q, k_new, v_new, cache["k"], cache["v"], pos)
    if is_placed(cache["k"]) and any(p.is_shard(1)
                                     for p in cache["k"].placements):
        out = _seq_sharded_decode(args, cfg, quant)
    else:
        out = local_heads(store_and_attend, args, (_BHD,) * 5 + ((0, None),),
                          ((0, 1),), in_place=(3, 4))
    y = row_matmul(out.to(x.dtype).reshape(B, 1, -1), p["wo"])
    return y, cache


def attend_slot_shard(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      lens: torch.Tensor, window: Optional[int], *,
                      page_size: int = PAGE_SIZE,
                      kv_scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot shard's share of a decode step's attention: q [b, H, dh]
    over the shard's cache ck, cv [b, S, Hk, dh] (S a multiple of
    ``page_size``) read as contiguous pages through an identity table,
    with ``lens`` [b] int32 the shard's own lengths, ``pos + 1 - off``
    for a shard whose first slot is absolute position ``off``: keys j <
    lens live, and with a ``window`` only j >= lens - window, which is
    the absolute ``kpos > pos - window``.  A length past S reads the
    whole shard (the window from the unclamped length), a length of 0 or
    less nothing.  Returns (out [b, H, dh] in q's dtype, lse [b, H]
    fp32), both from ``paged_mqa``: on the card the paged kernel, on the
    CPU its plain version."""
    b, S, Hk, dh = ck.shape
    table = identity_pages(b, S, page_size, q.device)
    return paged_mqa(q, ck.reshape(-1, page_size, Hk, dh),
                     cv.reshape(-1, page_size, Hk, dh), table, lens, window,
                     kv_scale=kv_scale, return_lse=True)


def merge_by_lse(out: torch.Tensor, lse: torch.Tensor, all_max: Callable,
                 all_sum: Callable) -> torch.Tensor:
    """Merge attention over disjoint parts of the keys (slot shards) by
    their log-sum-exps, as flash decoding merges its splits: ``out``
    [..., dh] each part's normalised output, ``lse`` [...] its fp32
    log-sum-exp (-inf where it has no live key); ``all_max`` and
    ``all_sum`` reduce a tensor over the parts (all-reduces over the
    slots' mesh dimensions, or a max and a sum over a stacked axis kept
    as size 1).  Returns sum_p e^(lse_p - M) out_p / sum_p e^(lse_p - M)
    in fp32, M the largest lse_p: zeros where no part has a live key."""
    m = all_max(lse).clamp_min(-1e30)  # -inf - (-1e30) = -inf: weight 0
    w = torch.exp(lse - m)[..., None]
    nd = all_sum(torch.cat([w * out.float(), w], dim=-1))
    return nd[..., :-1] / nd[..., -1:].clamp_min(1e-30)


def _seq_sharded_decode(args, cfg, quant: bool) -> torch.Tensor:
    """The decode attention over a cache whose slots are sharded (the
    ``long_500k`` cells' sequence parallelism, the slots over the data
    axes and the kv heads over "model"; the ``kv_seqshard`` variant's,
    the slots over "model"), each device on its slots (``local_map``):
    the new key and value written by the device that holds slot ``pos``,
    the device's slots attended through ``paged_mqa`` with its own
    lengths (``attend_slot_shard``), then the shards merged by their
    log-sum-exps over the slots' mesh dimensions (``merge_by_lse``), as
    flash decoding merges splits.  Returns [B, H, dh] in fp32."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    q, k_new, v_new, ck, cv, pos = args
    mesh = ck.device_mesh
    pl = ck.placements
    seq = [i for i, p in enumerate(pl) if p == Shard(1)]

    def like(p, heads):  # a [B, ..., H, ...] tensor's placement on a dim
        return (p if p == Shard(0) else Shard(heads) if p == Shard(2)
                else Replicate())

    bhd = tuple(like(p, 2) for p in pl)
    batch = tuple(like(p, None) if p != Shard(2) else Replicate()
                  for p in pl)

    def over_slots(t, op):
        for i in seq:
            t = funcol.all_reduce(t, op, (mesh, i))
        return t

    def attend(q, k_new, v_new, ck, cv, pos):
        b, S = ck.shape[:2]
        shard = 0
        for i in seq:
            shard = shard * mesh.size(i) + mesh.get_local_rank(i)
        off = shard * S
        rows = torch.arange(b, device=q.device)
        slot = (pos - off).clamp(0, S - 1)
        mine = ((pos >= off) & (pos < off + S))[:, None, None]
        store = quantize_kv if quant else (lambda t: t.to(ck.dtype))
        for c, new in ((ck, k_new), (cv, v_new)):
            c[rows, slot] = torch.where(mine, store(new[:, 0]), c[rows, slot])
        q_dtype = q.dtype if quant else ck.dtype
        out, lse = attend_slot_shard(
            q[:, 0].to(q_dtype).contiguous(), ck, cv,
            (pos + 1 - off).to(torch.int32), cfg.sliding_window,
            kv_scale=1.0 / KV_QSCALE if quant else None)
        return merge_by_lse(out, lse, lambda t: over_slots(t, "max"),
                            lambda t: over_slots(t, "sum"))

    out_pl = tuple(Shard(1) if p == Shard(2) else p for p in bhd)
    return contiguous_meta(local_map(
        attend, out_placements=list(out_pl),
        in_placements=(bhd, bhd, bhd, pl, pl, batch), device_mesh=mesh,
        redistribute_inputs=True)(*args))


def init_cross_attn(gen: torch.Generator, cfg) -> Params:
    return init_attn(gen, cfg)


def cross_attn_forward(p: Params, x: torch.Tensor, enc: torch.Tensor,
                       cfg) -> torch.Tensor:
    """Decoder-to-encoder cross attention (Whisper): q from x [B, T, D],
    k and v from the encoder's output enc [B, S, D]; no RoPE, no mask and
    no biases, as in the JAX package.  Runs on the flash-attention
    kernel (``mha``, not causal), differentiable in x and enc; at decode
    T = 1 and k, v are projected from ``enc`` anew each step, as the JAX
    package does.  Returns [B, T, D]."""
    dh = cfg.head_dim
    q = split_heads(torch.matmul(x, p["wq"]), cfg.n_heads, dh)
    k = split_heads(torch.matmul(enc, p["wk"]), cfg.n_kv_heads, dh)
    v = split_heads(torch.matmul(enc, p["wv"]), cfg.n_kv_heads, dh)
    out = _mha(q, k, v, causal=False, window=None)
    return row_matmul(merge_heads(out), p["wo"])


__all__ = ["KV_QSCALE", "PAGE_SIZE", "attend_slot_shard", "attn_decode",
           "attn_forward", "attn_prefill", "cross_attn_forward",
           "identity_pages", "init_attn", "init_cross_attn", "merge_by_lse",
           "quantize_kv"]
