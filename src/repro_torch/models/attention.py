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

from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import mha
from ..kernels.paged_attention import paged_mqa
from .common import apply_rope, dense_init

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
    B, T, _ = x.shape
    dh = cfg.head_dim
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:  # fp32 biases cast to the activations' dtype
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, T, cfg.n_heads, dh)
    k = k.reshape(B, T, cfg.n_kv_heads, dh)
    v = v.reshape(B, T, cfg.n_kv_heads, dh)
    return q, k, v


def attn_forward(p: Params, x: torch.Tensor, cfg, *,
                 positions: Optional[torch.Tensor] = None,
                 causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (a training step's): causal, with the
    config's sliding window, or bidirectional; differentiable through
    ``mha``, whose backward runs the flash-attention backward kernel.
    x: [B, T, D]; returns [B, T, D]."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = mha(q, k, v, causal=causal,
              window=cfg.sliding_window if causal else None)
    return torch.matmul(out.reshape(B, T, -1), p["wo"])


def attn_prefill(p: Params, x: torch.Tensor, cfg
                 ) -> Tuple[torch.Tensor, Params]:
    """Prefill: causal attention over the prompt (``mha``), and this
    layer's KV cache ({"k", "v"}: [B, T, Hk, dh], after RoPE)."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    positions = torch.arange(T, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = mha(q, k, v, causal=True, window=cfg.sliding_window)
    y = torch.matmul(out.reshape(B, T, -1), p["wo"])
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
    S, Hk, dh = cache["k"].shape[1:]
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    quant = cache["k"].dtype == torch.int8
    store = quantize_kv if quant else (lambda t: t.to(cache["k"].dtype))
    cache["k"][rows, pos] = store(k_new[:, 0])
    cache["v"][rows, pos] = store(v_new[:, 0])
    if block_table is None:
        block_table = identity_pages(B, S, page_size, x.device)
    if seq_lens is None:
        seq_lens = (pos + 1).to(torch.int32)
    pages_k = cache["k"].reshape(-1, page_size, Hk, dh)
    pages_v = cache["v"].reshape(-1, page_size, Hk, dh)
    q_dtype = x.dtype if quant else cache["k"].dtype
    out = paged_mqa(q[:, 0].to(q_dtype).contiguous(), pages_k, pages_v,
                    block_table, seq_lens, cfg.sliding_window,
                    kv_scale=1.0 / KV_QSCALE if quant else None)
    y = torch.matmul(out.to(x.dtype).reshape(B, 1, -1), p["wo"])
    return y, cache


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
    B, T, _ = x.shape
    S = enc.shape[1]
    dh = cfg.head_dim
    q = torch.matmul(x, p["wq"]).reshape(B, T, cfg.n_heads, dh)
    k = torch.matmul(enc, p["wk"]).reshape(B, S, cfg.n_kv_heads, dh)
    v = torch.matmul(enc, p["wv"]).reshape(B, S, cfg.n_kv_heads, dh)
    out = mha(q, k, v, causal=False)
    return torch.matmul(out.reshape(B, T, -1), p["wo"])


__all__ = ["KV_QSCALE", "PAGE_SIZE", "attn_decode", "attn_forward",
           "attn_prefill", "cross_attn_forward", "identity_pages",
           "init_attn", "init_cross_attn", "quantize_kv"]
