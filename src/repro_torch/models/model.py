"""Model assembly: the port of ``repro.models.model``'s ``LM`` for the
dense family (every layer attention + MLP with full causal attention:
Qwen2, CodeQwen1.5, MiniCPM) and for RWKV6 (every layer RWKV time mix +
channel mix).  A Python loop over layers takes the place of
``lax.scan``.

``LM`` is an ``nn.Module`` holding its parameters under the JAX
package's names: ``embed``, ``final_norm.w``, ``lm_head`` (untied
only), and per layer ``layers.<i>.{ln1,attn,ln2,ffn}.<name>`` (dense)
or ``layers.<i>.{ln1,rwkv,ln2}.<name>`` (RWKV6) for the JAX package's
``blocks.l0.<...>`` leaf stacked on axis 0
(``convert.lm_params_from_arrays`` carries them across).  Its serving
surface is the JAX package's without ``params``:

* ``prefill(batch, seq_len)``: forward over ``batch["tokens"]``,
  returning the last position's logits and the caches;
* ``decode_step(token, caches, pos)``: one token against the caches,
  written in place;
* ``init_caches(batch, seq_len)``: zeroed caches.

Caches are the JAX package's layout: ``{"blocks": {"l0": {"k", "v"}}}``
with [L, B, S, Hk, dh] tensors for the dense family, and
``{"blocks": {"l0": {"wkv", "shift_tm", "shift_cm"}}}`` with wkv
[L, B, H, dh, dh] fp32 and the two token shifts [L, B, D] for RWKV6
(its state has no token axis; ``seq_len`` and ``page_size`` are taken
and ignored).  Other families (MoE, hybrid, encoder-decoder, VLM) and
configurations with a sliding window raise "not yet ported".
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig, layer_kinds
from ..device import resolve_device
from . import attention as attn
from . import ffn as ffn_mod
from . import rwkv as rwkv_mod
from .common import dense_init, norm, norm_params

Params = Dict[str, torch.Tensor]


def _frozen(params: Params) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


PORTED_KINDS = ({("attn", "mlp")}, {("rwkv", "channelmix")})


def check_ported(cfg: ArchConfig) -> None:
    """Raise for a configuration the port cannot run yet."""
    if set(layer_kinds(cfg)) not in PORTED_KINDS or any(
            getattr(cfg, f) is not None for f in ("encdec", "vision")):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not yet ported: the port runs "
            "dense attention + MLP models and RWKV6")
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is not yet ported")


class Block(nn.Module):
    """One layer's parameters: attention + MLP, or for RWKV6 the time
    and channel mix (one ``rwkv`` tree, as in the JAX package)."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        self.ln1 = _frozen(norm_params(cfg.d_model, cfg.norm, gen.device))
        if cfg.rwkv is not None:
            self.rwkv = _frozen(rwkv_mod.init_rwkv(gen, cfg))
        else:
            self.attn = _frozen(attn.init_attn(gen, cfg))
        self.ln2 = _frozen(norm_params(cfg.d_model, cfg.norm, gen.device))
        if cfg.rwkv is None:
            self.ffn = _frozen(ffn_mod.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                                cfg.mlp))


class LM(nn.Module):
    """Decoder LM for the dense family and RWKV6, initialised at random
    from ``seed`` with a ``torch.Generator`` on ``device`` (the card
    unless the caller passes ``device="cpu"``): weights bf16, norms,
    biases and RWKV's decay, bonus and mix vectors fp32, as the JAX
    package's ``init_params`` makes them."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.embed = nn.Parameter(
            dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02),
            requires_grad=False)
        self.final_norm = _frozen(norm_params(cfg.d_model, cfg.norm, dev))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                dense_init(gen, (cfg.d_model, cfg.vocab)),
                requires_grad=False)
        self.layers = nn.ModuleList(Block(gen, cfg)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        """The activations' dtype: the embedding's."""
        return self.embed.dtype

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = norm(x, self.final_norm, cfg.norm, cfg.norm_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        return torch.matmul(x, head)

    def _mlp(self, blk: Block, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h2 = norm(x, blk.ln2, cfg.norm, cfg.norm_eps)
        return x + ffn_mod.mlp_forward(blk.ffn, h2, cfg.mlp)

    # ------------------------------------------------------------------
    # serving: prefill + one-token decode
    # ------------------------------------------------------------------
    def init_caches(self, batch: int, seq_len: int,
                    dtype: Optional[torch.dtype] = None) -> Params:
        cfg = self.cfg
        dtype = dtype if dtype is not None else self.dtype
        if cfg.rwkv is not None:
            state = rwkv_mod.init_rwkv_state(cfg, batch, dtype, self.device)
            return {"blocks": {"l0": {
                name: t.expand(cfg.n_layers, *t.shape).contiguous()
                for name, t in state.items()}}}
        shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
        return {"blocks": {"l0": {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device)}}}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], seq_len: int
                ) -> Tuple[torch.Tensor, Params]:
        """Run the full prompt (``batch["tokens"]``: [B, T] int64),
        returning the last position's logits [B, V] and the caches
        (k, v [L, B, T, Hk, dh] in the activations' dtype, or the RWKV6
        state after the prompt)."""
        cfg = self.cfg
        x = self.embed[batch["tokens"].to(self.device)]
        if cfg.rwkv is not None:
            return self._prefill_rwkv(x)
        ks, vs = [], []
        for blk in self.layers:
            h = norm(x, blk.ln1, cfg.norm, cfg.norm_eps)
            y, cache = attn.attn_prefill(blk.attn, h, cfg)
            ks.append(cache["k"].to(x.dtype))
            vs.append(cache["v"].to(x.dtype))
            x = self._mlp(blk, x + y)
        logits = self._logits(x[:, -1])
        return logits, {"blocks": {"l0": {"k": torch.stack(ks),
                                          "v": torch.stack(vs)}}}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: Params,
                    pos: torch.Tensor, *,
                    page_size: int = attn.PAGE_SIZE
                    ) -> Tuple[torch.Tensor, Params]:
        """token: [B] int64; pos: [B] int64 absolute positions; caches as
        from ``init_caches`` (or a padded prefill) with a slot count that
        is a multiple of ``page_size``.  Writes each layer's new key and
        value in place; returns (logits [B, V], caches).  For RWKV6 the
        state advances in place and ``pos`` and ``page_size`` are not
        read."""
        cfg = self.cfg
        token = token.to(self.device)
        x = self.embed[token][:, None]
        if cfg.rwkv is not None:
            return self._decode_rwkv(x, caches)
        group = caches["blocks"]["l0"]
        pos = pos.to(self.device, torch.int64)
        B, S = group["k"].shape[1:3]
        table = attn.identity_pages(B, S, page_size, self.device)
        lens = (pos + 1).to(torch.int32)
        for i, blk in enumerate(self.layers):
            h = norm(x, blk.ln1, cfg.norm, cfg.norm_eps)
            y, _ = attn.attn_decode(
                blk.attn, h, {"k": group["k"][i], "v": group["v"][i]}, cfg,
                pos=pos, page_size=page_size, block_table=table,
                seq_lens=lens)
            x = self._mlp(blk, x + y)
        return self._logits(x)[:, 0], caches

    # ------------------------------------------------------------------
    # RWKV6: the state carried from prefill into decode
    # ------------------------------------------------------------------
    def _prefill_rwkv(self, x: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        cfg = self.cfg
        states = {"wkv": [], "shift_tm": [], "shift_cm": []}
        for blk in self.layers:
            h = norm(x, blk.ln1, cfg.norm, cfg.norm_eps)
            y, tm = rwkv_mod.rwkv_forward(blk.rwkv, h, cfg,
                                          return_state=True)
            x = x + y
            h2 = norm(x, blk.ln2, cfg.norm, cfg.norm_eps)
            x = x + rwkv_mod.channel_mix(blk.rwkv, h2)
            states["wkv"].append(tm["wkv"])
            states["shift_tm"].append(tm["shift"].to(x.dtype))
            states["shift_cm"].append(h2[:, -1].to(x.dtype))
        logits = self._logits(x[:, -1])
        return logits, {"blocks": {"l0": {
            name: torch.stack(ts) for name, ts in states.items()}}}

    def _decode_rwkv(self, x: torch.Tensor, caches: Params
                     ) -> Tuple[torch.Tensor, Params]:
        """One token through every layer from the carried state: the
        WKV kernel at T = 1 per layer; the new state is written into
        ``caches`` in place."""
        cfg = self.cfg
        group = caches["blocks"]["l0"]
        for i, blk in enumerate(self.layers):
            h = norm(x, blk.ln1, cfg.norm, cfg.norm_eps)
            y, tm = rwkv_mod.rwkv_decode(
                blk.rwkv, h, {"wkv": group["wkv"][i],
                              "shift_tm": group["shift_tm"][i]}, cfg)
            x = x + y
            h2 = norm(x, blk.ln2, cfg.norm, cfg.norm_eps)
            y2, shift_cm = rwkv_mod.channel_mix_decode(
                blk.rwkv, h2, group["shift_cm"][i])
            x = x + y2
            group["wkv"][i] = tm["wkv"]
            group["shift_tm"][i] = tm["shift_tm"]
            group["shift_cm"][i] = shift_cm
        return self._logits(x)[:, 0], caches


def build_model(cfg: ArchConfig, *, seed: int = 0, device=None) -> LM:
    return LM(cfg, seed=seed, device=device)


__all__ = ["Block", "LM", "build_model", "check_ported"]
