"""Model assembly: the port of ``repro.models.model``'s ``LM`` for every
configuration of the registry: the dense family (every layer attention
+ MLP: Qwen2, CodeQwen1.5, MiniCPM, StarCoder2), the MoE family (every
layer attention + MoE: Mixtral; DeepSeek-MoE with a dense MLP in layer
0 and shared experts beside the routed ones), RWKV6 (every layer RWKV
time mix + channel mix), the hybrid family (Jamba: superblocks of
``attn_every`` sublayers, Mamba mixers around one attention mixer in
the middle, MoE on every ``moe.every``-th sublayer and a dense MLP on
the others), the encoder-decoder Whisper (an encoder of non-causal
attention + MLP blocks over precomputed frame embeddings; decoder
layers of causal self-attention, cross attention to the encoder's
output and an MLP) and the VLM InternVL (a projector from precomputed
patch embeddings into the decoder's width, the patches put before the
text).  Attention may have a sliding window (StarCoder2, Mixtral).  A
Python loop over layers takes the place of ``lax.scan``.

``group_plan`` gives the layers' groups as the JAX package makes them:
a group is a pattern of (mixer, ffn) pairs repeated some number of
times.  Most configurations have one group ``blocks`` whose pattern is
one layer (one superblock for the hybrid); DeepSeek-MoE has ``dense0``
(layer 0, once) and then ``blocks`` (the MoE layer, ``n_layers - 1``
times); Whisper's decoder layer is ``("cross", "mlp")``, where
``layer_kinds`` says ``("attn", "mlp")``: the layers follow the plan.

Training (``forward`` and ``loss``) runs every family: attention
(self, the encoder's and cross) through ``mha`` (the flash-attention
kernel and its backward), RWKV6's WKV through ``wkv6_heads`` and
Mamba's SSD through ``ssd_heads`` (each scan kernel and its backward).

``LM`` is an ``nn.Module`` holding its parameters under the JAX
package's names: ``embed``, ``final_norm.w``, ``lm_head`` (untied
only), and per layer ``layers.<l>.{ln1,<mixer>,ln2,<ffn>}.<name>``
with the mixer ``attn``, ``mamba`` or ``rwkv`` and the ffn ``ffn``
(dense MLP) or ``moe`` (RWKV6 keeps its channel mix in ``rwkv``); a MoE
layer's shared experts (the JAX package's nested ``moe.shared``) are
``layers.<l>.moe_shared.<name>``; a Whisper decoder layer also holds
``ln3`` and ``cross``.  Whisper's encoder is ``encoder.<e>.{ln1, attn,
ln2, ffn}.<name>`` and ``enc_norm``; InternVL's projector [d_vit,
d_model] is ``projector``.  The layers run group after group: pattern
position i of repeat r of a group whose first layer is l0 is layer
``l0 + r * P + i`` (``convert.lm_params_from_arrays`` carries the JAX
leaves across).  A batch holds ``tokens`` (and ``labels`` for the
loss), Whisper's ``frames`` [B, n_audio_frames, d_model] and
InternVL's ``patches`` [B, n_patches, d_vit].  Its serving surface is
the JAX package's without ``params``:

* ``prefill(batch, seq_len)``: forward over the batch, returning the
  last position's logits and the caches (InternVL's cover the patches'
  positions and the text's; the encoder's output is not cached);
* ``decode_step(token, caches, pos, *, enc=None)``: one token against
  the caches, written in place; Whisper's takes the encoder's output
  (``_encode``);
* ``init_caches(batch, seq_len)``: zeroed caches;

and its training surface:

* ``forward(batch)``: logits [B, T, V] over the text positions and the
  MoE layers' summed aux loss;
* ``loss(batch)``: ``softmax_xent`` of the logits against
  ``batch["labels"]`` plus 0.01 times the aux loss.

Parameters are created frozen (``requires_grad=False``) for serving;
a trainer turns them on (``requires_grad_(True)``).  ``prefill`` and
``decode_step`` run under ``no_grad`` either way.

``remat`` is the JAX package's rematerialization policy
(``REMAT_POLICIES``), over the regions its ``_run_groups`` checkpoints
(``remat_regions``): one region a block of a group that runs once
(DeepSeek-MoE's ``dense0``), one a pattern period of a repeated group
(a layer; the hybrid's superblock).  ``"full"`` (the default, as the
JAX package's) keeps a region's inputs and recomputes its forward in
the backward (``torch.utils.checkpoint``, the kernels relaunched);
``"dots"`` keeps the outputs of the products without batch dimensions
(``mm``, ``addmm``) and recomputes the rest, as JAX's
``dots_with_no_batch_dims_saveable``; ``"none"`` keeps everything.
Regions run only under grad; Whisper's encoder and InternVL's projector
have none, as in the JAX package.  The policy changes memory and work,
not values: the loss and gradients are those of ``"none"``, bit for
bit.

Caches are the JAX package's layout: ``{<group>: {"l<i>": ...}}``, one
entry per group and pattern position (``{"dense0": {"l0": ...},
"blocks": {"l0": ...}}`` for DeepSeek-MoE), each leaf stacked on a
leading repeat axis when the group repeats more than once (as
``lax.scan`` stacks them).
Attention positions (Whisper's cross layers too: their self-attention)
hold ``{"k", "v"}`` [B, S, Hk, dh], Mamba positions ``{"ssm", "conv"}``
(ssm [B, H, dh, N] fp32, conv [B, d_conv - 1, d_in]), RWKV6 ``{"wkv",
"shift_tm", "shift_cm"}`` (wkv [B, H, dh, dh] fp32, the two token
shifts [B, D]).  Recurrent state has no token axis.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig, layer_kinds
from ..device import resolve_device
from . import attention as attn
from . import ffn as ffn_mod
from . import mamba as mamba_mod
from . import rwkv as rwkv_mod
from .common import (MetaGenerator, dense_init, is_placed, lookup, norm,
                     norm_params, placed_as, residual, softmax_xent)

Params = Dict[str, torch.Tensor]


def _frozen(params: Params) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


PORTED_KINDS = ({("attn", "mlp")}, {("attn", "moe")},
                {("attn", "mlp"), ("attn", "moe")}, {("rwkv", "channelmix")},
                {("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp")})


def check_ported(cfg: ArchConfig) -> None:
    """Raise for a configuration whose set of (mixer, ffn) layer kinds
    the port does not know.  Every configuration of the registry runs,
    and trains: every mixer has a backward kernel (attention, RWKV6's
    WKV and Mamba's SSD)."""
    if set(layer_kinds(cfg)) not in PORTED_KINDS:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) has layer kinds "
            f"{sorted(set(layer_kinds(cfg)))}, which the port does not "
            "run: it runs attention + MLP or MoE, RWKV6 and the Mamba + "
            "attention + MoE hybrid")


def takes_front_inputs(cfg: ArchConfig) -> bool:
    """True for Whisper and InternVL, whose batches hold ``frames`` or
    ``patches`` beside the tokens."""
    return cfg.encdec is not None or cfg.vision is not None


def group_plan(cfg: ArchConfig) -> List[Tuple[str, List[Tuple[str, str]],
                                              int]]:
    """(group name, [(mixer, ffn), ...] pattern, repeat), as the JAX
    package's ``group_plan`` gives it for the ported families."""
    kinds = layer_kinds(cfg)
    if cfg.family == "hybrid":
        block = cfg.attn_every  # one superblock: 7 mamba + 1 attn
        pattern = kinds[:block]
        assert kinds == pattern * (cfg.n_layers // block)
        return [("blocks", pattern, cfg.n_layers // block)]
    if cfg.moe is not None and kinds[0][1] != kinds[-1][1]:
        # DeepSeek-MoE: a dense layer 0, MoE elsewhere
        return [("dense0", [kinds[0]], 1),
                ("blocks", [kinds[-1]], cfg.n_layers - 1)]
    if cfg.encdec is not None:  # Whisper's decoder: self + cross
        return [("blocks", [("cross", "mlp")], cfg.n_layers)]
    return [("blocks", [kinds[0]], cfg.n_layers)]


def plan_kinds(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """Each layer's (mixer, ffn) in layer order, as ``group_plan`` runs
    them (``layer_kinds`` but for Whisper's ``"cross"`` mixer)."""
    return [kind for _, pattern, repeat in group_plan(cfg)
            for _ in range(repeat) for kind in pattern]


def layer_slots(cfg: ArchConfig) -> List[Tuple[str, str, Optional[int]]]:
    """Where each layer's cache lives: (group, ``l<i>``, repeat index, or
    None where the group runs once and its leaves are not stacked), in
    layer order."""
    return [(name, f"l{i}", r if repeat > 1 else None)
            for name, pattern, repeat in group_plan(cfg)
            for r in range(repeat) for i in range(len(pattern))]


def remat_regions(cfg: ArchConfig) -> List[Tuple[int, int]]:
    """The layers [start, stop) of each region the JAX package's
    ``_run_groups`` checkpoints, in order: one a layer of a group that
    runs once, one a repeat of a repeated group (its pattern's layers,
    consecutive in ``layer_slots``)."""
    def region(slot):
        group, pos, r = slot[1]
        return group, pos if r is None else r

    out = []
    for _, slots in itertools.groupby(enumerate(layer_slots(cfg)),
                                      key=region):
        layers = [layer for layer, _ in slots]
        out.append((layers[0], layers[-1] + 1))
    return out


REMAT_POLICIES = ("full", "dots", "none")
# the products JAX's ``dots_with_no_batch_dims_saveable`` keeps: a
# batched product (``bmm``, attention's einsums) is recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_saveable)


class Block(nn.Module):
    """One layer's parameters for its (mixer, ffn) pair: attention,
    Mamba or RWKV6 (whose channel mix lives in the same ``rwkv`` tree,
    as in the JAX package), or Whisper's ``"cross"`` (self-attention
    ``attn``, then ``ln3`` and the cross attention ``cross``); then a
    dense MLP or MoE."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig, mixer: str,
                 ffn: str):
        super().__init__()
        self.kind = (mixer, ffn)
        self.ln1 = _frozen(norm_params(cfg.d_model, cfg.norm, gen.device))
        if mixer == "rwkv":
            self.rwkv = _frozen(rwkv_mod.init_rwkv(gen, cfg))
        elif mixer == "mamba":
            self.mamba = _frozen(mamba_mod.init_mamba(gen, cfg))
        else:
            self.attn = _frozen(attn.init_attn(gen, cfg))
        if mixer == "cross":
            self.ln3 = _frozen(norm_params(cfg.d_model, cfg.norm,
                                           gen.device))
            self.cross = _frozen(attn.init_cross_attn(gen, cfg))
        self.ln2 = _frozen(norm_params(cfg.d_model, cfg.norm, gen.device))
        if ffn == "moe":
            moe = ffn_mod.init_moe(gen, cfg)
            shared = moe.pop("shared", None)
            self.moe = _frozen(moe)
            if shared is not None:  # a ParameterDict holds no nested dict
                self.moe_shared = _frozen(shared)
        elif ffn == "mlp":
            self.ffn = _frozen(ffn_mod.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                                cfg.mlp))


class LM(nn.Module):
    """Decoder LM (plus Whisper's encoder or InternVL's projector),
    initialised at random from ``seed`` with a ``torch.Generator`` on
    ``device`` (the card unless the caller passes ``device="cpu"``):
    weights bf16; norms, biases, RWKV's decay, bonus and mix vectors and
    Mamba's ``dt_bias``, ``A_log`` and ``D`` fp32, as the JAX package's
    ``init_params`` makes them.  ``device="meta"`` draws nothing: the
    parameters have their shapes and dtypes and no storage (the dry
    run's model, ``launch.steps.lower_cell``).

    ``cache_dtype`` is the attention caches' dtype: the activations'
    unless set, as the JAX package's ``LM.cache_dtype``; ``torch.int8``
    (the ``kv_int8`` variant) stores k and v quantized by
    ``attention.KV_QSCALE``.  Recurrent state (RWKV6's token shifts,
    Mamba's ``conv`` tail) stays in the activations' dtype, where the
    JAX package gives it the cache's dtype too and truncates it to int8
    (reference fault R9).

    ``remat``: one of ``REMAT_POLICIES`` (the module docstring)."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device=None,
                 remat: str = "full"):
        super().__init__()
        check_ported(cfg)
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat={remat!r}: the policies are "
                             f"{REMAT_POLICIES}")
        self.cfg = cfg
        self.remat = remat
        self.slots = layer_slots(cfg)
        self.regions = remat_regions(cfg)
        self._cache_dtype: Optional[torch.dtype] = None
        dev = resolve_device(device)
        if dev.type == "meta":
            gen = MetaGenerator()
        else:
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
        self.layers = nn.ModuleList(Block(gen, cfg, *kind)
                                    for kind in plan_kinds(cfg))
        if cfg.encdec is not None:
            self.encoder = nn.ModuleList(
                Block(gen, cfg, "attn", "mlp")
                for _ in range(cfg.encdec.n_enc_layers))
            self.enc_norm = _frozen(norm_params(cfg.d_model, cfg.norm, dev))
        if cfg.vision is not None:
            self.projector = nn.Parameter(
                dense_init(gen, (cfg.vision.d_vit, cfg.d_model)),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        """The activations' dtype: the embedding's."""
        return self.embed.dtype

    @property
    def cache_dtype(self) -> torch.dtype:
        """The attention caches' dtype (the activations' unless set)."""
        return self._cache_dtype or self.dtype

    @cache_dtype.setter
    def cache_dtype(self, dtype: Optional[torch.dtype]) -> None:
        self._cache_dtype = dtype

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = norm(x, self.final_norm, cfg.norm, cfg.norm_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        return torch.matmul(x, head)

    def _ffn(self, blk: Block, x: torch.Tensor) -> torch.Tensor:
        """The residual FFN half of a non-RWKV block (MoE's aux loss is
        a training term, dropped here as the JAX decode drops it)."""
        return self._ffn_aux(blk, x)[0]

    def _ffn_aux(self, blk: Block, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The residual FFN half and its aux loss (None for an MLP)."""
        cfg = self.cfg
        h2 = norm(x, blk.ln2, cfg.norm, cfg.norm_eps)
        if blk.kind[1] == "moe":
            p = dict(blk.moe)
            if hasattr(blk, "moe_shared"):
                p["shared"] = blk.moe_shared
            y, aux = ffn_mod.moe_forward(p, h2, cfg)
            return residual(x, y), aux
        return residual(x, ffn_mod.mlp_forward(blk.ffn, h2, cfg.mlp)), None

    def _cross(self, blk: Block, x: torch.Tensor,
               enc: Optional[torch.Tensor]) -> torch.Tensor:
        """A ``"cross"`` layer's residual cross attention to ``enc``
        under ``ln3`` (``x`` itself for any other layer)."""
        if blk.kind[0] != "cross":
            return x
        cfg = self.cfg
        h3 = norm(x, blk.ln3, cfg.norm, cfg.norm_eps)
        return residual(x, attn.cross_attn_forward(blk.cross, h3, enc, cfg))

    # ------------------------------------------------------------------
    # the front ends: Whisper's encoder, InternVL's projector
    # ------------------------------------------------------------------
    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over precomputed frame embeddings [B, S, D]
        (the conv front end is a stub, as in the JAX package), cast to
        the activations' dtype: non-causal attention blocks (RoPE at
        positions 0 .. S - 1, as ``attn_forward`` applies it) and MLPs,
        then ``enc_norm``.  Returns [B, S, D]."""
        cfg = self.cfg
        x = frames.to(self.device, self.dtype)
        for blk in self.encoder:
            h = norm(x, blk.ln1, cfg.norm, cfg.norm_eps)
            x = self._ffn(blk, residual(x, attn.attn_forward(
                blk.attn, h, cfg, causal=False)))
        return norm(x, self.enc_norm, cfg.norm, cfg.norm_eps)

    def _embed_inputs(self, batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the decoder's input [B, P + T, D], the encoder's output or
        None): the tokens' embeddings, after InternVL's projected
        patches [B, P, D]; Whisper's frames through ``_encode``."""
        cfg = self.cfg
        x = lookup(self.embed, batch["tokens"].to(self.device))
        enc = None
        if cfg.encdec is not None:
            enc = self._encode(batch["frames"])
        if cfg.vision is not None:
            vis = torch.matmul(batch["patches"].to(self.device, x.dtype),
                               self.projector)
            # placed, the projected patches come out sharded on D over
            # "model" (the projector's columns): given the text's
            # placements first, or the concatenation would take theirs
            # and the whole residual stream would run sharded on D
            x = torch.cat([placed_as(vis, x), x], dim=1)
        return x, enc

    # ------------------------------------------------------------------
    # training: full-sequence forward and the loss
    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]``: [B, T] int (and ``frames`` or
        ``patches``).  Returns (logits [B, T, V] in the activations'
        dtype, over the text positions only; the MoE layers' summed aux
        loss, a 0-d fp32 tensor), with ``_apply_block``'s full-sequence
        semantics: causal attention with the config's window (and, for
        Whisper, the cross attention) or a Mamba mixer (from a zero
        state), then the MLP or MoE; or RWKV6's time mix and then its
        channel mix under ``ln2``, with no FFN."""
        cfg = self.cfg
        x, enc = self._embed_inputs(batch)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for start, stop in self.regions:
            x, aux = self._run_region(start, stop, x, aux, enc)
        if cfg.vision is not None:  # only text positions give logits
            x = x[:, cfg.vision.n_patches:]
        return self._logits(x), aux

    def _run_region(self, start: int, stop: int, x: torch.Tensor,
                    aux: torch.Tensor, enc: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layers ``start`` to ``stop`` of ``forward`` under the remat
        policy: (x after them, ``aux`` plus their MoE aux losses)."""
        fn = functools.partial(self._region, start, stop)
        if self.remat == "none" or not torch.is_grad_enabled():
            return fn(x, aux, enc)
        context = {"context_fn": _DOTS_CONTEXT} if self.remat == "dots" \
            else {}
        # the model draws no random numbers: no RNG state to replay
        return checkpoint(fn, x, aux, enc, use_reentrant=False,
                          preserve_rng_state=False, **context)

    def _region(self, start: int, stop: int, x: torch.Tensor,
                aux: torch.Tensor, enc: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for blk in self.layers[start:stop]:
            x, a = self._forward_layer(blk, x, enc)
            if a is not None:
                aux = aux + a
        return x, aux

    def _forward_layer(self, blk: Block, x: torch.Tensor,
                       enc: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One layer of ``forward``: (x after the layer, its MoE aux loss
        or None)."""
        cfg = self.cfg
        h = norm(x, blk.ln1, cfg.norm, cfg.norm_eps)
        mixer = blk.kind[0]
        if mixer == "rwkv":
            x = residual(x, rwkv_mod.rwkv_forward(blk.rwkv, h, cfg))
            h2 = norm(x, blk.ln2, cfg.norm, cfg.norm_eps)
            return residual(x, rwkv_mod.channel_mix(blk.rwkv, h2)), None
        if mixer == "mamba":
            y = mamba_mod.mamba_forward(blk.mamba, h, cfg)
        else:
            y = attn.attn_forward(blk.attn, h, cfg)
        return self._ffn_aux(blk, self._cross(blk, residual(x, y), enc))

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean token cross-entropy against ``batch["labels"]`` plus 0.01
        times the aux loss (a 0-d fp32 tensor)."""
        logits, aux = self.forward(batch)
        labels = batch["labels"].to(self.device)
        return softmax_xent(logits, labels) + 0.01 * aux

    # ------------------------------------------------------------------
    # caches: one entry per group and pattern position, stacked over the
    # group's repeats
    # ------------------------------------------------------------------
    def _stack(self, per_layer: List[Params]) -> Params:
        """Layer l's cache leaves -> ``{<group>: {"l<i>": ...}}``."""
        at: Dict[Tuple[str, str], List[Params]] = {}
        for (group, pos, _), c in zip(self.slots, per_layer):
            at.setdefault((group, pos), []).append(c)
        caches: Params = {}
        for (group, pos), cs in at.items():
            caches.setdefault(group, {})[pos] = {
                name: torch.stack([c[name] for c in cs]) if len(cs) > 1
                else cs[0][name] for name in cs[0]}
        return caches

    def _layer_cache(self, caches: Params, layer: int) -> Params:
        group, pos, r = self.slots[layer]
        leaves = caches[group][pos]
        if r is None:
            return dict(leaves)
        return {name: t[r] for name, t in leaves.items()}

    def _store(self, caches: Params, layer: int, new: Params) -> None:
        """Write a layer's new recurrent state into ``caches``."""
        group, pos, r = self.slots[layer]
        leaves = caches[group][pos]
        for name, t in new.items():
            if r is None:
                leaves[name] = t
            else:
                leaves[name][r] = t

    def init_caches(self, batch: int, seq_len: int,
                    dtype: Optional[torch.dtype] = None) -> Params:
        """Zeroed caches: attention k and v [B, seq_len, Hk, dh] in
        ``dtype`` (``cache_dtype`` when None), recurrent state in the
        activations' dtype (fp32 where the JAX package keeps it so)."""
        cfg = self.cfg
        kv_dtype = dtype if dtype is not None else self.cache_dtype
        zeros: Dict[Tuple[str, str], Params] = {}  # one a pattern position
        for (group, pos, _), blk in zip(self.slots, self.layers):
            if (group, pos) in zeros:
                continue
            mixer = blk.kind[0]
            if mixer == "rwkv":
                c = rwkv_mod.init_rwkv_state(cfg, batch, self.dtype,
                                             self.device)
            elif mixer == "mamba":
                c = mamba_mod.init_mamba_state(cfg, batch, self.dtype,
                                               self.device)
            else:
                shape = (batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
                c = {"k": torch.zeros(shape, dtype=kv_dtype,
                                      device=self.device),
                     "v": torch.zeros(shape, dtype=kv_dtype,
                                      device=self.device)}
            zeros[group, pos] = c
        return self._stack([zeros[group, pos]
                            for group, pos, _ in self.slots])

    # ------------------------------------------------------------------
    # serving: prefill + one-token decode
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], seq_len: int
                ) -> Tuple[torch.Tensor, Params]:
        """Run the full prompt (``batch["tokens"]``: [B, T] int64, and
        ``frames`` or ``patches``), returning the last position's logits
        [B, V] and the caches (k, v [B, P + T, Hk, dh] in the activations'
        dtype, P = InternVL's patches or 0, or the recurrent state after
        the prompt).  Whisper's frames are encoded inside and the
        encoder's output is not kept: ``decode_step`` takes it."""
        cfg = self.cfg
        x, enc = self._embed_inputs(batch)
        per_layer = []
        for blk in self.layers:
            h = norm(x, blk.ln1, cfg.norm, cfg.norm_eps)
            mixer = blk.kind[0]
            if mixer == "rwkv":
                y, tm = rwkv_mod.rwkv_forward(blk.rwkv, h, cfg,
                                              return_state=True)
                x = residual(x, y)
                h2 = norm(x, blk.ln2, cfg.norm, cfg.norm_eps)
                x = residual(x, rwkv_mod.channel_mix(blk.rwkv, h2))
                per_layer.append({"wkv": tm["wkv"],
                                  "shift_tm": tm["shift"].to(x.dtype),
                                  "shift_cm": h2[:, -1].to(x.dtype)})
                continue
            if mixer == "mamba":
                y, cache = mamba_mod.mamba_forward(blk.mamba, h, cfg,
                                                   return_state=True)
            else:
                y, cache = attn.attn_prefill(blk.attn, h, cfg)
                cache = {k: v.to(x.dtype) for k, v in cache.items()}
            per_layer.append(cache)
            x = self._ffn(blk, self._cross(blk, residual(x, y), enc))
        return self._logits(x[:, -1]), self._stack(per_layer)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: Params,
                    pos: torch.Tensor, *,
                    enc: Optional[torch.Tensor] = None,
                    page_size: int = attn.PAGE_SIZE
                    ) -> Tuple[torch.Tensor, Params]:
        """token: [B] int64; pos: [B] int64 absolute positions (after
        InternVL's patches: its first decode position is P + T); caches
        as from ``init_caches`` (or a padded prefill) with a slot count
        that is a multiple of ``page_size``; ``enc``: Whisper's encoder
        output [B, S, D] (``_encode``), which its cross attention reads
        after the self-attention, and which a model with an encoder
        needs.  Writes each attention layer's new key and value in place
        and each recurrent layer's new state into ``caches``; returns
        (logits [B, V], caches).  A model without attention does not
        read ``pos`` or ``page_size``."""
        cfg = self.cfg
        if cfg.encdec is not None:
            if enc is None:
                raise ValueError(f"{cfg.name} decodes against its "
                                 "encoder's output: pass enc=_encode("
                                 "frames)")
            enc = enc.to(self.device, self.dtype)
        x = lookup(self.embed, token.to(self.device))[:, None]
        pos = pos.to(self.device, torch.int64)
        pages = None
        for layer, blk in enumerate(self.layers):
            cache = self._layer_cache(caches, layer)
            # every attention layer shares them (a placed cache's
            # layers make their shares' own)
            if pages is None and "k" in cache and not is_placed(cache["k"]):
                B, S = cache["k"].shape[:2]
                pages = (attn.identity_pages(B, S, page_size, self.device),
                         (pos + 1).to(torch.int32))
            x, state = self._decode_layer(blk, x, cache, pos, enc, pages,
                                          page_size)
            if state is not None:
                self._store(caches, layer, state)
        return self._logits(x)[:, 0], caches

    def _decode_layer(self, blk: Block, x: torch.Tensor, cache: Params,
                      pos: torch.Tensor, enc: Optional[torch.Tensor],
                      pages: Optional[Tuple[torch.Tensor, torch.Tensor]],
                      page_size: int = attn.PAGE_SIZE
                      ) -> Tuple[torch.Tensor, Optional[Params]]:
        """One layer of ``decode_step`` over its ``cache`` (an attention
        layer's k and v written in place at ``pos``; ``pages``: the block
        table and the lengths, or None to make them): (x after the layer,
        the recurrent layer's new state or None)."""
        cfg = self.cfg
        h = norm(x, blk.ln1, cfg.norm, cfg.norm_eps)
        mixer = blk.kind[0]
        if mixer == "rwkv":
            y, tm = rwkv_mod.rwkv_decode(blk.rwkv, h, cache, cfg)
            x = residual(x, y)
            h2 = norm(x, blk.ln2, cfg.norm, cfg.norm_eps)
            y2, shift_cm = rwkv_mod.channel_mix_decode(
                blk.rwkv, h2, cache["shift_cm"])
            return residual(x, y2), {**tm, "shift_cm": shift_cm}
        state = None
        if mixer == "mamba":
            y, state = mamba_mod.mamba_decode(blk.mamba, h, cache, cfg)
        else:
            table, lens = pages if pages is not None else (None, None)
            y, _ = attn.attn_decode(blk.attn, h, cache, cfg, pos=pos,
                                    page_size=page_size, block_table=table,
                                    seq_lens=lens)
        return self._ffn(blk, self._cross(blk, residual(x, y), enc)), state


def build_model(cfg: ArchConfig, *, seed: int = 0, device=None,
                remat: str = "full") -> LM:
    return LM(cfg, seed=seed, device=device, remat=remat)


__all__ = ["Block", "LM", "REMAT_POLICIES", "build_model", "check_ported",
           "group_plan", "layer_slots", "plan_kinds", "remat_regions"]
