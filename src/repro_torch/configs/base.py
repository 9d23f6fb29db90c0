"""Architecture config system: one config per assigned architecture.

Every config is an exact public configuration (sources cited in each
file).  ``reduced()`` derives the same-family small config used by the
CPU tests; the full config is what ``launch.serve`` runs on the card.

The port's copy of ``repro.configs.base``, field for field: data only,
so the port's models and the JAX package's build the same shapes from
the same name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    n_shared: int = 0  # always-on shared experts (deepseek-moe)
    every: int = 1  # MoE every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    impl: str = "gshard"  # gshard (one-hot einsums) | sorted (§Perf)


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # SSD multi-head decay (TPU adaptation)
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    n_enc_layers: int = 4
    n_audio_frames: int = 1500  # whisper 30s @ 50Hz after conv stub


@dataclasses.dataclass(frozen=True)
class VisionStubCfg:
    n_patches: int = 1025  # ViT-448px/14 + cls, InternViT stub
    d_vit: int = 3200  # InternViT-6B width


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | gelu
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaCfg] = None
    attn_every: int = 1  # hybrid: 1 attention layer per k layers (jamba: 8)
    rwkv: Optional[RWKVCfg] = None
    encdec: Optional[EncDecCfg] = None
    vision: Optional[VisionStubCfg] = None
    # which inference shapes are valid (sub-quadratic archs run long_500k)
    supports_long_context: bool = False
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        changes: Dict = dict(
            n_layers=min(self.n_layers, 2 if self.attn_every == 1 else self.attn_every),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads * 4 // self.n_heads, 4)),
            d_ff=256,
            vocab=512,
            d_head=32,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
        )
        if self.moe:
            # capacity 8.0: smoke tests check plumbing equivalence, which
            # must be drop-free under an untrained router; the production
            # capacity factor is exercised by test_moe_capacity_bounds
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), d_expert=64,
                n_shared=min(self.moe.n_shared, 1), capacity_factor=8.0)
        if self.mamba:
            changes["mamba"] = dataclasses.replace(
                self.mamba, d_state=8, head_dim=32, chunk=16)
        if self.rwkv:
            changes["rwkv"] = dataclasses.replace(self.rwkv, head_dim=32, chunk=16)
        if self.encdec:
            changes["encdec"] = dataclasses.replace(
                self.encdec, n_enc_layers=2, n_audio_frames=32)
        if self.vision:
            changes["vision"] = dataclasses.replace(
                self.vision, n_patches=16, d_vit=64)
        return dataclasses.replace(self, **changes)


def _param_count(c: ArchConfig, active_only: bool) -> int:
    d = c.d_model
    n = 0
    n += c.vocab * d  # embed
    if not c.tie_embeddings:
        n += d * c.vocab  # head
    dh = c.head_dim

    def attn_params() -> int:
        p = d * (c.n_heads * dh) + 2 * d * (c.n_kv_heads * dh) \
            + (c.n_heads * dh) * d
        if c.qkv_bias:
            p += (c.n_heads + 2 * c.n_kv_heads) * dh
        return p + d  # + norm

    def mlp_params(d_ff: int) -> int:
        mats = 3 if c.mlp == "swiglu" else 2
        return mats * d * d_ff + d

    def moe_params(active: bool) -> int:
        m = c.moe
        routed = m.top_k if active else m.n_experts
        p = d * m.n_experts  # router
        mats = 3 if c.mlp == "swiglu" else 2
        p += routed * mats * d * m.d_expert
        p += m.n_shared * mats * d * m.d_expert
        return p + d

    def mamba_params() -> int:
        m = c.mamba
        d_in = m.expand * d
        heads = d_in // m.head_dim
        p = d * 2 * d_in  # in_proj (x, z)
        p += d_in * m.d_conv  # conv
        p += d_in * (2 * m.d_state + heads)  # B, C, dt per head (fused proj)
        p += heads + d_in  # A (per head), D skip
        p += d_in * d  # out_proj
        return p + d

    def rwkv_params() -> int:
        # time mix: r,k,v,o,decay mats + bonus/bias/mu vectors
        p = 5 * d * d + 8 * d
        p += d * c.d_ff + c.d_ff * d + d * d + 2 * d  # channel mix k,v,r,mu
        return p + 2 * d

    for mixer, ffn in layer_kinds(c):
        if mixer == "rwkv":
            n += rwkv_params()
            continue
        n += mamba_params() if mixer == "mamba" else attn_params()
        n += moe_params(active_only) if ffn == "moe" else mlp_params(c.d_ff)
    if c.encdec:
        # encoder blocks + cross-attention in decoder
        enc = c.encdec.n_enc_layers * (attn_params() + mlp_params(c.d_ff))
        cross = c.n_layers * attn_params()
        n += enc + cross
    if c.vision:
        n += c.vision.d_vit * d  # projector stub
    return n


def layer_kinds(c: ArchConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) per layer.  Encodes each family's interleave:
    jamba = 1 attn per ``attn_every`` layers (middle of the block) with
    MoE on every ``moe.every``-th layer; deepseek-moe = dense FFN in
    layer 0, fine-grained MoE elsewhere; rwkv = its own channel mix."""
    kinds: List[Tuple[str, str]] = []
    for layer in range(c.n_layers):
        if c.rwkv:
            kinds.append(("rwkv", "channelmix"))
            continue
        if c.mamba and c.attn_every > 1:
            mixer = "attn" if layer % c.attn_every == c.attn_every // 2 \
                else "mamba"
        else:
            mixer = "attn"
        if c.moe is None:
            ffn = "mlp"
        elif c.name.startswith("deepseek"):
            ffn = "moe" if layer > 0 else "mlp"
        else:
            ffn = "moe" if layer % c.moe.every == c.moe.every - 1 else "mlp"
        kinds.append((mixer, ffn))
    return kinds


_REGISTRY: Dict[str, ArchConfig] = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> List[str]:
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all() -> None:
    from . import (codeqwen15_7b, qwen2_05b, minicpm_2b, starcoder2_15b,  # noqa
                   deepseek_moe_16b, mixtral_8x22b, jamba_15_large,
                   whisper_tiny, rwkv6_7b, internvl2_76b)


# ----------------------------------------------------------------------
# the four assigned input shapes (LM family)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 500k context is quadratic; "
                       "run only for SSM/hybrid (DESIGN.md §7)")
    return True, ""
