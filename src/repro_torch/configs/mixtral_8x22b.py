"""Mixtral-8x22B [arXiv:2401.04088; hf] — 8 experts top-2 per layer,
GQA kv=8, sliding-window attention."""
from .base import ArchConfig, MoECfg, register_arch

CONFIG = register_arch(ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, sliding_window=4096, rope_theta=1_000_000.0,
    moe=MoECfg(n_experts=8, top_k=2, d_expert=16384),
    source="arXiv:2401.04088",
))
