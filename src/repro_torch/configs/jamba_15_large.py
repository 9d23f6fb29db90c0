"""Jamba-1.5-Large (398B) [arXiv:2403.19887; hf] — hybrid Mamba+attention
1:7 interleave (1 attention layer per 8), MoE 16 experts top-2 every
other layer.  Sub-quadratic: runs the long_500k shape."""
from .base import ArchConfig, MambaCfg, MoECfg, register_arch

CONFIG = register_arch(ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    moe=MoECfg(n_experts=16, top_k=2, d_expert=24576, every=2),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
    attn_every=8, supports_long_context=True,
    source="arXiv:2403.19887",
))
