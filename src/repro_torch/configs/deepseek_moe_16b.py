"""DeepSeekMoE-16B [arXiv:2401.06066; hf] — fine-grained MoE: 64 routed
experts top-6 + 2 shared experts (d_expert=1408); first layer dense."""
from .base import ArchConfig, MoECfg, register_arch

CONFIG = register_arch(ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    source="arXiv:2401.06066",
))
