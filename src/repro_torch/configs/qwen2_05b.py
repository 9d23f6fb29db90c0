"""Qwen2-0.5B [arXiv:2407.10671; hf] — dense, GQA kv=2, QKV bias,
tied embeddings (0.5B class ties lm_head)."""
from .base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671",
))
