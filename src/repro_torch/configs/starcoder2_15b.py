"""StarCoder2-15B [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE,
GELU MLP (non-gated), LayerNorm, sliding window 4096."""
from .base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152, mlp="gelu", norm="layernorm",
    sliding_window=4096, rope_theta=100_000.0,
    source="arXiv:2402.19173",
))
