"""CodeQwen1.5-7B — Qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B; hf].
Dense, GQA kv=32 (MHA-equal), QKV bias like Qwen1.5, SwiGLU."""
from .base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, qkv_bias=True, rope_theta=1_000_000.0,
    source="hf:Qwen/CodeQwen1.5-7B",
))
