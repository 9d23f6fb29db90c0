"""MiniCPM-2B [arXiv:2404.06395; hf] — llama-like dense arch; its WSD
(warmup-stable-decay) schedule is wired in the JAX package's
optim.schedules."""
from .base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753,
    source="arXiv:2404.06395",
))
