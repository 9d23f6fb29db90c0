"""RWKV6-7B "Finch" [arXiv:2404.05892; hf] — attention-free, data-
dependent decay linear attention.  O(1)-state decode: runs long_500k."""
from .base import ArchConfig, RWKVCfg, register_arch

CONFIG = register_arch(ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab=65536,
    rwkv=RWKVCfg(head_dim=64, chunk=256),
    supports_long_context=True,
    source="arXiv:2404.05892",
))
