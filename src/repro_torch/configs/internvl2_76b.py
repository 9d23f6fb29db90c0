"""InternVL2-Llama3-76B [arXiv:2404.16821] — InternViT frontend is a
STUB (precomputed patch embeddings + projector); the LM backbone is the
Llama-3-70B-class decoder listed in the assignment."""
from .base import ArchConfig, VisionStubCfg, register_arch

CONFIG = register_arch(ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, rope_theta=500_000.0,
    vision=VisionStubCfg(n_patches=1025, d_vit=3200),
    source="arXiv:2404.16821",
))
