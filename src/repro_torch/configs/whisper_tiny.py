"""Whisper-tiny [arXiv:2212.04356] — encoder-decoder; the conv audio
frontend is a STUB (input_specs feeds precomputed frame embeddings, per
the assignment: the transformer BACKBONE only).  LayerNorm + GELU."""
from .base import ArchConfig, EncDecCfg, register_arch

CONFIG = register_arch(ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, mlp="gelu", norm="layernorm",
    encdec=EncDecCfg(n_enc_layers=4, n_audio_frames=1500),
    source="arXiv:2212.04356",
))
