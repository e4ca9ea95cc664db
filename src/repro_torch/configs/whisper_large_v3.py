"""Whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356].

32 decoder layers (and 32 encoder layers), d_model=1280, 20 heads (MHA,
kv=20), d_ff=5120, vocab=51866.  The conv frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, 1500, 1280).  LayerNorm + GELU.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_large_v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866, head_dim=64,
    n_enc_layers=32, enc_seq=1500,
    frontend="audio_stub", frontend_seq=1500, frontend_dim=1280,
    norm="layernorm", mlp="gelu",
    source="arXiv:2212.04356; unverified",
)
