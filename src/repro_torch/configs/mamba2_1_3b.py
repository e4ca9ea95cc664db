"""Mamba2-1.3B — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L, d_model=2048, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2*2048 = 4096, headdim 64 -> 64 SSD heads.  Sub-quadratic: runs
long_500k; decode state is constant-size (no KV growth).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_1_3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
