"""Llama-3.2-1B — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].

16L, d_model=2048, 32 heads (GQA kv=8), d_ff=8192, vocab=128256.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3_2_1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=64,
    rope_theta=500_000.0, tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)
