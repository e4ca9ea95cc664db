"""Qwen3-4B — dense GQA with qk_norm [hf:Qwen/Qwen3-8B; hf].

36L, d_model=2560, 32 heads (GQA kv=8), d_ff=9728, vocab=151936.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab_size=151936, head_dim=128, qk_norm=True,
    source="hf:Qwen/Qwen3-8B; hf",
)
