"""Qwen2-0.5B — GQA with QKV bias [arXiv:2407.10671; hf].

24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151936.  This is the
paper's own motivating 'small tenant' (§2.2 cites Qwen2-0.5B).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_0_5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151936, head_dim=64, qkv_bias=True,
    tie_embeddings=True,
    source="arXiv:2407.10671; hf",
)
