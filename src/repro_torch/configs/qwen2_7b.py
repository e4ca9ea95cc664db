"""Qwen2-7B — dense GQA with QKV bias [arXiv:2407.10671; hf].

28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab=152064.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128, qkv_bias=True,
    source="arXiv:2407.10671; hf",
)
