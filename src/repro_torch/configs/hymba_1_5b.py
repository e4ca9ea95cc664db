"""Hymba-1.5B — hybrid parallel attention+Mamba heads [arXiv:2411.13676; hf].

32L, d_model=1600, 25 heads (GQA kv=5), d_ff=5504, vocab=32001, ssm_state=16.
Sliding-window attention (most layers in the paper use SWA-1024; we use SWA
everywhere — meta-tokens and the 3 global-attention layers are omitted, see
DESIGN.md §Arch-applicability) keeps it sub-quadratic, so long_500k runs.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba_1_5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_expand=2, ssm_headdim=50,   # d_inner=3200 -> 64 SSM heads
    sliding_window=1024,
    source="arXiv:2411.13676; hf",
)
