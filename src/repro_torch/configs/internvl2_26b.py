"""InternVL2-26B — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

48L, d_model=6144, 48 heads (GQA kv=8), d_ff=16384, vocab=92553.  The ViT
frontend is a STUB: input_specs() provides precomputed, projected patch
embeddings (B, 256, 6144) that are concatenated ahead of the text tokens.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553, head_dim=128,
    frontend="vision_stub", frontend_seq=256, frontend_dim=6144,
    source="arXiv:2404.16821; hf",
)
