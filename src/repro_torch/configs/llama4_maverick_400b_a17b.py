"""Llama-4 Maverick 400B-A17B — MoE top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L, d_model=5120, 40 heads (GQA kv=8), vocab=202048.  128 routed experts
top-1 + 1 shared expert, expert hidden 8192; MoE on alternating layers
(interleave=2) which lands total params ~400B with ~17B active.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4_maverick_400b_a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    n_experts=128, n_shared_experts=1, top_k=1, moe_d_ff=8192,
    first_k_dense=0, moe_interleave=2,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
