"""DeepSeekMoE-16B — fine-grained MoE [arXiv:2401.06066; hf].

28L, d_model=2048, 16 heads (kv=16), vocab=102400.  2 shared + 64 routed
experts, top-6, expert hidden 1408; first layer uses a dense FFN (10944).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_moe_16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400, head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_k_dense=1,
    source="arXiv:2401.06066; hf",
)
