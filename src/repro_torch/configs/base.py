"""Model/arch configuration system (the port's own copy).

A copy, field for field, of the JAX package's ``configs/base.py``: the port
imports nothing of that package, and ``tests/test_torch_models.py`` holds
the two copies equal.  One dataclass covers every architecture family
(dense / MoE / SSM / hybrid / enc-dec / VLM); per-arch modules under
``repro_torch/configs/`` fill in the published numbers.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    mlp: str = "swiglu"           # swiglu | gelu
    causal: bool = True

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0             # per-expert hidden (fine-grained MoE)
    first_k_dense: int = 0        # leading layers with dense FFN (deepseek)
    moe_interleave: int = 1       # MoE every k-th layer (llama4: 2)
    capacity_factor: float = 1.25

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (hymba): parallel attn+ssm heads ---
    sliding_window: int = 0       # 0 = full attention

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0              # encoder frames (stub frontend output)

    # --- modality frontend stubs ---
    frontend: Optional[str] = None  # None | audio_stub | vision_stub
    frontend_seq: int = 0           # patch/frame embeddings per sample
    frontend_dim: int = 0           # embedding width delivered by the stub

    # --- parallelism ---
    attn_shard: str = "auto"   # auto | heads | seq | replicated

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- citation ---
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded for 16-way tensor sharding (MaxText-style)."""
        return round_up(self.vocab_size, 256)

    @property
    def ssm_heads(self) -> int:
        return (self.d_model * self.ssm_expand) // self.ssm_headdim

    @property
    def d_inner(self) -> int:
        return self.d_model * self.ssm_expand

    def attention_layers(self) -> int:
        return 0 if self.family == "ssm" else self.n_layers

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d, L = self.d_model, self.n_layers
        hd, H, KV = self.head_dim_, self.n_heads, self.n_kv_heads
        n = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.family == "ssm":
            attn = 0
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = d * (2 * di + 2 * ns + nh) + di * d + 3 * nh
        if self.family == "moe":
            shared = self.n_shared_experts * 3 * d * self.moe_d_ff
            routed = self.n_experts * 3 * d * self.moe_d_ff
            router = d * self.n_experts
            dense_ff = 3 * d * self.d_ff
            n_moe, n_dense = self.moe_layer_split()
            n += n_moe * (attn + shared + routed + router)
            n += n_dense * (attn + dense_ff)
            return n
        ff = 3 * d * self.d_ff if self.mlp == "swiglu" else 2 * d * self.d_ff
        if self.family == "ssm":
            per_layer = ssm
        elif self.family == "hybrid":
            per_layer = attn + ssm + ff
        else:
            per_layer = attn + ff
        n += L * per_layer
        if self.n_enc_layers:
            n += self.n_enc_layers * (attn + ff)     # encoder stack
            n += self.n_layers * (attn := attn)      # cross-attn in decoder
            n += self.n_layers * (d * H * hd + 2 * d * KV * hd + H * hd * d)
        return n

    def moe_layer_split(self) -> Tuple[int, int]:
        """(n_moe_layers, n_dense_layers) after first_k_dense + interleave."""
        if self.family != "moe":
            return (0, self.n_layers)
        rest = self.n_layers - self.first_k_dense
        n_moe = rest // self.moe_interleave
        return (n_moe, self.n_layers - n_moe)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: shared + top_k routed)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd, H, KV = self.head_dim_, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        n = 2 * self.padded_vocab * d
        active_ff = (self.n_shared_experts + self.top_k) * 3 * d * self.moe_d_ff
        n_moe, n_dense = self.moe_layer_split()
        n += n_moe * (attn + active_ff + d * self.n_experts)
        n += n_dense * (attn + 3 * d * self.d_ff)
        return n


def reduce_for_smoke(cfg: "ModelConfig") -> "ModelConfig":
    """Same family/structure, laptop-sized: few layers, narrow width, tiny
    vocab, few experts — used by the per-arch CPU smoke tests."""
    kw: Dict = dict(
        n_layers=max(2, cfg.moe_interleave * (2 if cfg.first_k_dense == 0 else 2) if cfg.family == "moe" else 2),
        d_model=64,
        d_ff=min(cfg.d_ff, 128) if cfg.d_ff else 0,
        vocab_size=256,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=16)
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=32,
                  first_k_dense=min(cfg.first_k_dense, 1),
                  n_layers=2 * cfg.moe_interleave + cfg.first_k_dense)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_headdim=8, ssm_state=8, ssm_chunk=8)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, enc_seq=24, frontend_seq=24, frontend_dim=64)
    if cfg.family == "vlm":
        kw.update(frontend_seq=8, frontend_dim=64)
    return dataclasses.replace(cfg, **kw)


ARCH_IDS = [
    "hymba_1_5b",
    "qwen2_7b",
    "llama3_2_1b",
    "qwen2_0_5b",
    "qwen3_4b",
    "mamba2_1_3b",
    "whisper_large_v3",
    "deepseek_moe_16b",
    "llama4_maverick_400b_a17b",
    "internvl2_26b",
]

# accept both dash and underscore spellings on the CLI
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-7b": "qwen2_7b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen3-4b": "qwen3_4b",
    "mamba2-1.3b": "mamba2_1_3b",
    "whisper-large-v3": "whisper_large_v3",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "internvl2-26b": "internvl2_26b",
})


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"{__package__}.{arch}")
    return mod.CONFIG


def registry() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
