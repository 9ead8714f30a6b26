"""Qwen3-235B-A22B: 128-expert top-8 MoE every layer, GQA + qk_norm
[hf:Qwen/Qwen3-30B-A3B scaled per assignment]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,                # every layer is MoE
    vocab_size=151_936,
    qk_norm=True,
    n_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    moe_period=1,
    rope_theta=1_000_000.0,
)
