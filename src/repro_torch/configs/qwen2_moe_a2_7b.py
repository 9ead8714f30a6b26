"""Qwen1.5/2-MoE-A2.7B: 60 routed experts top-4 + 4 shared experts, every layer
[hf:Qwen/Qwen1.5-MoE-A2.7B]. 60 experts don't divide a 16-way TP axis, so the
sharding layer uses per-expert ff tensor parallelism instead of EP (see
distributed/sharding.py)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=151_936,
    n_experts=60,
    moe_top_k=4,
    moe_d_ff=1408,
    n_shared_experts=4,
    shared_d_ff=1408,
    moe_period=1,
    rope_theta=1_000_000.0,
)
