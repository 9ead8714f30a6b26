"""Jamba-1.5-Large 398B: hybrid Mamba+attention (1 attn per 8 layers, offset 4),
MoE (16 experts, top-2) on every other layer [arXiv:2403.19887].

Pattern period = lcm(8, 2) = 8:
  [mamba+dense, mamba+moe, mamba+dense, mamba+moe,
   attn+dense,  mamba+moe, mamba+dense, mamba+moe] x 9 repeats = 72 layers.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65_536,
    n_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    moe_period=2,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_period=8,
    attn_offset=4,
)
