"""Phi-3-mini 3.8B: RoPE + SwiGLU decoder; GQA degenerate (kv == heads = MHA)
[arXiv:2404.14219]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    rope_theta=10_000.0,
)
