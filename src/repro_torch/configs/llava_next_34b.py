"""LLaVA-NeXT 34B backbone (Yi-34B style decoder) [hf:llava-hf/llava-v1.6].

The anyres vision tower is a stub: ``input_specs`` provides precomputed patch
embeddings (B, 576, d_model) prepended to the token embeddings."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    n_prefix=576,
    rope_theta=5_000_000.0,
)
