"""Granite-8B (code): llama-architecture dense GQA decoder [arXiv:2405.04324]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49_152,
    rope_theta=10_000_000.0,
)
