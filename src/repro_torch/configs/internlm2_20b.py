"""InternLM2-20B: dense GQA decoder [arXiv:2403.17297]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_544,
    rope_theta=1_000_000.0,
)
