"""Mamba2-780m: pure SSD (state-space duality) stack, attention-free
[arXiv:2405.21060]. No MLP (d_ff=0); blocks are norm + SSD mixer only."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=24,             # unused (attention-free) but kept for uniform API
    n_kv_heads=24,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_period=-1,         # no attention layers at all
    tie_embeddings=True,
)
