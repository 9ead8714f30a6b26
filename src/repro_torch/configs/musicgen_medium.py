"""MusicGen-medium decoder backbone over EnCodec tokens [arXiv:2306.05284].

4 codebooks of 2048 entries; embeddings are summed across codebooks and the
model has 4 output heads (delay-pattern handling lives in the data layer).
Frontend (EnCodec) is a stub per the assignment: inputs are token grids.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,          # MHA
    d_ff=6144,
    vocab_size=2048,
    n_codebooks=4,
    rope_theta=10_000.0,
)
