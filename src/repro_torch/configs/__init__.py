"""Configurations by name: the ten LM architectures (copies of the
reference's modules, which are data) and the paper's cell A."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig, SimConfig

ARCH_IDS: List[str] = [
    "musicgen-medium",
    "mamba2-780m",
    "llava-next-34b",
    "qwen3-4b",
    "internlm2-20b",
    "phi3-mini-3.8b",
    "granite-8b",
    "qwen3-moe-235b-a22b",
    "qwen2-moe-a2.7b",
    "jamba-1.5-large-398b",
]

_MODULES = {
    "musicgen-medium": "musicgen_medium",
    "mamba2-780m": "mamba2_780m",
    "llava-next-34b": "llava_next_34b",
    "qwen3-4b": "qwen3_4b",
    "internlm2-20b": "internlm2_20b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "granite-8b": "granite_8b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch]}").CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def get_sim_config(name: str = "agocs_cell_a") -> SimConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full architecture to a CPU-testable size of the SAME family.

    Keeps the layer pattern (period) intact: one repeat of the pattern,
    narrow widths, few experts, tiny vocab.
    """
    period = len(cfg.layer_pattern())
    kv = min(cfg.n_kv_heads, 2)
    heads = max(kv, 4) if cfg.n_heads >= 4 else cfg.n_heads
    return dataclasses.replace(
        cfg,
        n_layers=period,
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_d_ff=64 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 2),
        shared_d_ff=64 if cfg.n_shared_experts else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        n_prefix=min(cfg.n_prefix, 8),
        dtype="float32",
        param_dtype="float32",
    )
