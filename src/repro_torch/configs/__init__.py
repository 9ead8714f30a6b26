"""Simulator configurations by name (the paper's cell A for now)."""
from __future__ import annotations

import importlib

from repro_torch.config import SimConfig


def get_sim_config(name: str = "agocs_cell_a") -> SimConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG
