"""Plain PyTorch version: per-node accumulation of per-task values."""
from __future__ import annotations

import torch


def segment_usage_ref(task_node: torch.Tensor, values: torch.Tensor,
                      mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """task_node (T,) i32 (may be -1), values (T,V) f32, mask (T,) bool
    -> (N, V) f32 sums over tasks placed on each node.

    Masked and unplaced rows go to an overflow row N that is sliced off.
    ``index_put_(accumulate=True)`` adds duplicates deterministically on
    both devices (CUDA sorts the indices first; no float atomics).
    """
    idx = torch.where(mask & (task_node >= 0), task_node.long(), n_nodes)
    out = torch.zeros((n_nodes + 1, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    out.index_put_((idx,), values.to(torch.float32), accumulate=True)
    return out[:n_nodes]
