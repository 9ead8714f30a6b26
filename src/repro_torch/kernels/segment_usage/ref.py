"""Plain PyTorch version: per-node accumulation of per-task values."""
from __future__ import annotations

import torch


def segment_usage_lanes_ref(task_node: torch.Tensor, values: torch.Tensor,
                            mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """task_node (B, T) i32 (may be -1), values (B, T, V) f32, mask (B, T)
    bool -> (B, N, V) f32 sums over the tasks placed on each node of each
    lane.

    Lane b's node n is row b * (N + 1) + n of one flat table; masked and
    unplaced rows go to each lane's overflow row N, sliced off.
    ``index_put_(accumulate=True)`` adds duplicates deterministically on
    both devices (CUDA sorts the indices first; no float atomics).
    """
    B, T, V = values.shape
    idx = torch.where(mask & (task_node >= 0), task_node.long(), n_nodes)
    idx = idx + torch.arange(B, device=idx.device)[:, None] * (n_nodes + 1)
    out = torch.zeros((B * (n_nodes + 1), V), dtype=torch.float32,
                      device=values.device)
    out.index_put_((idx.reshape(-1),),
                   values.reshape(B * T, V).to(torch.float32),
                   accumulate=True)
    return out.view(B, n_nodes + 1, V)[:, :n_nodes]


def segment_usage_ref(task_node: torch.Tensor, values: torch.Tensor,
                      mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """task_node (T,) i32 (may be -1), values (T,V) f32, mask (T,) bool
    -> (N, V) f32 sums over tasks placed on each node."""
    return segment_usage_lanes_ref(task_node[None], values[None], mask[None],
                                   n_nodes)[0]
