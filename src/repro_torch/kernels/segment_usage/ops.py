"""Dispatch for the segment-usage kernel: CUDA tensors launch
``csrc/segment_usage.cu``, CPU tensors take the plain version.

Under incremental accounting this full O(max_tasks) pass serves the
drivers' periodic resync; with ``incremental_accounting=False`` it is the
engine's per-window recompute."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_usage.ref import segment_usage_ref


def segment_usage_cuda(task_node: torch.Tensor, values: torch.Tensor,
                       mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """The kernel itself: task_node (T,) i32, values (T,V) f32, mask (T,)
    bool -> (n_nodes, V) f32."""
    T, V = values.shape
    _build.check(task_node, "task_node", torch.int32, (T,))
    _build.check(values, "values", torch.float32, (T, V))
    _build.check(mask, "mask", torch.bool, (T,))
    out = torch.empty((n_nodes, V), dtype=torch.float32,
                      device=values.device)
    _build.launch("segment_usage_launch", task_node, values, mask, out,
                  T, V, n_nodes)
    segment_usage_cuda.launches += 1
    return out


segment_usage_cuda.launches = 0


def segment_usage(task_node: torch.Tensor, values: torch.Tensor,
                  mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Sum ``values`` rows into their task's node row.
    (T,), (T,V), (T,) -> (N,V)."""
    if values.device.type != "cuda":
        return segment_usage_ref(task_node, values, mask, n_nodes)
    return segment_usage_cuda(task_node.contiguous(), values.contiguous(),
                              mask.contiguous(), n_nodes)
