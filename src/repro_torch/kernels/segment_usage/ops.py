"""Dispatch for the segment-usage kernel: CUDA tensors launch
``csrc/segment_usage.cu``, CPU tensors take the plain version.

Under incremental accounting this full O(max_tasks) pass serves the
drivers' periodic resync; with ``incremental_accounting=False`` it is the
engine's per-window recompute. Every lane goes through one launch."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_usage.ref import segment_usage_lanes_ref

MAX_V = 8            # value columns the kernel takes
MAX_NODES = 16384    # node ids sort as two 7-bit digits
RADIX, TILE = 128, 1024   # the kernel's digit buckets and tasks per tile


def scratch_ints(B: int, T: int) -> int:
    """Ints of scratch a launch needs: per-tile digit counts, two passes'
    digit totals, the lanes' kept counts, two (B, T) permutations and the
    sorted node ids (``csrc/segment_usage.cu``)."""
    return B * (RADIX * -(-T // TILE) + 2 * RADIX + 1 + 3 * T)


def segment_usage_cuda(task_node: torch.Tensor, values: torch.Tensor,
                       mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """The kernel itself, one launch for all lanes: task_node (B, T) i32,
    values (B, T, V) f32, mask (B, T) bool -> (B, n_nodes, V) f32."""
    B, T, V = values.shape
    _build.check(task_node, "task_node", torch.int32, (B, T))
    _build.check(values, "values", torch.float32, (B, T, V))
    _build.check(mask, "mask", torch.bool, (B, T))
    if not 1 <= V <= MAX_V or not 1 <= n_nodes <= MAX_NODES:
        raise ValueError(f"segment_usage: V={V} (1..{MAX_V}) and n_nodes="
                         f"{n_nodes} (1..{MAX_NODES}) out of range")
    out = torch.empty((B, n_nodes, V), dtype=torch.float32,
                      device=values.device)
    n_scratch = scratch_ints(B, T)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=values.device)
    _build.launch("segment_usage_launch", task_node, values, mask, out,
                  scratch, n_scratch, B, T, V, n_nodes)
    segment_usage_cuda.launches += 1
    return out


segment_usage_cuda.launches = 0


def segment_usage_lanes(task_node: torch.Tensor, values: torch.Tensor,
                        mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Sum each lane's ``values`` rows into their task's node row.
    (B,T), (B,T,V), (B,T) -> (B,N,V)."""
    if values.device.type != "cuda":
        return segment_usage_lanes_ref(task_node, values, mask, n_nodes)
    return segment_usage_cuda(task_node.contiguous(), values.contiguous(),
                              mask.contiguous(), n_nodes)


def segment_usage(task_node: torch.Tensor, values: torch.Tensor,
                  mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Sum ``values`` rows into their task's node row.
    (T,), (T,V), (T,) -> (N,V)."""
    return segment_usage_lanes(task_node[None], values[None], mask[None],
                               n_nodes)[0]
