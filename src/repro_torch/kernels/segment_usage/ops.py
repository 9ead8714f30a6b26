"""Dispatch for the segment-usage kernel: CUDA tensors launch
``csrc/segment_usage.cu``, CPU tensors take the plain version.

Under incremental accounting this full O(max_tasks) pass serves the
drivers' periodic resync; with ``incremental_accounting=False`` it is the
engine's per-window recompute. Every lane goes through one launch."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_usage.ref import segment_usage_lanes_ref

DIGIT_BITS = 7            # node ids sort in 7-bit digits, one pass each
RADIX, TILE = 1 << DIGIT_BITS, 1024   # digit buckets, tasks per tile


def digit_passes(n_nodes: int) -> int:
    """Radix passes that sort node ids 0..n_nodes-1: ceil(bits(n_nodes -
    1) / 7), at least 1 (2 up to 16,384 nodes, cell A's case; 5 for any
    int32 id)."""
    return max(1, -(-(int(n_nodes) - 1).bit_length() // DIGIT_BITS))


def scratch_ints(B: int, T: int, passes: int) -> int:
    """Ints of scratch a launch needs: per-tile digit counts, each pass's
    digit totals, the lanes' kept counts, two (B, T) permutations and the
    sorted node ids (``csrc/segment_usage.cu``)."""
    return B * (RADIX * -(-T // TILE) + passes * RADIX + 1 + 3 * T)


def segment_usage_cuda(task_node: torch.Tensor, values: torch.Tensor,
                       mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """The kernel itself, one launch for all lanes: task_node (B, T) i32,
    values (B, T, V) f32, mask (B, T) bool -> (B, n_nodes, V) f32; any
    V >= 1 and 1 <= n_nodes < 2**31."""
    B, T, V = values.shape
    _build.check(task_node, "task_node", torch.int32, (B, T))
    _build.check(values, "values", torch.float32, (B, T, V))
    _build.check(mask, "mask", torch.bool, (B, T))
    if V < 1 or not 1 <= n_nodes < 2 ** 31:
        raise ValueError(f"segment_usage: V={V} (>= 1) and n_nodes="
                         f"{n_nodes} (1..2**31-1) out of range")
    out = torch.empty((B, n_nodes, V), dtype=torch.float32,
                      device=values.device)
    passes = digit_passes(n_nodes)
    n_scratch = scratch_ints(B, T, passes)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=values.device)
    _build.launch("segment_usage_launch", task_node, values, mask, out,
                  scratch, n_scratch, B, T, V, n_nodes, passes)
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
