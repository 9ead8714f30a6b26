"""Dispatch for the fused window-stats kernel: CUDA tensors launch
``csrc/window_stats.cu``, CPU tensors take the plain version.
``core.stats.window_stats`` composes the stats row from the returned
:class:`WindowReductions`, so both paths share one assembly."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.window_stats.ref import (N_PRIO, WindowReductions,
                                                  window_reductions_ref)

TASKS_PER_BLOCK = 1024     # stage-1 task chunk (4 rows per thread)


def window_stats_cuda(task_state, task_usage, task_prio, node_active,
                      node_total, node_reserved, node_used):
    """The kernel itself, over a leading lane axis B: task_state (B,T) i8,
    task_usage (B,T,U) f32, task_prio (B,T) i32, node_active (B,N) bool,
    node_total/node_reserved/node_used (B,N,R) f32 -> (counts (B,3) i32 =
    [n_running, n_pending, n_nodes], by_prio (B,12,2) i32, usage_sum (B,U)
    f32, node_red (B,3R+2) f32 = [cap | reserved | used | util_var,
    res_var])."""
    B, T = task_state.shape
    U = task_usage.shape[2]
    N, R = node_total.shape[1], node_total.shape[2]
    _build.check(task_state, "task_state", torch.int8, (B, T))
    _build.check(task_usage, "task_usage", torch.float32, (B, T, U))
    _build.check(task_prio, "task_prio", torch.int32, (B, T))
    _build.check(node_active, "node_active", torch.bool, (B, N))
    for name, t in (("node_total", node_total),
                    ("node_reserved", node_reserved),
                    ("node_used", node_used)):
        _build.check(t, name, torch.float32, (B, N, R))
    G = max(1, min(1024, -(-T // TASKS_PER_BLOCK)))
    dev = task_state.device
    counts = torch.empty((B, 3), dtype=torch.int32, device=dev)
    by_prio = torch.empty((B, N_PRIO, 2), dtype=torch.int32, device=dev)
    usage_sum = torch.empty((B, U), dtype=torch.float32, device=dev)
    node_red = torch.empty((B, 3 * R + 2), dtype=torch.float32, device=dev)
    part_hist = torch.empty((B, G, 2 * N_PRIO), dtype=torch.int32,
                            device=dev)
    part_usum = torch.empty((B, G, U), dtype=torch.float32, device=dev)
    _build.launch("window_stats_launch", task_state, task_usage, task_prio,
                  node_active, node_total, node_reserved, node_used, counts,
                  by_prio, usage_sum, node_red, part_hist, part_usum,
                  B, T, U, N, R, G)
    window_stats_cuda.launches += 1
    return counts, by_prio, usage_sum, node_red


window_stats_cuda.launches = 0


def window_reductions(task_state, task_usage, task_prio, node_active,
                      node_total, node_reserved, node_used
                      ) -> WindowReductions:
    """Every reduction a stats row needs, in one pass over each table.

    task_state (T,) i8, task_usage (T, U) f32, task_prio (T,) i32,
    node_active (N,) bool, node_total/node_reserved/node_used (N, R) f32
    -> :class:`WindowReductions`.
    """
    if task_state.device.type != "cuda":
        return window_reductions_ref(task_state, task_usage, task_prio,
                                     node_active, node_total, node_reserved,
                                     node_used)
    counts, by_prio, usage_sum, node_red = window_stats_cuda(
        *(x.contiguous()[None] for x in
          (task_state, task_usage, task_prio, node_active, node_total,
           node_reserved, node_used)))
    R = node_total.shape[-1]
    counts, node_red = counts[0], node_red[0]
    return WindowReductions(
        n_running=counts[0], n_pending=counts[1], n_nodes=counts[2],
        by_prio=by_prio[0], usage_sum=usage_sum[0], cap=node_red[0:R],
        reserved=node_red[R:2 * R], used=node_red[2 * R:3 * R],
        util_var=node_red[3 * R], res_var=node_red[3 * R + 1])
