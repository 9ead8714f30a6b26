"""Dispatch for the fused window-stats kernel: CUDA tensors launch
``csrc/window_stats.cu``, CPU tensors take the plain version.
``core.stats.window_stats`` composes the stats row from the returned
:class:`WindowReductions`, so both paths share one assembly."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.window_stats.ref import (N_PRIO, WindowReductions,
                                                  window_reductions_ref)


def window_stats_cuda(task_state, task_usage, task_prio, node_active,
                      node_total, node_reserved, node_used):
    """The kernel itself, over a leading lane axis B: task_state (B,T) i8,
    task_usage (B,T,U) f32, task_prio (B,T) i32, node_active (B,N) bool,
    node_total/node_reserved/node_used (B,N,R) f32 -> (counts (B,3) i32 =
    [n_running, n_pending, n_nodes], by_prio (B,12,2) i32, usage_sum (B,U)
    f32, node_red (B,3R+2) f32 = [cap | reserved | used | util_var,
    res_var]); views of one i32 and one f32 buffer, one launch."""
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
    dev = task_state.device
    ints = torch.empty((B, 3 + 2 * N_PRIO), dtype=torch.int32, device=dev)
    floats = torch.empty((B, U + 3 * R + 2), dtype=torch.float32, device=dev)
    _build.launch("window_stats_launch", task_state, task_usage, task_prio,
                  node_active, node_total, node_reserved, node_used, ints,
                  floats, B, T, U, N, R)
    window_stats_cuda.launches += 1
    return (ints[:, :3], ints[:, 3:].unflatten(1, (N_PRIO, 2)),
            floats[:, :U], floats[:, U:])


window_stats_cuda.launches = 0


def window_reductions(task_state, task_usage, task_prio, node_active,
                      node_total, node_reserved, node_used
                      ) -> WindowReductions:
    """Every reduction a stats row needs, in one pass over each table.

    task_state (T,) i8, task_usage (T, U) f32, task_prio (T,) i32,
    node_active (N,) bool, node_total/node_reserved/node_used (N, R) f32
    -> :class:`WindowReductions`; or each with a leading lane axis B, and
    then every field of the result too (one kernel launch for all lanes).
    """
    args = (task_state, task_usage, task_prio, node_active, node_total,
            node_reserved, node_used)
    if task_state.dim() == 1:
        return WindowReductions(*[f[0] for f in window_reductions(
            *[x[None] for x in args])])
    if task_state.device.type != "cuda":
        lanes = [window_reductions_ref(*[x[b] for x in args])
                 for b in range(task_state.shape[0])]
        return WindowReductions(*[torch.stack(f) for f in zip(*lanes)])
    counts, by_prio, usage_sum, node_red = window_stats_cuda(
        *(x.contiguous() for x in args))
    R = node_total.shape[-1]
    return WindowReductions(
        n_running=counts[:, 0], n_pending=counts[:, 1], n_nodes=counts[:, 2],
        by_prio=by_prio, usage_sum=usage_sum, cap=node_red[:, 0:R],
        reserved=node_red[:, R:2 * R], used=node_red[:, 2 * R:3 * R],
        util_var=node_red[:, 3 * R], res_var=node_red[:, 3 * R + 1])
