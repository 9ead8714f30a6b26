"""Plain PyTorch version of the fused window-stats reductions.

One logical pass over the task table (running/pending counts, the masked
usage sum behind ``usage_mean``, the (12, 2) per-priority population) plus
one small pass over the node table (active capacity, reserved/used sums,
and both utilisation-spread variances). ``core.stats.window_stats``
composes the per-window stats dict from these raw reductions. The
expressions mirror the unfused stats body term for term, so on grid-aligned
data the composed rows agree bitwise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.constraints import sum_last
from repro_torch.core.state import TASK_PENDING, TASK_RUNNING

N_PRIO = 12           # GCD priority classes 0-11


class WindowReductions(NamedTuple):
    """Raw reductions a stats row is assembled from (per lane)."""
    n_running: torch.Tensor    # ()        i32
    n_pending: torch.Tensor    # ()        i32
    n_nodes: torch.Tensor      # ()        i32 active nodes
    by_prio: torch.Tensor      # (12, 2)   i32 [running, pending] populations
    usage_sum: torch.Tensor    # (U,)      f32 usage summed over running tasks
    cap: torch.Tensor          # (R,)      f32 active capacity
    reserved: torch.Tensor     # (R,)      f32 node_reserved.sum(0)
    used: torch.Tensor         # (R,)      f32 node_used.sum(0)
    util_var: torch.Tensor     # ()        f32 spread of per-node cpu utilisation
    res_var: torch.Tensor      # ()        f32 spread of per-node reserved frac


def task_reductions_ref(task_state, task_usage, task_prio):
    """Task-table side: (n_running, n_pending, by_prio (12, 2) i32,
    usage_sum (U,) f32). Integer counts are exact in any order."""
    running = task_state == TASK_RUNNING
    pending = task_state == TASK_PENDING
    prio = task_prio.clamp(0, N_PRIO - 1)
    onehot = prio[:, None] == torch.arange(N_PRIO, dtype=prio.dtype,
                                           device=prio.device)   # (T, 12)
    by_prio = torch.stack(
        [(onehot & running[:, None]).sum(0, dtype=torch.int32),
         (onehot & pending[:, None]).sum(0, dtype=torch.int32)], dim=1)
    n_running = by_prio[:, 0].sum(dtype=torch.int32)
    n_pending = by_prio[:, 1].sum(dtype=torch.int32)
    usage_sum = running.to(torch.float32) @ task_usage   # masked sum
    return n_running, n_pending, by_prio, usage_sum


def node_reductions_ref(node_active, node_total, node_reserved, node_used):
    """Node-table side: capacity / tally sums + both balance variances."""
    active = node_active
    cap = torch.where(active[:, None], node_total, 0.0).sum(0)      # (R,)
    reserved = node_reserved.sum(0)
    used = node_used.sum(0)
    n_nodes = active.sum(dtype=torch.int32)
    n_div = torch.clamp_min(n_nodes, 1)

    node_util = torch.where(active[:, None],
                            node_used / torch.clamp_min(node_total, 1e-9),
                            0.0)[:, 0]
    return (n_nodes, cap, reserved, used, spread(node_util, active, n_div),
            spread(node_reserved_frac(node_reserved, node_total, active),
                   active, n_div))


def node_reserved_frac(node_reserved, node_total, active):
    """Per-node mean reserved fraction (0 on inactive nodes): the mean over
    R as the reference computes it, the sum in index order times the f32
    reciprocal of R."""
    return sum_last(torch.where(
        active[:, None], node_reserved / torch.clamp_min(node_total, 1e-9),
        0.0)) * (1.0 / node_total.shape[-1])


def spread(values, active, n_div):
    """Variance of the per-node ``values`` over the active nodes,
    sum((x - mean)^2) / n. Both sums of these inexact ratio terms are
    accumulated in f64 and rounded once to f32, as the CUDA kernel does,
    so that the kernel and this plain version agree whatever order each
    sums in; against the reference's f32 sums they agree to a few ulp."""
    mean = values.double().sum().float() / n_div
    sq = torch.where(active, (values - mean) ** 2, 0.0)
    return sq.double().sum().float() / n_div


def window_reductions_ref(task_state, task_usage, task_prio, node_active,
                          node_total, node_reserved, node_used
                          ) -> WindowReductions:
    n_running, n_pending, by_prio, usage_sum = task_reductions_ref(
        task_state, task_usage, task_prio)
    n_nodes, cap, reserved, used, util_var, res_var = node_reductions_ref(
        node_active, node_total, node_reserved, node_used)
    return WindowReductions(n_running=n_running, n_pending=n_pending,
                            n_nodes=n_nodes, by_prio=by_prio,
                            usage_sum=usage_sum, cap=cap, reserved=reserved,
                            used=used, util_var=util_var, res_var=res_var)
