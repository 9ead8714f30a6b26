"""Per-window statistics: requested *and* actually-used resources, the
secondary usage columns, task/node population and scheduler activity.

Two implementations produce the row:

* **fused** (:func:`window_stats`, the engine's): every task-table
  reduction comes out of ONE pass via ``kernels/window_stats`` (the CUDA
  kernel on the card, its plain version on the CPU);
* **unfused** (:func:`window_stats_ref`): the pre-fusion body (~6
  independent full passes), kept as the equivalence oracle that tests call
  directly.

``cfg.fused_window_stats`` stays a field so that configs compare equal with
the reference's, but like ``use_kernels`` the port does not read it: a CUDA
tensor always takes the hand-written kernel.

On grid-aligned data the two agree bitwise in every integer and sum; the
ratio fields divide, so they agree to a few ulp; the two variances share
one implementation (``kernels/window_stats/ref.spread``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import SimConfig
from repro_torch.core.state import SimState, TASK_PENDING, TASK_RUNNING
from repro_torch.kernels.window_stats.ops import window_reductions
from repro_torch.kernels.window_stats.ref import node_reserved_frac, spread

# task_usage column layout (GCD task_usage table, condensed)
U_CPU, U_CANON_MEM, U_ASSIGN_MEM, U_PAGE_CACHE = 0, 1, 2, 3
U_DISK_IO, U_DISK_SPACE, U_CPI, U_MAI = 4, 5, 6, 7

USAGE_NAMES = ("cpu_rate", "canonical_mem", "assigned_mem", "page_cache",
               "disk_io_time", "disk_space", "cpi", "mai")

# usage columns aligned with the (cpu, memory, disk) resource axes — the
# slice of task_usage that flows into node_used (full recomputes and the
# engine's incremental deltas must agree on this, so it lives here once)
ACCOUNTED_USAGE_COLS = (U_CPU, U_CANON_MEM, U_DISK_SPACE)


def _counters(state: SimState) -> Dict[str, torch.Tensor]:
    return {"evictions": state.evictions, "completions": state.completions,
            "placements": state.placements,
            "overflow_drops": state.overflow_drops}


def window_stats(state: SimState, cfg: SimConfig) -> Dict[str, torch.Tensor]:
    """One stats row from the current state (fused path; see module doc:
    ``cfg.fused_window_stats`` is not read)."""
    red = window_reductions(
        state.task_state, state.task_usage, state.task_prio,
        state.node_active, state.node_total, state.node_reserved,
        state.node_used)
    denom = torch.clamp_min(red.cap, 1e-9)
    usage_mean = torch.where(
        red.n_running > 0,
        red.usage_sum / torch.clamp_min(red.n_running, 1), 0.0)
    return {
        "n_nodes": red.n_nodes,
        "n_running": red.n_running,
        "n_pending": red.n_pending,
        "running_by_priority": red.by_prio[:, 0],
        "pending_by_priority": red.by_prio[:, 1],
        "capacity": red.cap,
        "reserved": red.reserved,
        "used": red.used,
        "reserved_frac": red.reserved / denom,
        "used_frac": red.used / denom,
        "overestimate_frac": 1.0 - red.used / torch.clamp_min(red.reserved,
                                                              1e-9),
        "usage_mean": usage_mean,
        "util_balance_var": red.util_var,
        "reserved_balance_var": red.res_var,
        **_counters(state),
    }


def window_stats_ref(state: SimState, cfg: SimConfig
                     ) -> Dict[str, torch.Tensor]:
    """The pre-fusion stats body: ~6 independent full passes over the task
    table. Equivalence oracle for the fused path."""
    running = state.task_state == TASK_RUNNING
    pending = state.task_state == TASK_PENDING
    active = state.node_active
    n_running = running.sum(dtype=torch.int32)
    n_active = active.sum(dtype=torch.int32)
    n_div = torch.clamp_min(n_active, 1)

    cap = torch.where(active[:, None], state.node_total, 0.0).sum(0)  # (R,)
    reserved = state.node_reserved.sum(0)
    used = state.node_used.sum(0)
    denom = torch.clamp_min(cap, 1e-9)

    usage_mean = torch.where(
        n_running > 0,
        (state.task_usage * running[:, None].to(torch.float32)).sum(0)
        / torch.clamp_min(n_running, 1), 0.0)                         # (U,)

    # per-node utilisation spread (load-balance quality — the MASB metric)
    node_util = torch.where(
        active[:, None],
        state.node_used / torch.clamp_min(state.node_total, 1e-9),
        0.0)[:, 0]
    util_var = spread(node_util, active, n_div)
    # same spread over *reserved* fractions (defined even without usage logs)
    res_var = spread(node_reserved_frac(state.node_reserved, state.node_total,
                                        active), active, n_div)

    # per-priority-class population (GCD priorities 0-11), one scatter-add
    # of integer counts (exact in any order) split into the two columns
    prio = state.task_prio.clamp(0, 11).long()
    by_prio = torch.zeros((12, 2), dtype=torch.int32,
                          device=state.task_prio.device)
    by_prio.index_put_((prio,), torch.stack([running, pending], dim=1)
                       .to(torch.int32), accumulate=True)

    return {
        "n_nodes": n_active,
        "n_running": n_running,
        "n_pending": pending.sum(dtype=torch.int32),
        "running_by_priority": by_prio[:, 0],
        "pending_by_priority": by_prio[:, 1],
        "capacity": cap,
        "reserved": reserved,
        "used": used,
        "reserved_frac": reserved / denom,
        "used_frac": used / denom,
        "overestimate_frac": 1.0 - used / torch.clamp_min(reserved, 1e-9),
        "usage_mean": usage_mean,
        "util_balance_var": util_var,
        "reserved_balance_var": res_var,
        **_counters(state),
    }
