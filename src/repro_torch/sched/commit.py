"""The capacity-checked finaliser every scheduler shares.

Proposals only rank nodes; *this* pass decides. An in-priority-order scan
re-checks resource fit against the running reservation tally, so **no
scheduler can overcommit a node** regardless of what it proposes. The scan
itself is ``kernels/placement_commit``; this module derives its operands
from the simulation state and applies the resulting assignment back.
"""
from __future__ import annotations

import torch

from repro_torch.config import SimConfig
from repro_torch.core.engine import accounted_usage
from repro_torch.core.scatter import add_rows
from repro_torch.core.state import SimState, TASK_RUNNING
from repro_torch.kernels.placement_commit.ops import placement_commit


def commit_operands(state: SimState, cfg: SimConfig, idx):
    """(total (N, R) with inactive nodes folded to -1, denom (N, R) best-fit
    normaliser, req (P, R) gathered requests)."""
    total = torch.where(state.node_active[:, None], state.node_total, -1.0)
    denom = torch.clamp_min(state.node_total, 1e-6)
    req = state.task_req[idx]                                   # (P, R)
    return total, denom, req


def finalize(state: SimState, cfg: SimConfig, idx, valid, base_ok, pref,
             dynamic_bestfit: bool = False) -> SimState:
    """Sequential capacity-checked assignment in priority order.

    pref: (P, N) preference scores (higher better; -inf = never).
    dynamic_bestfit: recompute best-fit scores against the *running*
    reservation tally instead of the static pref. Under incremental
    accounting the commit's final tally becomes node_reserved and the placed
    tasks' usage rows are added into node_used.
    """
    total, denom, req = commit_operands(state, cfg, idx)
    node_of, tally = placement_commit(pref, req, base_ok, valid, total, denom,
                                      state.node_reserved, dynamic_bestfit,
                                      return_tally=True)
    return apply_commit(state, cfg, idx, node_of, tally)


def apply_commit(state: SimState, cfg: SimConfig, idx, node_of,
                 tally) -> SimState:
    """Fold a commit result (node_of (P,) i32, tally (N, R) f32) back into
    the state. ``idx`` holds distinct slots, so the writes do not collide."""
    placed = node_of >= 0
    state.task_state[idx] = torch.where(placed, TASK_RUNNING,
                                        state.task_state[idx]).to(torch.int8)
    state.task_node[idx] = torch.where(placed, node_of, state.task_node[idx])
    state = state._replace(
        placements=state.placements + placed.sum(dtype=torch.int32))
    if cfg.incremental_accounting:
        used_cols = accounted_usage(state.task_usage[idx])
        node_used = add_rows(state.node_used, node_of, placed, used_cols)
        state = state._replace(node_reserved=tally, node_used=node_used)
    return state
