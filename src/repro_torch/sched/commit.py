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
from repro_torch.core.scatter import add_rows, take
from repro_torch.core.state import SimState, TASK_RUNNING
from repro_torch.kernels.placement_commit.ops import placement_commit


def commit_operands(state: SimState, cfg: SimConfig, idx):
    """(total (B, N, R) with inactive nodes folded to -1, denom (B, N, R)
    best-fit normaliser, req (B, P, R) gathered requests) of a lane-batched
    state. Shared by :func:`finalize` and the fleet's switchless dispatch,
    so both paths feed the kernels the same bits."""
    total = torch.where(state.node_active[..., None], state.node_total, -1.0)
    denom = torch.clamp_min(state.node_total, 1e-6)
    return total, denom, take(state.task_req, idx)


def finalize(state: SimState, cfg: SimConfig, idx, valid, base_ok, pref,
             dynamic_bestfit=False) -> SimState:
    """Sequential capacity-checked assignment in priority order, every lane
    of a lane-batched state in one commit launch.

    pref: (B, P, N) preference scores (higher better; -inf = never).
    dynamic_bestfit: recompute best-fit scores against the *running*
    reservation tally instead of the static pref; a Python bool for every
    lane, or a (B,) bool tensor with one flag per lane. Under incremental
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
    """Fold a commit result (node_of (B, P) i32, tally (B, N, R) f32) back
    into a lane-batched state. ``idx`` holds distinct slots per lane, so
    the writes do not collide."""
    placed = node_of >= 0
    lanes = torch.arange(idx.shape[0], device=idx.device)[:, None]
    state.task_state[lanes, idx] = torch.where(
        placed, TASK_RUNNING, state.task_state[lanes, idx]).to(torch.int8)
    state.task_node[lanes, idx] = torch.where(placed, node_of,
                                              state.task_node[lanes, idx])
    state = state._replace(
        placements=state.placements + placed.sum(-1, dtype=torch.int32))
    if cfg.incremental_accounting:
        used_cols = accounted_usage(take(state.task_usage, idx))
        node_used = add_rows(state.node_used, node_of, placed, used_cols)
        state = state._replace(node_reserved=tally, node_used=node_used)
    return state
