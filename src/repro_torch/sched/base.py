"""Shared scheduler front-end: pending-batch selection + constraint scoring.

* :func:`pending_batch` — top-P pending task slots by priority (descending),
  the fixed-size working set a window's scheduling pass considers;
* :func:`base_pass` — the (P, N) constraint-match/best-fit score matrix from
  the ``constraint_match`` kernel, plus the derived feasibility mask.
"""
from __future__ import annotations

import torch

from repro_torch.config import SimConfig
from repro_torch.core.scatter import take
from repro_torch.core.state import SimState, TASK_PENDING, lift
from repro_torch.kernels.constraint_match.ops import constraint_match

NEG = float("-inf")
INT32_MIN = -2 ** 31


def pending_batch(state: SimState, cfg: SimConfig):
    """Top-P pending task slots by priority (descending), per lane of a
    lane-batched state ((B, P) results) or of a single one ((P,)).

    Priorities tie heavily and the order of ``idx`` is the commit order, so
    ties keep the lower slot first, as the reference's ``lax.top_k`` does: a
    stable descending sort, not ``torch.topk`` (no tie order promised).
    """
    P = cfg.sched_batch
    pend = state.task_state == TASK_PENDING
    key = torch.where(pend, state.task_prio, INT32_MIN)
    _, order = torch.sort(key, dim=-1, descending=True, stable=True)
    idx = order[..., :P]
    return idx, pend.gather(-1, idx)


def base_pass(state: SimState, cfg: SimConfig):
    """Pending batch + constraint-match scores: (idx, valid, base_ok, scores).

    scores is (P, N) f32 with -inf for infeasible (task, node) pairs;
    base_ok is its finiteness mask. On a lane-batched state every result
    has the lane axis in front, the scores from one kernel launch.
    """
    if state.window.dim() == 0:
        return tuple(x[0] for x in base_pass(lift(state), cfg))
    idx, valid = pending_batch(state, cfg)
    scores = constraint_match(
        take(state.task_req, idx), take(state.task_constraints, idx),
        state.node_total, state.node_reserved, state.node_attrs,
        state.node_active)                                   # (B, P, N)
    return idx, valid, torch.isfinite(scores), scores
