"""Plain PyTorch version of the placement-commit kernel: the sequential
capacity-checked assignment loop of the scheduler finaliser.

The loop walks the P pending tasks in priority order; each step re-checks
resource fit against the *running* reservation tally (no proposal can
overcommit a node, whatever preference matrix it hands over) and either
assigns the argmax-feasible node or leaves the task pending (-1). Written
with tensor ops only, so it runs on the card without a host sync too.
"""
from __future__ import annotations

import torch

from repro_torch.core.constraints import sum_last
from repro_torch.kernels.placement_commit import (FAM_EXTERNAL,
                                                  FAM_NODE_ORDER, FAM_SCORES)

NEG = float("-inf")


def placement_commit_ref(pref: torch.Tensor, req: torch.Tensor,
                         base_ok: torch.Tensor, valid: torch.Tensor,
                         total: torch.Tensor, denom: torch.Tensor,
                         reserved0: torch.Tensor, dynamic_bestfit: bool = False):
    """pref (P,N) f32, req (P,R) f32, base_ok (P,N) bool, valid (P,) bool,
    total (N,R) f32 (inactive nodes folded to -1), denom (N,R) f32,
    reserved0 (N,R) f32 -> (node_of (P,) i32 (-1 = not placed),
    reserved (N,R) f32 — the final tally, reserved0 + every placed request).

    dynamic_bestfit: recompute best-fit scores against the running
    reservation tally instead of the static pref. A Python bool, or a 0-d
    bool tensor (the scenario fleet's per-lane flag), for which both scores
    are computed and the flag selects.
    """
    P = pref.shape[0]
    reserved = reserved0.clone()
    node_of = torch.full((P,), -1, dtype=torch.int32, device=pref.device)
    traced = isinstance(dynamic_bestfit, torch.Tensor)
    for i in range(P):
        free = total - reserved                                 # (N, R)
        fit = (req[i][None, :] <= free + 1e-9).all(dim=-1) & base_ok[i]
        if traced or dynamic_bestfit:
            sc_dyn = -sum_last((free - req[i][None, :]) / denom)
        if traced:
            sc = torch.where(dynamic_bestfit, sc_dyn, pref[i])
        elif dynamic_bestfit:
            sc = sc_dyn
        else:
            sc = pref[i]
        sc = torch.where(fit, sc, NEG)
        n = torch.argmax(sc)              # first index of the maximum
        can = fit[n] & valid[i]
        add = torch.where(can, req[i], 0.0)
        reserved.index_put_((n.view(1),), add.view(1, -1), accumulate=True)
        node_of[i] = torch.where(can, n.to(torch.int32), -1)
    return node_of, reserved


def sched_pref_ref(scores: torch.Tensor, start, family: int, ext=None):
    """The (P, N) preference a proposal family implies, so the fused
    scheduler pass can be checked against ``pref -> placement_commit_ref``:
    FAM_SCORES passes the base-pass scores through (greedy), FAM_NODE_ORDER
    ranks nodes by ``-((col - start) % N)`` (first-fit at start 0,
    round-robin at a rotating start), FAM_EXTERNAL returns the evaluated
    ``ext`` (an opaque proposal)."""
    if family == FAM_SCORES:
        return scores
    if family == FAM_NODE_ORDER:
        N = scores.shape[-1]
        order = torch.remainder(
            torch.arange(N, dtype=torch.int32, device=scores.device) - start,
            N)
        return (-order.to(torch.float32))[None, :].expand(scores.shape)
    if ext is None:
        raise ValueError("FAM_EXTERNAL needs the evaluated ext preference")
    return ext


def sched_commit_fleet_ref(scores, ok, req, valid, total, denom, reserved0,
                           start, fam, dynamic, ext=None, ext_row=None):
    """Plain version of the fused scheduler pass (kernel D), lane by lane:
    ``sched_pref_ref`` -> ``placement_commit_ref``. Operands carry a lane
    axis B or 1 (shared); ``start`` (B,) per-lane node-order rotations,
    ``fam`` / ``dynamic`` / ``ext_row`` per-lane tuples, ``ext`` (BE, P, N)
    the external lanes' preferences. -> (node_of (B, P) i32, tally
    (B, N, R) f32)."""
    def at(x, b):
        return x[b if x.shape[0] > 1 else 0]

    lanes = []
    for b, f in enumerate(fam):
        pref = sched_pref_ref(at(scores, b), start[b], f,
                              ext[ext_row[b]] if f == FAM_EXTERNAL else None)
        lanes.append(placement_commit_ref(
            pref, *[at(x, b) for x in (req, ok, valid, total, denom,
                                       reserved0)], bool(dynamic[b])))
    return tuple(torch.stack(f) for f in zip(*lanes))
