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
    reservation tally instead of the static pref.
    """
    P = pref.shape[0]
    reserved = reserved0.clone()
    node_of = torch.full((P,), -1, dtype=torch.int32, device=pref.device)
    for i in range(P):
        free = total - reserved                                 # (N, R)
        fit = (req[i][None, :] <= free + 1e-9).all(dim=-1) & base_ok[i]
        if dynamic_bestfit:
            sc = -sum_last((free - req[i][None, :]) / denom)
        else:
            sc = pref[i]
        sc = torch.where(fit, sc, NEG)
        n = torch.argmax(sc)              # first index of the maximum
        can = fit[n] & valid[i]
        add = torch.where(can, req[i], 0.0)
        reserved.index_put_((n.view(1),), add.view(1, -1), accumulate=True)
        node_of[i] = torch.where(can, n.to(torch.int32), -1)
    return node_of, reserved
