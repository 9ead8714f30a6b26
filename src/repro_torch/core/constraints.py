"""Task-constraint / node-attribute matching and the best-fit score matrix.

A task carries up to C constraints, each ``(attr_idx, op, value)`` with
op ∈ {=, ≠, <, >} over the node's int32 attribute columns (GCD
task_constraints semantics). A node is *eligible* for a task iff all its
constraints pass AND the node has enough free (unreserved) capacity.

These plain PyTorch functions are the plain version of the
``constraint_match`` CUDA kernel (``kernels/constraint_match``).
"""
from __future__ import annotations

import torch

from repro_torch.core.events import OP_EQ, OP_GT, OP_LT, OP_NE


def constraints_ok(cons: torch.Tensor, node_attrs: torch.Tensor
                   ) -> torch.Tensor:
    """cons: (P, C, 3); node_attrs: (N, K) -> ok (P, N) bool."""
    K = node_attrs.shape[1]
    attr_idx = cons[:, :, 0].long()                # (P, C)
    # gathers clamp out-of-range indices (numpy-style negatives wrap first)
    attr_idx = torch.where(attr_idx < 0, attr_idx + K, attr_idx)
    attr_idx = attr_idx.clamp(0, K - 1)
    op = cons[:, :, 1][None]                       # (1, P, C)
    val = cons[:, :, 2][None]
    got = node_attrs[:, attr_idx]                  # (N, P, C)
    ok = torch.where(op == OP_EQ, got == val,
         torch.where(op == OP_NE, got != val,
         torch.where(op == OP_LT, got < val,
         torch.where(op == OP_GT, got > val, True))))
    return ok.all(dim=-1).T                        # (P, N)


def resource_fit(req: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """req: (P, R); free: (N, R) -> fit (P, N) bool."""
    return (req[:, None, :] <= free[None, :, :] + 1e-9).all(dim=-1)


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1)`` with the terms added from 0 in index order, the order
    the reference's reductions over the R resource columns take."""
    s = torch.zeros_like(x[..., 0])
    for r in range(x.shape[-1]):
        s = s + x[..., r]
    return s


def placement_scores(req: torch.Tensor, cons: torch.Tensor,
                     node_total: torch.Tensor, node_reserved: torch.Tensor,
                     node_attrs: torch.Tensor, node_active: torch.Tensor
                     ) -> torch.Tensor:
    """Best-fit placement score matrix (P, N); -inf where infeasible.

    Score = negated normalised leftover capacity, i.e. prefer the node whose
    free capacity most tightly fits the request (best-fit decreasing).
    """
    free = node_total - node_reserved              # (N, R)
    ok = constraints_ok(cons, node_attrs) & resource_fit(req, free)
    ok = ok & node_active[None, :]
    denom = torch.clamp_min(node_total, 1e-6)      # (N, R)
    leftover = (free[None] - req[:, None]) / denom[None]   # (P, N, R)
    score = -sum_last(leftover)
    return torch.where(ok, score, float("-inf"))
