"""Plain PyTorch version of the constraint-match kernel (the simulator's own
``core.constraints.placement_scores``)."""
from __future__ import annotations

import torch

from repro_torch.core.constraints import placement_scores


def constraint_match_ref(req: torch.Tensor, cons: torch.Tensor,
                         node_total: torch.Tensor, node_reserved: torch.Tensor,
                         node_attrs: torch.Tensor, node_active: torch.Tensor
                         ) -> torch.Tensor:
    """req (P,R), cons (P,C,3), node_* (N,...) -> scores (P,N) f32.

    -inf marks infeasible (task, node) pairs; elsewhere the best-fit score.
    """
    return placement_scores(req, cons, node_total, node_reserved,
                            node_attrs, node_active)
