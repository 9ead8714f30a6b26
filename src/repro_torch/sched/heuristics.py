"""Classic placement heuristics — greedy best-fit, first-fit, round-robin —
as registry proposals. Each only ranks nodes per task; the shared finaliser
(``sched.commit``) re-checks capacity in priority order."""
from __future__ import annotations

import torch

from repro_torch.sched.registry import register_scheduler


def propose_greedy(state, cfg, rng, idx, valid, base_ok, scores):
    """Best-fit decreasing: tightest feasible node, re-scored dynamically
    against the running reservation tally (pref is unused — the returned
    scores only pin the shape/dtype)."""
    return scores


def _node_order_pref(start, n_nodes: int, base_ok) -> torch.Tensor:
    """-((col - start) mod N) for every task row (a broadcast view)."""
    order = torch.remainder(
        torch.arange(n_nodes, device=base_ok.device) - start, n_nodes)
    return (-order.to(torch.float32))[None, :].expand(base_ok.shape)


def propose_first_fit(state, cfg, rng, idx, valid, base_ok, scores):
    """First-fit: lowest-index feasible node."""
    return _node_order_pref(0, cfg.max_nodes, base_ok)


def propose_round_robin(state, cfg, rng, idx, valid, base_ok, scores):
    """Round-robin: first-fit from a start index that rotates per window."""
    start = torch.remainder(state.window * 131, cfg.max_nodes)
    return _node_order_pref(start, cfg.max_nodes, base_ok)


greedy = register_scheduler("greedy", propose_greedy, dynamic_bestfit=True,
                            doc="Best-fit decreasing: tightest feasible "
                                "node, re-scored dynamically.")
first_fit = register_scheduler("first_fit", propose_first_fit,
                               doc="First-fit: lowest-index feasible node.")
round_robin = register_scheduler("round_robin", propose_round_robin,
                                 doc="Round-robin over node indices, "
                                     "rotating start per window.")
