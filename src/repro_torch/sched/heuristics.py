"""Classic placement heuristics — greedy best-fit, first-fit, round-robin,
random — as registry proposals. Each only ranks nodes per task; the shared
finaliser (``sched.commit``) re-checks capacity in priority order."""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.sched.registry import register_scheduler
from repro_torch.sched.table import (FAM_NODE_ORDER, FAM_SCORES, TableForm,
                                     tf_node_order, tf_random, tf_scores)


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


def propose_random(state, cfg, rng, idx, valid, base_ok, scores):
    """Random feasible node (uniform preference draw)."""
    return prng.uniform(rng, base_ok.shape)


# Table forms make these switchless in fleets (sched.table): greedy fuses
# as the score family, first_fit/round_robin as node-order rotations (rot=0
# / rot=131 — ``start = (window * rot) % N`` reproduces the proposals
# bitwise), random stays an external (rng-derived) form.
greedy = register_scheduler("greedy", propose_greedy, dynamic_bestfit=True,
                            doc="Best-fit decreasing: tightest feasible "
                                "node, re-scored dynamically.",
                            table_form=TableForm(tf_scores,
                                                 fused=FAM_SCORES))
first_fit = register_scheduler("first_fit", propose_first_fit,
                               doc="First-fit: lowest-index feasible node.",
                               table_form=TableForm(tf_node_order, (0.0,),
                                                    FAM_NODE_ORDER))
round_robin = register_scheduler("round_robin", propose_round_robin,
                                 doc="Round-robin over node indices, "
                                     "rotating start per window.",
                                 table_form=TableForm(tf_node_order,
                                                      (131.0,),
                                                      FAM_NODE_ORDER))
random_fit = register_scheduler("random", propose_random,
                                doc="Random feasible node (uniform draw).",
                                table_form=TableForm(tf_random))
