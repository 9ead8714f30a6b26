"""Pluggable schedulers: the shared front end (``base``), the capacity-
checked finaliser (``commit``), the registry, the proposal table of the
scenario fleet's switchless dispatch (``table``), the classic heuristics
(``greedy``, ``first_fit``, ``round_robin``, ``random``) and the
meta-heuristic searches (``simulated_annealing``, ``tabu_search``,
``genetic``)."""
from repro_torch.sched.base import NEG, base_pass, pending_batch
from repro_torch.sched.commit import apply_commit, commit_operands, finalize
from repro_torch.sched.table import (DispatchTable, SchedContext, TableForm,
                                     context_from_state,
                                     make_switchless_dispatch, tf_node_order,
                                     tf_random, tf_scores)
from repro_torch.sched.registry import (DYNAMIC_BESTFIT, PROPOSERS,
                                        SCHEDULERS, TABLE_FORMS,
                                        SchedulerEntry, describe_schedulers,
                                        get_entry, get_scheduler,
                                        list_schedulers, propose_lanes,
                                        register_scheduler,
                                        snapshot_dispatch,
                                        unregister_scheduler)
# importing the built-in modules registers them (order fixes registry order)
from repro_torch.sched.heuristics import (first_fit, greedy,
                                          propose_first_fit, propose_greedy,
                                          propose_random,
                                          propose_round_robin, random_fit,
                                          round_robin)
from repro_torch.sched.metaheuristics import (argmax_surrogate,
                                              balance_objective, genetic,
                                              propose_genetic,
                                              propose_simulated_annealing,
                                              propose_tabu_search,
                                              simulated_annealing,
                                              tabu_search, tf_genetic,
                                              tf_simulated_annealing,
                                              tf_tabu_search)

__all__ = [
    "NEG", "base_pass", "pending_batch", "finalize", "commit_operands",
    "apply_commit",
    "SCHEDULERS", "PROPOSERS", "DYNAMIC_BESTFIT", "TABLE_FORMS",
    "SchedulerEntry", "register_scheduler", "unregister_scheduler",
    "get_scheduler", "get_entry", "list_schedulers", "describe_schedulers",
    "snapshot_dispatch", "propose_lanes",
    "DispatchTable", "SchedContext", "TableForm", "context_from_state",
    "make_switchless_dispatch", "tf_scores", "tf_node_order", "tf_random",
    "tf_simulated_annealing", "tf_tabu_search", "tf_genetic",
    "greedy", "first_fit", "round_robin", "random_fit",
    "simulated_annealing", "tabu_search", "genetic",
    "propose_greedy", "propose_first_fit", "propose_round_robin",
    "propose_random", "propose_simulated_annealing", "propose_tabu_search",
    "propose_genetic", "argmax_surrogate", "balance_objective",
]
