"""Pluggable schedulers: the shared front end (``base``), the capacity-
checked finaliser (``commit``), the registry, and the deterministic
heuristics (``greedy``, ``first_fit``, ``round_robin``)."""
from repro_torch.sched.base import NEG, base_pass, pending_batch
from repro_torch.sched.commit import apply_commit, commit_operands, finalize
from repro_torch.sched.registry import (NOT_PORTED, SchedulerEntry,
                                        describe_schedulers, get_entry,
                                        get_scheduler, list_schedulers,
                                        register_scheduler)
# importing the built-in module registers it (order fixes registry order)
from repro_torch.sched.heuristics import (first_fit, greedy,
                                          propose_first_fit, propose_greedy,
                                          propose_round_robin, round_robin)

__all__ = [
    "NEG", "base_pass", "pending_batch", "finalize", "commit_operands",
    "apply_commit", "NOT_PORTED", "SchedulerEntry",
    "register_scheduler", "get_scheduler",
    "get_entry", "list_schedulers", "describe_schedulers", "greedy",
    "first_fit", "round_robin", "propose_greedy", "propose_first_fit",
    "propose_round_robin",
]
