"""Scheduler registry — schedulers plug in by name.

A *proposal* has the uniform signature

    propose(state, cfg, rng, idx, valid, base_ok, scores) -> pref (P, N)

and the registry glues it to the shared passes (``base.base_pass`` in front,
``commit.finalize`` behind) to derive the ``(state, cfg, rng) -> state``
entry point.

The reference's RNG schedulers (``random`` and the metaheuristics) wait
for the port of its random streams; asking for one raises and says so.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.sched.base import base_pass
from repro_torch.sched.commit import finalize

#: reference schedulers that need the RNG port (a later slice)
NOT_PORTED = ("random", "simulated_annealing", "tabu_search", "genetic")


@dataclasses.dataclass(frozen=True)
class SchedulerEntry:
    """One registered scheduler: its proposal fn + commit-time policy."""
    name: str
    propose: Callable
    entry: Callable                   # (state, cfg, rng) -> state
    dynamic_bestfit: bool = False     # finaliser re-scores vs running tally
    doc: str = ""


_REGISTRY: Dict[str, SchedulerEntry] = {}


def register_scheduler(name: str, propose: Callable, *,
                       dynamic_bestfit: bool = False,
                       doc: Optional[str] = None,
                       overwrite: bool = False) -> Callable:
    """Register a proposal fn under ``name``; returns the derived scheduler.

    ``dynamic_bestfit=True`` makes the finaliser re-score candidates against
    the running reservation tally (best-fit decreasing) instead of the
    static proposal.
    """
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"scheduler {name!r} already registered "
                         "(pass overwrite=True to replace it)")

    def scheduler(state, cfg, rng=None):
        idx, valid, base_ok, scores = base_pass(state, cfg)
        pref = propose(state, cfg, rng, idx, valid, base_ok, scores)
        return finalize(state, cfg, idx, valid, base_ok, pref,
                        dynamic_bestfit=dynamic_bestfit)

    scheduler.__name__ = name
    scheduler.__qualname__ = f"scheduler<{name}>"
    _REGISTRY[name] = SchedulerEntry(
        name=name, propose=propose, entry=scheduler,
        dynamic_bestfit=dynamic_bestfit,
        doc=doc if doc is not None else (propose.__doc__ or "").strip())
    return scheduler


def get_entry(name: str) -> SchedulerEntry:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"scheduler {name!r} draws random numbers and waits for the port "
            "of the reference's RNG streams (a later slice); ported: "
            f"{list(_REGISTRY)}")
    raise KeyError(f"unknown scheduler {name!r}; have {list(_REGISTRY)}")


def get_scheduler(name: str) -> Callable:
    return get_entry(name).entry


def list_schedulers() -> List[SchedulerEntry]:
    """Registered schedulers in registration order (built-ins first)."""
    return list(_REGISTRY.values())


def describe_schedulers() -> str:
    """Human-readable registry dump (the CLI's --list-schedulers)."""
    lines = []
    for e in list_schedulers():
        summary = e.doc.split("\n")[0].strip() if e.doc else ""
        tag = " [dynamic best-fit commit]" if e.dynamic_bestfit else ""
        lines.append(f"  {e.name:<22}{summary}{tag}")
    return "registered schedulers:\n" + "\n".join(lines)
