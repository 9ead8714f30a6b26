"""Scheduler registry — schedulers plug in by name.

A *proposal* has the uniform signature

    propose(state, cfg, rng, idx, valid, base_ok, scores) -> pref (P, N)

over ONE lane, and the registry glues it to the shared passes
(``base.base_pass`` in front, ``commit.finalize`` behind) to derive the
``(state, cfg, rng) -> state`` entry point, which takes a single state or a
lane-batched one (every lane running this scheduler: one base pass, the
proposal per lane, one commit).

A scheduler may also register a *table form* (``sched.table``), which lets
the scenario fleet dispatch it switchlessly and fuse its preference into
the commit kernel. ``SCHEDULERS`` / ``PROPOSERS`` / ``DYNAMIC_BESTFIT`` /
``TABLE_FORMS`` are live views of the registry (the same dict objects
forever, updated in place); :func:`snapshot_dispatch` freezes the rows a
fleet was built against.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.state import drop, lane, lift
from repro_torch.sched.base import base_pass
from repro_torch.sched.commit import finalize
from repro_torch.sched.table import DispatchTable, TableForm

@dataclasses.dataclass(frozen=True)
class SchedulerEntry:
    """One registered scheduler: its proposal fn + commit-time policy."""
    name: str
    propose: Callable
    entry: Callable                   # (state, cfg, rng) -> state
    dynamic_bestfit: bool = False     # finaliser re-scores vs running tally
    doc: str = ""
    table_form: Optional[TableForm] = None
    #                                 # switchless/fused dispatch form; None
    #                                 # = opaque (fleets propose per lane)


_REGISTRY: Dict[str, SchedulerEntry] = {}
# live views: scheduler name -> its entry point, proposal, commit policy
# and table form (None = opaque)
SCHEDULERS: Dict[str, Callable] = {}
PROPOSERS: Dict[str, Callable] = {}
DYNAMIC_BESTFIT: Dict[str, bool] = {}
TABLE_FORMS: Dict[str, Optional[TableForm]] = {}


def propose_lanes(proposers, state, cfg, rng, idx, valid, base_ok, scores
                  ) -> torch.Tensor:
    """(B, P, N) preferences of a lane-batched state, lane b proposed by
    ``proposers[b]`` on its own views (one lane: no copy)."""
    prefs = [propose(lane(state, b), cfg, rng, idx[b], valid[b], base_ok[b],
                     scores[b]) for b, propose in enumerate(proposers)]
    return prefs[0][None] if len(prefs) == 1 else torch.stack(prefs)


def register_scheduler(name: str, propose: Callable, *,
                       dynamic_bestfit: bool = False,
                       doc: Optional[str] = None,
                       table_form: Optional[TableForm] = None,
                       overwrite: bool = False) -> Callable:
    """Register a proposal fn under ``name``; returns the derived scheduler.

    ``dynamic_bestfit=True`` makes the finaliser re-score candidates against
    the running reservation tally (best-fit decreasing) instead of the
    static proposal. ``table_form`` registers the scheduler's
    proposal-table form for switchless fleet dispatch; its transform must
    give the same preferences as ``propose``.
    """
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"scheduler {name!r} already registered "
                         "(pass overwrite=True to replace it)")

    def scheduler(state, cfg, rng=None):
        if state.window.dim() == 0:
            return drop(scheduler(lift(state), cfg, rng))
        idx, valid, base_ok, scores = base_pass(state, cfg)
        pref = propose_lanes([propose] * idx.shape[0], state, cfg, rng, idx,
                             valid, base_ok, scores)
        return finalize(state, cfg, idx, valid, base_ok, pref,
                        dynamic_bestfit=dynamic_bestfit)

    scheduler.__name__ = name
    scheduler.__qualname__ = f"scheduler<{name}>"
    _REGISTRY[name] = SchedulerEntry(
        name=name, propose=propose, entry=scheduler,
        dynamic_bestfit=dynamic_bestfit,
        doc=doc if doc is not None else (propose.__doc__ or "").strip(),
        table_form=table_form)
    SCHEDULERS[name] = scheduler
    PROPOSERS[name] = propose
    DYNAMIC_BESTFIT[name] = dynamic_bestfit
    TABLE_FORMS[name] = table_form
    return scheduler


def unregister_scheduler(name: str) -> None:
    """Remove a registered scheduler (plugin teardown)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; have {list(_REGISTRY)}")
    del _REGISTRY[name]
    del SCHEDULERS[name]
    del PROPOSERS[name]
    del DYNAMIC_BESTFIT[name]
    del TABLE_FORMS[name]


def snapshot_dispatch(scheduler_names: Tuple[str, ...]) -> DispatchTable:
    """Freeze the registry rows ``scheduler_names`` into an immutable
    :class:`DispatchTable` — the fleet's dispatch contract, taken once at
    fleet build time, so later registrations cannot retarget it."""
    entries = [get_entry(n) for n in scheduler_names]
    return DispatchTable(
        names=tuple(scheduler_names),
        proposers=tuple(e.propose for e in entries),
        dynamic=tuple(e.dynamic_bestfit for e in entries),
        forms=tuple(e.table_form for e in entries))


def get_entry(name: str) -> SchedulerEntry:
    if name in _REGISTRY:
        return _REGISTRY[name]
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
