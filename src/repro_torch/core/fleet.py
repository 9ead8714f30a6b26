"""Scheduler fleets — the paper's multi-machine deployment (§V: "AGOCS can
be deployed on multiple machines"; §IV runs 5 schedulers at reduced speed
on one laptop).

Here a *fleet* is N replicas of one scheduler consuming ONE workload, each
with its own key stream (replica ``i`` seeded ``seed + i``): the
Monte-Carlo mode used for scheduler hyperparameter sweeps. The replicas run
one after another on the windows' device, each from its own empty world
(the engine updates a state in place, so replicas cannot share one), and
come back stacked on a leading replica axis, as the reference's ``vmap``
returns them.

The reference's ``fleet_shardings`` and ``lower_fleet`` lower a fleet step
onto a TPU production mesh for the dry-run planners; they come with the
port of those planners (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.config import SimConfig
from repro_torch.core import engine as engine_mod
from repro_torch.core.events import EventWindow
from repro_torch.core.state import SimState, init_state
from repro_torch.sched import get_scheduler


def fleet_fn(cfg: SimConfig, scheduler: str, n_replicas: int):
    """``step(windows, seeds) -> (final states, stats)``: one replica a
    seed, over stacked (W, ...) windows of tensors, stacked on a leading
    replica axis."""
    scheduler_fn = get_scheduler(scheduler)

    def step(windows: EventWindow, seeds: Sequence[int]
             ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
        seeds = [int(s) for s in seeds]
        if len(seeds) != n_replicas:
            raise ValueError(f"{len(seeds)} seeds for {n_replicas} replicas")
        device = windows.kind.device
        states, stats = [], []
        for s in seeds:
            st, rows = engine_mod.run_windows(init_state(cfg, device),
                                              windows, cfg, scheduler_fn,
                                              seed=s)
            states.append(st)
            stats.append(rows)
        return (SimState(*[torch.stack(f) for f in zip(*states)]),
                {k: torch.stack([r[k] for r in stats]) for k in stats[0]})

    return step


def run_fleet(windows: EventWindow, cfg: SimConfig, scheduler: str,
              n_replicas: int, seed: int = 0
              ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
    """Run ``n_replicas`` copies of one scheduler over the same windows (a
    stacked EventWindow of tensors, e.g. ``events.window_to_torch``), with
    different key streams. Returns stacked final states + stacked stats."""
    return fleet_fn(cfg, scheduler, n_replicas)(
        windows, range(seed, seed + n_replicas))
