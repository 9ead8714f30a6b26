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

``lower_fleet`` is the simulator's own production-mesh dry-run entry: on a
mesh of the planner's fake world (``launch.dryrun.fake_world``) it runs
this rank's share of the replicas for real and returns a plan with the
counted cost and memory, as the reference lowers and compiles a fleet
step on the 16x16 / 2x16x16 mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config import SimConfig
from repro_torch.core import engine as engine_mod
from repro_torch.core.events import (EventWindow, empty_window, stack_windows,
                                     window_to_torch)
from repro_torch.core.state import SimState, init_state
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import NamedSharding, P, axis_sizes
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


def fleet_shardings(cfg: SimConfig, mesh):
    """Replicas over (pod, data); windows replicated; states:
    replica-sharded. Returns (windows' sharding, seeds' sharding, a
    function of a state leaf's ndim to its sharding)."""
    dp = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    dpx = dp if len(dp) > 1 else dp[0]
    rep = NamedSharding(mesh, P())
    seeds = NamedSharding(mesh, P(dpx))

    def state_spec(leaf_ndim):
        return NamedSharding(mesh, P(*((dpx,) + (None,) * leaf_ndim)))
    return rep, seeds, state_spec


#: the ctypes kernels a fleet step may launch, by name
FLEET_KERNELS = (
    ("constraint_match", "repro_torch.kernels.constraint_match.ops",
     "constraint_match_cuda"),
    ("placement_commit", "repro_torch.kernels.placement_commit.ops",
     "placement_commit_cuda"),
    ("window_stats", "repro_torch.kernels.window_stats.ops",
     "window_stats_cuda"),
    ("sched_commit", "repro_torch.kernels.placement_commit.ops",
     "sched_commit_cuda"),
    ("segment_usage", "repro_torch.kernels.segment_usage.ops",
     "segment_usage_cuda"),
)


def _kernel_counts() -> Dict[str, int]:
    import importlib
    return {name: getattr(importlib.import_module(mod), fn).launches
            for name, mod, fn in FLEET_KERNELS}


@dataclasses.dataclass
class FleetPlan:
    """This rank's share of a fleet step, run: its replicas' indices (each
    replica seeded with its index, as ``run_fleet``'s), their stacked
    final states and stats, the launches of each
    ctypes kernel (which a dispatch mode does not see), the seconds it
    took, and the counted cost and memory of the torch ops."""

    replicas: List[int]
    states: SimState
    stats: Dict[str, torch.Tensor]
    kernel_launches: Dict[str, int]
    seconds: float
    cost: Dict[str, Any]
    memory: Any

    def cost_analysis(self) -> Dict[str, float]:
        """{"flops", "bytes accessed"} of this rank's torch ops (XLA's
        names)."""
        return {"flops": self.cost["flops"],
                "bytes accessed": self.cost["bytes"]}

    def memory_analysis(self):
        """Argument, output, temp and alias bytes
        (``launch.plan_cost.MemoryAnalysis``)."""
        return self.memory


def lower_fleet(cfg: SimConfig, mesh, scheduler: str = "greedy",
                n_replicas: Optional[int] = None, n_windows: int = 8,
                windows: Optional[EventWindow] = None,
                device=None) -> FleetPlan:
    """Plan a fleet step on a production mesh (simulator dry-run).

    Replica count defaults to the data-parallel degree of the mesh (one
    replica per data shard — the paper's '5 concurrent schedulers' scaled to
    the mesh width). Replicas split over ('pod', 'data') as the reference's
    shardings place them, windows replicated: this rank (rank 0 of the
    planner's fake world) runs its block of replicas for real through
    :func:`fleet_fn`, counted by ``launch.plan_cost.PlanCounter``. ``windows``: stacked (W, ...) windows
    of tensors, their first ``n_windows`` run; by default ``n_windows``
    empty windows on ``device`` (the reference lowers on shapes alone).
    The simulator's state is small, so no collective is needed."""
    from repro_torch.launch.plan_cost import PlanCounter
    sizes = axis_sizes(mesh)
    dp_deg = sizes.get("data", 1) * sizes.get("pod", 1)
    n_replicas = n_replicas or dp_deg
    _, replica_sh, _ = fleet_shardings(cfg, mesh)
    mine = replica_sh.local_block(torch.arange(n_replicas)).tolist()
    if windows is None:
        windows = window_to_torch(
            stack_windows([empty_window(cfg)] * n_windows),
            resolve_device(device))
    else:
        windows = EventWindow(*[f[:n_windows] for f in windows])
    before = _kernel_counts()
    counter = PlanCounter()
    counter.hold(windows)
    t0 = time.time()
    with counter:
        states, stats = fleet_fn(cfg, scheduler, len(mine))(windows, mine)
    if windows.kind.device.type == "cuda":
        torch.cuda.synchronize(windows.kind.device)
    seconds = time.time() - t0
    after = _kernel_counts()
    return FleetPlan(
        replicas=mine, states=states, stats=stats,
        kernel_launches={k: after[k] - before[k] for k in after},
        seconds=seconds, cost=counter.cost(),
        memory=counter.memory_analysis((states, stats)))
