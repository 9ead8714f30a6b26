"""Batched what-if study: parse ONE synthetic GCD trace, then simulate 8
divergent scenarios (2 schedulers x 4 perturbation worlds — including a
doubled-arrival world fed by the injection slot pool) as one lane-batched
fleet, and compare them against the baseline lane.

The port of ``examples/scenario_sweep.py``: the same steps, defaults and
lines, on the CUDA card unless ``--device cpu`` is passed. ``--mesh N``
shards the lanes over a ('data',) mesh of N ranks, one process a device:
N must equal the world size (``--mesh 1`` runs alone, a world of 1 over
NCCL on the card or gloo on the CPU; N > 1 under ``torchrun
--nproc-per-node N``, where rank 0 prints). A world this script starts
is destroyed before it returns.

Run:  PYTHONPATH=src python examples/torch/scenario_sweep.py [--nodes 64]
      [--mesh N]   # shard the scenario lanes over N ranks
      [--device cpu]
"""
import argparse
import tempfile
import time

import torch.distributed as dist

from repro_torch.config import SimConfig
from repro_torch.core.state import lane, validate_invariants
from repro_torch.core.tracegen import SHIFT_US, generate_trace
from repro_torch.device import resolve_device
from repro_torch.parsers.gcd import GCDParser
from repro_torch.scenarios import (ScenarioFleet, ScenarioSpec, expand_grid,
                                   fleet_mesh, format_table)
from repro_torch.scenarios.batch import gather_over_fleet


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--jobs", type=int, default=160)
    ap.add_argument("--windows", type=int, default=100)
    ap.add_argument("--mesh", type=int, default=None,
                    help="shard lanes over an N-rank ('data',) mesh")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises if there is none)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    started = bool(args.mesh) and not dist.is_initialized()
    try:
        mesh = fleet_mesh(args.mesh, device) if args.mesh else None
        return _sweep(args, device, mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _sweep(args, device, mesh) -> dict:
    say = print if mesh is None or mesh.get_rank() == 0 else (
        lambda *a, **k: None)
    # inject_slots reserves rows per window so arrival_rate > 1 lanes can
    # synthesise real extra SUBMITs (true amplification, not a proxy);
    # bounded so the auto-sized task-id pool (max_tasks/4) always fits it
    cfg = SimConfig(max_nodes=args.nodes, max_tasks=args.nodes * 24,
                    max_events_per_window=4096, sched_batch=256,
                    n_attr_slots=12, max_constraints=4,
                    inject_slots=min(128, args.nodes * 24 // 4))
    start = SHIFT_US - cfg.window_us

    # 2 schedulers x 4 worlds: baseline, 25% node outage, doubled arrivals,
    # and an eviction storm — every combination is one lane
    specs = expand_grid(
        scheduler=["greedy", "first_fit"],
        node_outage_frac=[0.0, 0.25],
        arrival_rate=[1.0, 2.0],
    )
    # make one lane a storm world instead of the redundant combined corner
    specs[3] = ScenarioSpec(name="greedy/storm", scheduler="greedy",
                            evict_storm_frac=0.02)
    specs[7] = ScenarioSpec(name="first_fit/storm", scheduler="first_fit",
                            evict_storm_frac=0.02)
    say(f"{len(specs)} scenarios in one device program:")
    for i, s in enumerate(specs):
        say(f"  [{i}] {s.name}: {s.describe()}")

    with tempfile.TemporaryDirectory() as d:
        summary = generate_trace(d, n_machines=args.nodes, n_jobs=args.jobs,
                                 horizon_windows=args.windows, seed=0,
                                 usage_period_us=20_000_000)
        say(f"\ntrace: {summary.n_tasks} tasks, "
            f"{summary.n_task_events} task events — parsed ONCE\n")

        parser = GCDParser(cfg, d)
        fleet = ScenarioFleet(
            cfg, parser.packed_windows(args.windows, start_us=start),
            specs, batch_windows=25, mesh=mesh, device=device)
        t0 = time.time()
        fleet.run()
        wall = time.time() - t0

        # every rank checks every lane (a mesh gathers them)
        state = gather_over_fleet(fleet.state, mesh)
        for b, spec in enumerate(specs):
            assert validate_invariants(lane(state, b), cfg) == {}, spec.name

        sim_s = fleet.windows_done * cfg.window_us / 1e6
        say(f"simulated {fleet.windows_done} windows x {len(specs)} "
            f"scenarios in {wall:.2f}s wall "
            f"({sim_s * len(specs) / wall:.0f}x aggregate speed factor)\n")
        report = fleet.report(baseline=0)
        say(format_table(report))

        placed = [r["placements"] for r in report["scenarios"]]
        assert len(set(placed)) > 1, "scenarios should diverge"
        say("\nper-scenario divergence confirmed "
            f"(placements span {min(placed)}..{max(placed)})")
    return dict(n_tasks=summary.n_tasks,
                n_task_events=summary.n_task_events,
                windows=fleet.windows_done, lanes=len(specs), wall_s=wall,
                lane_windows_per_s=fleet.windows_done * len(specs) / wall,
                report=report, placed=placed)


if __name__ == "__main__":
    main()
