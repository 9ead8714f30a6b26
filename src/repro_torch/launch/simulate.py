"""AGOCS simulation driver on the PyTorch port.

  # synthetic GCD-schema trace at the paper's cell-A width, on the card:
  PYTHONPATH=src python -m repro_torch.launch.simulate --cell-a \
      --jobs 16000 --windows 64

  # a small cell on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.simulate --nodes 32 \
      --jobs 40 --windows 30 --device cpu

  # §V-A pre-compiled replay, a stochastic scheduler, a snapshot at the end:
  ... --scheduler simulated_annealing --precompile /tmp/events.npz \
      --snapshot /tmp/sim.npz

Prints the same stats JSON and ``invariants: OK`` as the reference's CLI.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

from repro_torch.config import REDUCED_SIM, SimConfig
from repro_torch.configs import get_sim_config
from repro_torch.core import precompile as precompile_mod
from repro_torch.core import tracegen
from repro_torch.core.pipeline import Simulation
from repro_torch.core.snapshot import save_snapshot
from repro_torch.core.state import validate_invariants
from repro_torch.device import resolve_device
from repro_torch import parsers as trace_parsers


def build_cfg(args) -> SimConfig:
    cfg = get_sim_config() if args.cell_a else REDUCED_SIM
    over = {}
    if args.nodes:
        over["max_nodes"] = args.nodes
    if args.tasks:
        over["max_tasks"] = args.tasks
    if args.scheduler:
        over["scheduler"] = args.scheduler
    if args.speed_factor:
        over["speed_factor"] = args.speed_factor
    if args.use_kernels:
        over["use_kernels"] = True
    if args.stats_stride != 1:      # 0/negative hit SimConfig's validator
        over["stats_stride"] = args.stats_stride
    if args.nodes and not args.tasks:
        over["max_tasks"] = max(args.nodes * 16, 512)
    if not args.cell_a:
        over.setdefault("max_events_per_window", 4096)
        over.setdefault("sched_batch", 256)
    return dataclasses.replace(cfg, **over)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--trace-family", default="gcd",
                    help="trace parser family (see --list-families); "
                         "synthetic traces are generated in this schema too")
    ap.add_argument("--list-families", action="store_true",
                    help="print the trace-parser registry and exit")
    ap.add_argument("--cell-a", action="store_true",
                    help="the paper's 12.5K-node Google cell configuration")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--tasks", type=int, default=None)
    ap.add_argument("--jobs", type=int, default=400)
    ap.add_argument("--windows", type=int, default=200)
    ap.add_argument("--scheduler", default="greedy",
                    help="any repro_torch.sched registry name")
    ap.add_argument("--list-schedulers", action="store_true",
                    help="print the scheduler registry and exit")
    ap.add_argument("--speed-factor", type=float, default=0.0)
    ap.add_argument("--use-kernels", action="store_true",
                    help="kept for parity with the reference's CLI; the port "
                         "always runs the CUDA kernels on the card")
    ap.add_argument("--stats-stride", type=int, default=1,
                    help="emit a stats row every k-th window")
    ap.add_argument("--precompile", default=None,
                    help="path: pre-compile events to npz then replay (§V-A)")
    ap.add_argument("--snapshot", default=None,
                    help="write a pausable snapshot here at the end")
    ap.add_argument("--batch-windows", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the CUDA card (raises if there is none)")
    args = ap.parse_args(argv)

    if args.list_schedulers:
        from repro_torch.sched import describe_schedulers
        print(describe_schedulers())
        raise SystemExit(0)
    if args.list_families:
        print(trace_parsers.describe_parsers())
        raise SystemExit(0)
    family = args.trace_family
    parser_cls = trace_parsers.get_parser(family)      # fail fast on typos
    device = resolve_device(args.device)

    cfg = build_cfg(args)
    tmp = None
    trace_dir = args.trace_dir
    if trace_dir is None:
        tmp = tempfile.TemporaryDirectory()
        trace_dir = tmp.name
        t0 = time.time()
        if family == "openb":
            from repro_torch.parsers.alibaba_openb import generate_openb_trace
            summary = generate_openb_trace(
                trace_dir, n_nodes=cfg.max_nodes, n_pods=args.jobs * 4,
                horizon_s=int(args.windows * cfg.window_us / 1e6),
                seed=args.seed)
        else:
            summary = tracegen.generate_trace(
                trace_dir, n_machines=cfg.max_nodes, n_jobs=args.jobs,
                horizon_windows=args.windows, seed=args.seed,
                usage_period_us=max(cfg.window_us * 4, 20_000_000))
        print(f"generated {family}-schema trace: {summary} "
              f"({time.time()-t0:.1f}s)")

    start_us = trace_parsers.default_start_us(family, cfg)
    t0 = time.time()
    if args.precompile:
        n = precompile_mod.precompile_trace(cfg, trace_dir, args.precompile,
                                            args.windows, start_us=start_us,
                                            family=family)
        print(f"pre-compiled {n} windows -> {args.precompile} "
              f"({time.time()-t0:.1f}s)")
        warn = precompile_mod.overflow_warning(
            precompile_mod.stack_parse_stats(args.precompile))
        if warn:
            print(warn)
        source = precompile_mod.replay_single_windows(args.precompile)
        parser = None
    else:
        parser = parser_cls(cfg, trace_dir)
        source = parser.packed_windows(args.windows, start_us=start_us)

    sim = Simulation(cfg, source, scheduler=args.scheduler,
                     batch_windows=args.batch_windows, seed=args.seed,
                     device=device)
    t0 = time.time()
    state = sim.run()
    wall = time.time() - t0
    sf = sim.stats_frame()
    sim_seconds = sim.windows_done * cfg.window_us / 1e6
    print(f"simulated {sim.windows_done} windows ({sim_seconds:.0f} sim-s) "
          f"in {wall:.2f}s wall on {device} -> speed factor "
          f"{sim_seconds / wall:.1f}x")
    print(json.dumps(summary_row(args.scheduler, sf), indent=1))
    problems = validate_invariants(state, cfg)
    print("invariants:", problems or "OK")
    if parser is not None:
        print("parser:", parser.stats)
        warn = precompile_mod.overflow_warning(parser.stats)
        if warn:
            print(warn)
    if args.snapshot:
        save_snapshot(args.snapshot, state, cfg, sim.windows_done)
        print(f"snapshot -> {args.snapshot}")
    if tmp:
        tmp.cleanup()
    return sf


def summary_row(scheduler: str, sf) -> dict:
    """The final-window summary the CLI prints (the reference's keys)."""
    return {
        "scheduler": scheduler,
        "n_running_final": int(sf["n_running"][-1]),
        "n_pending_final": int(sf["n_pending"][-1]),
        "placements": int(sf["placements"][-1]),
        "completions": int(sf["completions"][-1]),
        "evictions": int(sf["evictions"][-1]),
        "cpu_reserved_frac": float(sf["reserved_frac"][-1][0]),
        "cpu_used_frac": float(sf["used_frac"][-1][0]),
        "overestimate_frac": float(sf["overestimate_frac"][-1][0]),
        "util_balance_var": float(sf["util_balance_var"][-1]),
    }


if __name__ == "__main__":
    main()
