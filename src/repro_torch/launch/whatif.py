"""Batched what-if studies over one trace — the scenario-fleet CLI of the
port.

  # 2 schedulers x {baseline, 20% outage} = 4 scenarios from ONE parse,
  # on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.whatif --nodes 32 --jobs 40 \
      --windows 30 --schedulers greedy,first_fit --outage 0,0.2 \
      --device cpu

  # the paper's cell A on the card, with arrival amplification:
  PYTHONPATH=src python -m repro_torch.launch.whatif --cell-a --jobs 16000 \
      --windows 32 --schedulers greedy,first_fit,round_robin \
      --arrival 1.0,1.5

  # pre-compile the trace once (reserving injection headroom so later
  # replays can amplify), then replay sweeps with zero parsing — in replay
  # mode the window geometry comes from the stack, not from flags:
  PYTHONPATH=src python -m repro_torch.launch.whatif --trace-dir /data/gcd \
      --windows 500 --precompile /tmp/gcd.npz --inject-slots 64 \
      --schedulers greedy,simulated_annealing --capacity 1.0,0.8
  PYTHONPATH=src python -m repro_torch.launch.whatif --replay /tmp/gcd.npz \
      --windows 500 --arrival 1.0,1.5,2.0

Sweep axes multiply (cartesian grid). Every scenario sees the same parsed
event stream; divergence is injected on the device
(repro_torch/scenarios/perturb.py). Prints the reference CLI's comparison
table. ``--serve`` hands the remaining flags to the what-if service's CLI
(``launch/serve_whatif.py``).

  # the lanes split over 4 gloo ranks on the CPU (one process a rank), or
  # over the card at world size 1 (NCCL):
  torchrun --nproc-per-node 4 -m repro_torch.launch.whatif --mesh 4 \
      --device cpu --nodes 32 --jobs 40 --windows 30 \
      --schedulers greedy,first_fit --outage 0,0.2
  PYTHONPATH=src python -m repro_torch.launch.whatif --cell-a --mesh 1 \
      --jobs 16000 --windows 32

Under ``--mesh`` every rank parses (or replays) the same trace; rank 0
alone prints the table and writes ``--json`` and ``--snapshot``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time

import torch

from repro_torch.config import REDUCED_SIM, SimConfig
from repro_torch.configs import get_sim_config
from repro_torch.core import tracegen
from repro_torch.core.precompile import (overflow_warning, precompile_trace,
                                         stack_parse_stats)
from repro_torch.device import resolve_device
from repro_torch import parsers as trace_parsers
from repro_torch.scenarios import (ScenarioFleet, expand_grid, fleet_mesh,
                                   format_table)
from repro_torch.scenarios.report import to_json


def _floats(s: str):
    return [float(x) for x in s.split(",") if x != ""]


def build_cfg(args) -> SimConfig:
    cfg = get_sim_config() if args.cell_a else REDUCED_SIM
    over = {}
    if args.nodes:
        over["max_nodes"] = args.nodes
        over.setdefault("max_tasks", max(args.nodes * 16, 512))
    if args.tasks:
        over["max_tasks"] = args.tasks
    if args.use_kernels:
        over["use_kernels"] = True
    if args.stats_stride != 1:      # 0/negative hit SimConfig's validator
        over["stats_stride"] = args.stats_stride
    if args.dispatch:
        over["sched_dispatch"] = args.dispatch
    if not args.cell_a:
        over.setdefault("max_events_per_window", 4096)
        over.setdefault("sched_batch", 256)
    inject = args.inject_slots
    if inject is None and args.arrival and max(_floats(args.arrival)) > 1.0:
        # amplification needs reserved rows; default to 1/8 of the window,
        # bounded so the auto-sized task-slot pool (max_tasks/4) holds at
        # least one window's worth of injections
        E = over.get("max_events_per_window") or cfg.max_events_per_window
        T = over.get("max_tasks") or cfg.max_tasks
        inject = max(1, min(E // 8, T // 4))
    if inject:
        over["inject_slots"] = inject
    return dataclasses.replace(cfg, **over)


def build_specs(args):
    axes = {"scheduler": args.schedulers.split(",")}
    if args.outage:
        axes["node_outage_frac"] = _floats(args.outage)
    if args.capacity:
        axes["capacity_scale"] = _floats(args.capacity)
    if args.arrival:
        axes["arrival_rate"] = _floats(args.arrival)
    if args.surge:
        axes["priority_surge_frac"] = _floats(args.surge)
    if args.usage_scale:
        axes["usage_scale"] = _floats(args.usage_scale)
    if args.storm:
        axes["evict_storm_frac"] = _floats(args.storm)
    return expand_grid(**axes)


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "--serve" in argv:
        # persistent serving mode: warm fleet geometry, micro-batched
        # queries, fork points — its own flag set, in launch/serve_whatif.py
        argv.remove("--serve")
        from repro_torch.launch.serve_whatif import main as serve_main
        return serve_main(argv)
    ap = argparse.ArgumentParser(
        description="batched what-if scenario fleet over one trace")
    ap.add_argument("--trace-dir", default=None,
                    help="trace dir in --trace-family's schema "
                         "(default: synthesise one)")
    ap.add_argument("--trace-family", default="gcd",
                    help="trace parser family (see --list-families)")
    ap.add_argument("--list-families", action="store_true",
                    help="print the trace-parser registry and exit")
    ap.add_argument("--cell-a", action="store_true",
                    help="the paper's 12.5K-node cell configuration")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--tasks", type=int, default=None)
    ap.add_argument("--jobs", type=int, default=400)
    ap.add_argument("--windows", type=int, default=200)
    ap.add_argument("--schedulers", default="greedy",
                    help="comma list; every scheduler multiplies the grid "
                         "(any repro_torch.sched registry name)")
    ap.add_argument("--list-schedulers", action="store_true",
                    help="print the scheduler registry and exit")
    ap.add_argument("--outage", default=None, help="comma list of fractions")
    ap.add_argument("--capacity", default=None, help="comma list of scales")
    ap.add_argument("--arrival", default=None,
                    help="comma list of rates (<1 thins, >1 amplifies)")
    ap.add_argument("--surge", default=None, help="priority-surge fractions")
    ap.add_argument("--usage-scale", default=None, help="usage inflations")
    ap.add_argument("--storm", default=None, help="eviction-storm fractions")
    ap.add_argument("--baseline", type=int, default=0,
                    help="scenario index deltas are computed against")
    ap.add_argument("--use-kernels", action="store_true",
                    help="kept for parity with the reference's CLI; the port "
                         "always runs the CUDA kernels on the card")
    ap.add_argument("--stats-stride", type=int, default=1,
                    help="emit fleet stats rows every k-th window")
    ap.add_argument("--batch-windows", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject-slots", type=int, default=None,
                    help="event rows per window reserved for SUBMIT "
                         "injection (default: auto-sized when any "
                         "--arrival rate > 1)")
    ap.add_argument("--dispatch", default=None,
                    choices=("auto", "switch", "table"),
                    help="scheduler dispatch (cfg.sched_dispatch): auto "
                         "picks switchless when every lane's scheduler has "
                         "a table form, switch forces the per-lane proposal "
                         "path, table demands switchless")
    ap.add_argument("--mesh", default=None,
                    help="shard lanes over an N-rank ('data',) mesh (an "
                         "integer, or 'auto' for the world size; launch N > "
                         "1 with torchrun --nproc-per-node N); specs are "
                         "padded up to a multiple of N")
    ap.add_argument("--precompile", default=None,
                    help="pre-compile the trace to this npz (§V-A), then "
                         "replay the sweep from it")
    ap.add_argument("--replay", default=None,
                    help="feed the fleet from an existing pre-compiled npz "
                         "(zero parsing; overrides --trace-dir)")
    ap.add_argument("--start-window", type=int, default=0,
                    help="with --replay: skip into the stack and simulate "
                         "from this window (chunked stacks only decompress "
                         "the covered range)")
    ap.add_argument("--json", default=None, help="write full report here")
    ap.add_argument("--snapshot", default=None,
                    help="write a batched fleet snapshot here at the end")
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
    mesh, started = None, False
    if args.mesh:
        import torch.distributed as dist
        started = not dist.is_initialized()
        try:
            mesh = fleet_mesh(None if args.mesh == "auto" else int(args.mesh),
                              args.device)
        except ValueError as e:
            ap.error(str(e))
    try:
        return _sweep(ap, args, family, parser_cls, mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _sweep(ap, args, family, parser_cls, mesh):
    """The sweep itself; under a mesh every rank runs it, rank 0 alone
    prints and writes the report."""
    rank0 = mesh is None or mesh.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    device = resolve_device(args.device)

    cfg = build_cfg(args)
    if args.replay:
        # replay can't re-shape persisted tensors: the stack's embedded
        # window geometry (incl. the injection slot pool) wins over flags
        from repro_torch.core.precompile import replay_config
        cfg = replay_config(args.replay, cfg)
        say(f"replaying {args.replay}: window geometry from the stack "
            f"(E={cfg.max_events_per_window}, "
            f"inject_slots={cfg.inject_slots})")
    specs = build_specs(args)
    if mesh is not None:
        n_dev = mesh.size()
        say(f"mesh: {n_dev} devices over ('data',)"
            + (f", padding {(-len(specs)) % n_dev} lanes"
               if len(specs) % n_dev else ""))
    say(f"{len(specs)} scenarios "
        f"({len(args.schedulers.split(','))} schedulers):")
    for i, s in enumerate(specs):
        say(f"  [{i}] {s.name}: {s.describe()}")

    tmp = None
    trace_dir = args.trace_dir
    if trace_dir is None and args.replay is None:
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
        say(f"generated {family}-schema trace: {summary} "
            f"({time.time()-t0:.1f}s)")

    start = trace_parsers.default_start_us(family, cfg)
    replay_path = args.replay
    if args.precompile and replay_path is None:
        t0, n = time.time(), None
        if rank0:           # one writer; the other ranks replay its stack
            n = precompile_trace(cfg, trace_dir, args.precompile,
                                 args.windows, start_us=start, family=family)
        if mesh is not None:
            torch.distributed.barrier(group=mesh.get_group())
        say(f"pre-compiled {n} windows -> {args.precompile} "
            f"({time.time()-t0:.1f}s)")
        warn = overflow_warning(stack_parse_stats(args.precompile))
        if warn:
            say(warn)
        replay_path = args.precompile

    if replay_path is not None:
        if args.start_window:
            from repro_torch.core.precompile import stack_n_windows
            n_stack = stack_n_windows(replay_path)
            if args.start_window < 0 or args.start_window >= n_stack:
                ap.error(f"--start-window {args.start_window} is outside "
                         f"the stack's [0, {n_stack})")
        fleet = ScenarioFleet.from_precompiled(
            cfg, replay_path, specs, batch_windows=args.batch_windows,
            seed=args.seed, mesh=mesh, n_windows=args.windows,
            start_window=args.start_window, device=device)
    else:
        if args.start_window:
            ap.error("--start-window needs --replay (a chunked stack)")
        parser = parser_cls(cfg, trace_dir)
        source = parser.packed_windows(args.windows, start_us=start)
        fleet = ScenarioFleet(cfg, source, specs,
                              batch_windows=args.batch_windows,
                              seed=args.seed, mesh=mesh, device=device)
    t0 = time.time()
    fleet.run()
    wall = time.time() - t0
    if replay_path is None:
        warn = overflow_warning(parser.stats)
        if warn:
            say(warn)
    sim_s = fleet.windows_done * cfg.window_us / 1e6
    say(f"simulated {fleet.windows_done} windows x {fleet.n_scenarios} "
        f"scenarios ({sim_s:.0f} sim-s each, {fleet.n_lanes} device lanes) "
        f"in {wall:.2f}s wall on "
        f"{device} -> {sim_s * fleet.n_scenarios / wall:.1f}x aggregate "
        f"speed factor, {'zero parses' if replay_path else 'one parse'}")

    report = fleet.report(baseline=args.baseline)
    say(format_table(report))
    if args.json and rank0:
        to_json(report, args.json)
        say(f"report -> {args.json}")
    if args.snapshot:
        fleet.save(args.snapshot)          # every rank: a gather
        say(f"fleet snapshot -> {args.snapshot}")
    if tmp:
        tmp.cleanup()
    return report


if __name__ == "__main__":
    main()
