"""Persistent what-if serving CLI — `whatif --serve` lands here.

Stands up an in-process :class:`repro_torch.service.WhatIfServer` over a
pre-compiled trace stack (given via --replay, or synthesised + pre-compiled
on the spot), optionally builds fork points, then fires a demonstration
burst of concurrent queries through the micro-batcher and prints each
result row plus the serving metrics. It doubles as the service's smoke
entry point. It runs on the card unless ``--device cpu`` is passed.

  # synthesise a trace, serve 8-lane micro-batches of two schedulers,
  # fork points every 32 windows, demo burst incl. a fork-point query:
  PYTHONPATH=src python -m repro_torch.launch.whatif --serve --windows 96 \
      --schedulers greedy,first_fit --fork-every 32 --query-windows 32

  # against an existing stack:
  PYTHONPATH=src python -m repro_torch.launch.serve_whatif \
      --replay /tmp/gcd.npz --schedulers greedy --query-windows 64 \
      --json /tmp/serve.json

  # on the CPU (the plain PyTorch versions of the kernels), under chaos:
  PYTHONPATH=src python -m repro_torch.launch.serve_whatif --nodes 32 \
      --jobs 60 --windows 64 --schedulers greedy --max-lanes 4 \
      --batch-windows 32 --query-windows 32 \
      --chaos "engine_launch:transient:2" --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import tempfile
import time

from repro_torch.config import REDUCED_SIM, SimConfig
from repro_torch.core import tracegen
from repro_torch.core.precompile import precompile_trace
from repro_torch.device import resolve_device
from repro_torch.resilience import FaultPlan, armed
from repro_torch.scenarios import ScenarioSpec, format_table
from repro_torch.service import WhatIfQuery, WhatIfServer


def build_cfg(args) -> SimConfig:
    cfg = REDUCED_SIM
    over = {"max_events_per_window": 4096, "sched_batch": 256}
    if args.nodes:
        over["max_nodes"] = args.nodes
        over["max_tasks"] = max(args.nodes * 16, 512)
    return dataclasses.replace(cfg, **over)


def demo_queries(args, schedulers, fork_windows):
    """The demonstration burst: per-scheduler outage sweeps from window 0,
    plus (when fork points exist) per-scheduler continuations from the last
    fork window — all submitted concurrently."""
    outages = [float(x) for x in args.outage.split(",") if x != ""]
    qs = []
    for sched in schedulers:
        for o in outages:
            spec = ScenarioSpec(name=f"{sched}/outage={o:g}", scheduler=sched,
                                node_outage_frac=o)
            qs.append(WhatIfQuery(spec, n_windows=args.query_windows,
                                  seed=args.seed))
    usable = [w for w in fork_windows if w < args.windows]
    if usable:
        w = usable[-1]       # the last fork point with trace left after it
        n = min(args.query_windows, args.windows - w)
        for sched in schedulers:
            spec = ScenarioSpec(name=f"{sched}@w{w}", scheduler=sched)
            qs.append(WhatIfQuery(spec, n_windows=n, start_window=w,
                                  seed=args.seed))
    return qs


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="persistent what-if serving over a pre-compiled stack")
    ap.add_argument("--trace-dir", default=None,
                    help="GCD-format trace dir (default: synthesise one)")
    ap.add_argument("--replay", default=None,
                    help="existing pre-compiled npz (skips trace synthesis)")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--jobs", type=int, default=400)
    ap.add_argument("--windows", type=int, default=96,
                    help="stack length when pre-compiling here")
    ap.add_argument("--schedulers", default="greedy,first_fit",
                    help="the serving table (fixed at compile time)")
    ap.add_argument("--max-lanes", type=int, default=8,
                    help="compiled lane count = micro-batch capacity")
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="micro-batching window before a partial launch")
    ap.add_argument("--batch-windows", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fork-every", type=int, default=0,
                    help="build fork points every N windows (multiple of "
                         "--batch-windows; 0 disables)")
    ap.add_argument("--query-windows", type=int, default=32,
                    help="windows each demo query simulates")
    ap.add_argument("--outage", default="0,0.2",
                    help="comma outage fractions for the demo burst")
    ap.add_argument("--json", default=None,
                    help="write rows + metrics JSON here")
    ap.add_argument("--chaos", default=None,
                    help="arm a fault plan around the demo burst, e.g. "
                         "'engine_launch:transient:2,chunk_load:latency:2:0.02'"
                         " — queries must still succeed (after retries)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the CUDA card (raises if there is none)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    schedulers = args.schedulers.split(",")
    cfg = build_cfg(args)

    tmp = None
    replay_path = args.replay
    if replay_path is None:
        tmp = tempfile.TemporaryDirectory()
        trace_dir = args.trace_dir
        if trace_dir is None:
            trace_dir = tmp.name
            t0 = time.time()
            summary = tracegen.generate_trace(
                trace_dir, n_machines=cfg.max_nodes, n_jobs=args.jobs,
                horizon_windows=args.windows, seed=args.seed,
                usage_period_us=max(cfg.window_us * 4, 20_000_000))
            print(f"generated trace: {summary} ({time.time()-t0:.1f}s)")
        replay_path = f"{tmp.name}/stack.npz"
        t0 = time.time()
        n = precompile_trace(cfg, trace_dir, replay_path, args.windows,
                             start_us=tracegen.SHIFT_US - cfg.window_us)
        print(f"pre-compiled {n} windows -> {replay_path} "
              f"({time.time()-t0:.1f}s)")

    t0 = time.time()
    server = WhatIfServer(cfg, replay_path, schedulers=schedulers,
                          max_lanes=args.max_lanes,
                          max_wait_s=args.max_wait_ms / 1e3,
                          batch_windows=args.batch_windows, seed=args.seed,
                          device=device)
    server.start(warm=True)
    print(f"server warm ({len(schedulers)} schedulers x "
          f"{args.max_lanes} lanes) on {device} in {time.time()-t0:.1f}s")

    fork_windows = []
    if args.fork_every:
        t0 = time.time()
        trunk = [ScenarioSpec(name=f"trunk/{s}", scheduler=s)
                 for s in schedulers]
        fork_windows = server.build_fork_points(trunk, args.fork_every)
        print(f"fork points at windows {fork_windows} "
              f"({time.time()-t0:.1f}s)")

    queries = demo_queries(args, schedulers, fork_windows)
    plan = FaultPlan.parse(args.chaos, seed=args.seed) if args.chaos \
        else None
    if plan is not None:
        print(f"chaos armed: {args.chaos}")
    print(f"submitting {len(queries)} concurrent queries ...")
    t0 = time.time()
    with (armed(plan) if plan is not None else contextlib.nullcontext()):
        tickets = [server.submit(q) for q in queries]
        results = [t.wait(timeout=600) for t in tickets]
    wall = time.time() - t0
    if plan is not None:
        print(f"chaos fired {len(plan.fired)} faults: "
              f"{sorted(set(s for s, _, _ in plan.fired))}")

    rows = []
    for r in results:
        if not r.ok():
            print(f"  FAILED {r.name}: {r.error}")
            continue
        row = dict(r.row)
        row["scenario"] = (f"{r.name} [w{r.start_window}+"
                           f"{r.n_windows}]")
        rows.append(row)
    print(format_table({"baseline": 0, "scenarios": rows}))
    for r in results:
        if r.ok():
            print(f"  {r.name}: queue {r.queue_s*1e3:.1f}ms + exec "
                  f"{r.exec_s*1e3:.0f}ms, rode {r.batch_lanes}/"
                  f"{r.batch_size} lanes")

    stats = server.stats()
    print(f"served {stats['completed']} queries in {wall:.2f}s wall "
          f"({stats['lanes_per_s']:.1f} lanes/s, "
          f"{stats['lane_windows_per_s']:.0f} lane-windows/s, "
          f"occupancy {stats['mean_batch_occupancy']:.2f}, "
          f"p50 {stats['latency_p50_s']*1e3:.0f}ms "
          f"p99 {stats['latency_p99_s']*1e3:.0f}ms)")
    res = stats.get("resilience", {})
    busy = {k: v for k, v in res.items() if v}
    print(f"errors by code: {stats.get('errors_by_code') or '{}'}  "
          f"resilience: {busy or 'all quiet'}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "metrics": stats}, f, indent=1)
        print(f"rows + metrics -> {args.json}")

    server.stop()
    if tmp:
        tmp.cleanup()
    n_failed = sum(not r.ok() for r in results)
    if n_failed:
        raise SystemExit(f"{n_failed} queries failed")
    return results


if __name__ == "__main__":
    main()
