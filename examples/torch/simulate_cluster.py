"""End-to-end driver (the paper's kind of workload): a scaled Google-cell
simulation with several schedulers consuming the same trace (MASB use case),
pause/snapshot midway, restore, and a final comparison table.

The port of ``examples/simulate_cluster.py``: the same steps, defaults and
lines, on the CUDA card unless ``--device cpu`` is passed. ``random`` and
``simulated_annealing`` draw from the port's threefry stream, the
reference's keys; the snapshot is restored onto the run's device.

Run:  PYTHONPATH=src python examples/torch/simulate_cluster.py [--nodes 256]
      [--device cpu]
"""
import argparse
import os
import tempfile
import time

from repro_torch.config import SimConfig
from repro_torch.core.pipeline import Simulation
from repro_torch.core.snapshot import load_snapshot, save_snapshot
from repro_torch.core.state import validate_invariants
from repro_torch.core.tracegen import SHIFT_US, generate_trace
from repro_torch.device import resolve_device
from repro_torch.parsers.gcd import GCDParser

SCHEDULERS = ("greedy", "first_fit", "random", "simulated_annealing")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=192)
    ap.add_argument("--jobs", type=int, default=300)
    ap.add_argument("--windows", type=int, default=160)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises if there is none)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = SimConfig(max_nodes=args.nodes, max_tasks=args.nodes * 24,
                    max_events_per_window=4096, sched_batch=256,
                    n_attr_slots=12, max_constraints=4)
    start = SHIFT_US - cfg.window_us

    with tempfile.TemporaryDirectory() as d:
        summary = generate_trace(d, n_machines=args.nodes, n_jobs=args.jobs,
                                 horizon_windows=args.windows, seed=0,
                                 usage_period_us=20_000_000)
        print(f"trace: {summary.n_tasks} tasks, {summary.n_usage_records} "
              f"usage records, horizon {args.windows} windows\n")

        results = {}
        for sched in SCHEDULERS:
            parser = GCDParser(cfg, d)
            sim = Simulation(cfg, parser.packed_windows(args.windows,
                                                        start_us=start),
                             scheduler=sched, batch_windows=32,
                             device=device)
            t0 = time.time()
            state = sim.run()
            wall = time.time() - t0
            assert validate_invariants(state, cfg) == {}, sched
            sf = sim.stats_frame()
            results[sched] = dict(
                wall=wall,
                speed=sim.windows_done * cfg.window_us / 1e6 / wall,
                windows_per_s=sim.windows_done / wall,
                placed=int(sf["placements"][-1]),
                evicted=int(sf["evictions"][-1]),
                balance=float(sf["util_balance_var"][-1]),
                used=float(sf["used_frac"][-1][0]))

        print(f"{'scheduler':<22}{'wall s':>8}{'speed x':>9}{'placed':>8}"
              f"{'evicted':>8}{'balance var':>13}{'cpu used':>10}")
        for s, r in results.items():
            print(f"{s:<22}{r['wall']:>8.2f}{r['speed']:>9.1f}"
                  f"{r['placed']:>8}{r['evicted']:>8}{r['balance']:>13.2e}"
                  f"{r['used']:>10.2%}")

        # pause / snapshot / restore (paper §IV; restore is our extension)
        parser = GCDParser(cfg, d)
        sim = Simulation(cfg, parser.packed_windows(args.windows,
                                                    start_us=start),
                         scheduler="greedy", batch_windows=32, device=device)
        sim.run(max_windows=args.windows // 2)
        snap = os.path.join(d, "mid.npz")
        save_snapshot(snap, sim.state, cfg, sim.windows_done)
        state, cfg2, done, _extra = load_snapshot(snap, device=device)
        mib = os.path.getsize(snap) / 2**20
        print(f"\nsnapshot at window {done} -> {mib:.1f}"
              f" MiB; restored OK (cfg match: {cfg2 == cfg})")
    return dict(n_tasks=summary.n_tasks,
                n_usage_records=summary.n_usage_records,
                results=results,
                snapshot=dict(window=done, mib=mib, cfg_match=cfg2 == cfg,
                              device=str(state.window.device)))


if __name__ == "__main__":
    main()
