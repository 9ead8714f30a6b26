"""Quickstart: 60 seconds with AGOCS on PyTorch and CUDA.

1. Generate a small GCD-schema trace (stand-in for clusterdata-2011-2).
2. Parse + replay it through the windowed engine with the greedy scheduler.
3. Print the fine-grained statistics that are the simulator's point.

The port of ``examples/quickstart.py``: the same steps, defaults and
lines, on the CUDA card unless ``--device cpu`` is passed.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import tempfile
import time

from repro_torch.config import REDUCED_SIM
from repro_torch.core.pipeline import Simulation
from repro_torch.core.tracegen import SHIFT_US, generate_trace
from repro_torch.device import resolve_device
from repro_torch.parsers.gcd import GCDParser


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises if there is none)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = REDUCED_SIM
    with tempfile.TemporaryDirectory() as trace_dir:
        summary = generate_trace(trace_dir, n_machines=48, n_jobs=80,
                                 horizon_windows=80, seed=0,
                                 usage_period_us=10_000_000)
        print(f"trace: {summary.n_tasks} tasks / {summary.n_machines} nodes "
              f"/ {summary.n_usage_records} usage records")

        parser = GCDParser(cfg, trace_dir)
        sim = Simulation(cfg,
                         parser.packed_windows(100,
                                               start_us=SHIFT_US - cfg.window_us),
                         scheduler="greedy", batch_windows=20, device=device)
        t0 = time.time()
        sim.run()
        wall = time.time() - t0

        sf = sim.stats_frame()
        um = sf["usage_mean"][-1]
        out = dict(
            n_tasks=summary.n_tasks, n_machines=summary.n_machines,
            n_usage_records=summary.n_usage_records,
            windows=sim.windows_done,
            placed=int(sf["placements"][-1]),
            completed=int(sf["completions"][-1]),
            evictions=int(sf["evictions"][-1]),
            cpu_reserved=float(sf["reserved_frac"][-1][0]),
            cpu_used=float(sf["used_frac"][-1][0]),
            overestimate=float(sf["overestimate_frac"][-1][0]),
            cpi=float(um[6]), disk_io=float(um[4]),
            wall_s=wall, windows_per_s=sim.windows_done / wall)
        print(f"\nwindows simulated : {out['windows']}")
        print(f"tasks placed      : {out['placed']}")
        print(f"tasks completed   : {out['completed']}")
        print(f"evictions         : {out['evictions']}")
        print(f"cpu reserved      : {out['cpu_reserved']:.1%}")
        print(f"cpu actually used : {out['cpu_used']:.1%}")
        print(f"over-estimation   : {out['overestimate']:.1%}"
              "  <- users waste most of what they request (paper §I)")
        print(f"mean CPI          : {out['cpi']:.2f}")
        print(f"mean disk I/O time: {out['disk_io']:.4f}")
    return out


if __name__ == "__main__":
    main()
