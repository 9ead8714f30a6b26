"""Simulation-driven fault-tolerant training: the AGOCS simulator replays a
cluster's node-failure behaviour; those failures are injected into a real
training run, which recovers from checkpoints and reproduces the exact loss
trajectory of an uninterrupted run.

This is the bridge between the paper's simulator and the LM framework: the
failure *distribution* comes from the simulated cluster, not from hand-picked
steps.

The port of ``examples/fault_tolerant_train.py``: the same steps, defaults
and lines, on the CUDA card unless ``--device cpu`` is passed.

Run:  PYTHONPATH=src python examples/torch/fault_tolerant_train.py
      [--device cpu]
"""
import argparse
import dataclasses
import tempfile
import time

import numpy as np

from repro_torch.config import REDUCED_SIM, TrainConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core.pipeline import Simulation
from repro_torch.core.tracegen import SHIFT_US, generate_trace
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import FaultPlan, FaultTolerantRunner
from repro_torch.parsers.gcd import GCDParser

STEPS = 12


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises if there is none)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1) simulate a cluster with aggressive node churn; collect the windows
    #    in which nodes were lost
    cfg = REDUCED_SIM
    with tempfile.TemporaryDirectory() as d:
        generate_trace(d, n_machines=32, n_jobs=30, horizon_windows=60,
                       seed=9, churn_prob=0.02, usage_period_us=10_000_000)
        sim = Simulation(cfg, GCDParser(cfg, d).packed_windows(
            60, start_us=SHIFT_US - cfg.window_us), scheduler="greedy",
            batch_windows=20, device=device)
        t0 = time.time()
        sim.run()
        sim_wall = time.time() - t0
        sf = sim.stats_frame()
        ev = sf["evictions"]
        removal_windows = [int(w) for w in range(1, len(ev))
                           if ev[w] > ev[w - 1]]
        print(f"simulated cluster: evictions in windows {removal_windows}")

    # 2) map failure windows onto training steps
    plan = FaultPlan.from_sim_trace(removal_windows, total_steps=STEPS,
                                    windows_per_step=60 / STEPS)
    print(f"fault plan: crashes at steps {sorted(plan.crashes)}")

    # 3) train twice: clean vs faulted — trajectories must match exactly
    model_cfg = dataclasses.replace(reduced(get_config("qwen3-4b")),
                                    remat_policy="none")
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        tc = TrainConfig(total_steps=STEPS, warmup_steps=2,
                         checkpoint_every=3, checkpoint_dir=d1,
                         async_checkpoint=False)
        t0 = time.time()
        clean = FaultTolerantRunner(model_cfg, tc, batch=2, seq_len=32,
                                    device=device).run(STEPS, inject=False)
        clean_wall = time.time() - t0
        tc2 = dataclasses.replace(tc, checkpoint_dir=d2)
        t0 = time.time()
        faulted = FaultTolerantRunner(model_cfg, tc2, batch=2, seq_len=32,
                                      fault_plan=plan,
                                      device=device).run(STEPS)
        faulted_wall = time.time() - t0

    print(f"\nclean   losses: {[round(l, 4) for l in clean['losses']]}")
    print(f"faulted losses: {[round(l, 4) for l in faulted['losses']]}")
    print(f"recovered from {len(faulted['recoveries'])} crash(es) at "
          f"steps {faulted['recoveries']}")
    identical = np.array_equal(clean["losses"], faulted["losses"])
    print(f"trajectories bit-identical after recovery: {identical}")
    assert identical
    return dict(removal_windows=removal_windows,
                crashes=sorted(plan.crashes), sim_windows=sim.windows_done,
                sim_wall_s=sim_wall, clean=clean, faulted=faulted,
                identical=identical, clean_wall_s=clean_wall,
                faulted_wall_s=faulted_wall,
                steps_per_s=STEPS / clean_wall)


if __name__ == "__main__":
    main()
