"""Helpers of the benchmark's CPU tests (imported by name, not a
conftest): the cells of ``BENCHMARK.json`` cut to a size the CPU runs in
seconds (the same configuration keys and traffic mixes, fewer nodes,
tasks, lanes and windows)."""
import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_job(workload: str, seed: int = 2100000999, trace: bool = False):
    import torch
    torch.set_num_threads(1)
    from portbench.harness import common, manifest
    man = manifest.Manifest(ROOT)
    cell = man.workload(workload)
    cfg = copy.deepcopy(man.config(cell["config"]))
    cfg["cell"].update(max_nodes=32, max_tasks=2048, max_events_per_window=256,
                       sched_batch=32)
    cfg["trace"].update(machines=32, running_at_start=300)
    tf = man.traffic(cell["traffic"])
    tf["lanes"] = {k: v[:2] for k, v in tf["lanes"].items()}
    tf["lanes"]["scheduler"] = ["greedy", "first_fit", "round_robin", "random"]
    tf.update(batch_windows=8, check_lanes=4)
    if tf["kind"] == "sweep":
        tf.update(warm_windows=16, max_windows_per_s=2)
        if tf["inject_slots"]:
            tf["inject_slots"] = 32
    else:
        tf.update(trunk_windows=16, fork_every=8, query_windows=8,
                  max_lanes=16, clients=16, stagger_s=0.01, max_queries=512)
    return common.Job(workload, cfg, tf, seed, 1.0, trace,
                      torch.device("cpu"), time.perf_counter())
