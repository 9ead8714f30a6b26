"""The lower-precision control of a cell's comparison, at the cell's own
size: the plain reference computed with its stored floats in bfloat16 (the
nearest precision below the cell's float32), put in the program's place
and compared with the float32 reference exactly as a run compares the
program. Its numbers set the upper end of each limit in
``harness/check.py``; the benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

On the card by default. The tests call :func:`readings` at a small size
on the CPU.
"""
import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(job, float_dtype) -> dict:
    """The numbers a run of ``job``'s cell compares, with the reference at
    ``float_dtype`` in the program's place."""
    from portbench.harness import check, common, sweep, serve, workload
    from portbench.reference import sim as ref
    tf = job.traffic
    pseed = workload.program_seed(job.seed)
    specs = workload.grid_specs(tf["lanes"])
    lanes = workload.sample_lanes(job.seed, len(specs), tf["check_lanes"])
    verdict = check.Verdict()
    if tf["kind"] == "sweep":
        # the windows a run compares: set-up's and the two batches that
        # a window of run_seconds holds at the card's rate (a traced run's)
        sim_cfg, trace, specs = sweep.make_inputs(
            dataclasses.replace(job, trace=True))
        hi = tf["warm_windows"] + tf.get("trace_batches", 2) * tf[
            "batch_windows"]
        want = sweep.follow(job, sim_cfg, trace, specs, lanes, hi, pseed)
        got = sweep.follow(job, sim_cfg, trace, specs, lanes, hi, pseed,
                           float_dtype=float_dtype)
        verdict.add_pair("rows", *check.gap(got, want, want.keys()))
    else:
        sim_cfg = common.sim_config(job, tf["inject_slots"])
        S = serve.latest_fork(tf)
        trace = serve.make_trace(job, sim_cfg)
        f0, r0 = serve.follow(job, sim_cfg, trace, specs, lanes, S, pseed)
        f1, r1 = serve.follow(job, sim_cfg, trace, specs, lanes, S, pseed,
                              float_dtype=float_dtype)
        answers = []
        for j, k in enumerate(lanes):
            frame = {key: v[:, j] for key, v in r1.items()}
            answers.append((k, frame, ref.report_row(frame)))
        serve.judge(verdict, f1, f0, answers, r0, lanes)
    return {k: v for k, (v, _) in verdict.numbers.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import time
    import torch
    from portbench.harness import common, manifest
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    man = manifest.Manifest(ROOT)
    cell = man.workload(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        job = common.Job(args.workload, man.config(cell["config"]),
                         man.traffic(cell["traffic"]), seed, 0.0, False,
                         torch.device(args.device), time.perf_counter())
        out = readings(job, torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16", **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
