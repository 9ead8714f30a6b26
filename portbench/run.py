"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Prints the numbers compared and their limits as its last lines on
standard error, and one JSON object as the last line of standard output:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the traced window's device times and its breakdown.
Exits non-zero, printing no result, without the cards, without the
program beside the benchmark, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse                                               # noqa: E402
import json                                                   # noqa: E402
import os                                                     # noqa: E402
import sys                                                    # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("the program (src/repro_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          os.path.join(ROOT, "build", "kernels"))

    import torch
    from portbench.harness import common, manifest

    man = manifest.Manifest(ROOT)
    cell = man.workload(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = man.traffic(cell["traffic"])
    drive = man.driver(traffic["kind"])
    readers = man.readers(args.workload)
    job = common.Job(workload=args.workload, config=man.config(cell["config"]),
                     traffic=traffic, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=torch.device("cuda", 0),
                     t_start=T_START)
    out = drive(job)

    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": out.memory_peak_bytes,
              "power_limit": common.power_limit()}
    if args.trace:
        units = {m["name"]: m["unit"] for m in man.per_layer(args.workload)}
        metrics = {}
        for name, read in readers.items():
            v = read(out.layer_inputs, out.window)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        device["busy_s"] = out.window.busy_s()
        device["window_s"] = out.window.window_s
        extra = {"breakdown": out.window.breakdown()}
    else:
        metrics = {m["name"]: {"value": out.values[m["name"]],
                               "unit": m["unit"]}
                   for m in man.end_to_end(args.workload)}
        extra = {}
    for note in out.notes:
        print(f"note: {note}", file=sys.stderr)
    for line in out.verdict.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    result = {"correct": out.verdict.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device,
              **extra, "check": out.verdict.as_json()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
