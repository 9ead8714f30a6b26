"""Run one cell traced with every thread of the process profiled, and print
the program's spans as one JSON line.

    python3 portbench/trace_spans.py --workload <cell> --seed <n>

From the root of a checkout, on a machine with the card. The run is
``run.py --trace 1``'s, but its profiler records the host ops of every
thread (the service's batcher, the prefetcher's fill thread), where the
harness's records those of the thread that opens the window. The line
holds ``correct``, the traced window's seconds and the device's busy
seconds in it, the lane-windows or answers a second over it, the
per-layer metrics of ``run.py``, ``spans``: the device launches and
milliseconds a window of the work launched inside each program span
(``harness/spans.device_by_span``), ``pageable_copies``: the same of the
copies from pageable host memory, and ``idle_s``: the device's idle
seconds by the program span the dispatching thread was in when each gap
began. A serve cell adds ``waiting_at_launch``, the tickets left waiting
a batch launched in the window (``ServiceMetrics.waiting_at_launch``
between the window's two snapshots, over its batches), and
``queue_wait_p95_s``, the 95th percentile of the ``queue_s`` of the
answers returned between them.
"""
import time

T_START = time.perf_counter()

import argparse                                               # noqa: E402
import json                                                   # noqa: E402
import os                                                     # noqa: E402
import sys                                                    # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          os.path.join(ROOT, "build", "kernels"))

    import torch
    from portbench.harness import common, manifest, spans

    man = manifest.Manifest(ROOT)
    cell = man.workload(args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = man.traffic(cell["traffic"])
    common.window_profile = spans.all_threads_profile
    seen = service_probe() if traffic["kind"] == "serve" else None
    job = common.Job(workload=args.workload, config=man.config(cell["config"]),
                     traffic=traffic, seed=args.seed, seconds=10.0,
                     trace=True, device=torch.device("cuda", 0),
                     t_start=T_START)
    out = man.driver(traffic["kind"])(job)
    w, windows = out.window, out.layer_inputs["windows"]
    metrics = {}
    for name, read in man.readers(args.workload).items():
        v = read(out.layer_inputs, w)
        if v is not None:
            metrics[name] = v

    def per_window(by_span):
        return {n: {"launches_per_window": c / windows,
                    "device_ms_per_window": t * 1e3 / windows}
                for n, (c, t) in sorted(by_span.items(),
                                        key=lambda x: -x[1][1])}
    print(json.dumps({
        "workload": args.workload, "correct": out.verdict.correct,
        "device": torch.cuda.get_device_name(0),
        "power_limit": common.power_limit(), "windows": windows,
        "window_s": w.window_s, "busy_s": w.busy_s(),
        "rate": out.attempted / w.window_s, "metrics": metrics,
        "spans": per_window(w.by_span),
        "pageable_copies": per_window(w.pageable_by_span),
        "idle_s": spans.idle_by_program_span(w),
        **(service_readings(seen) if seen else {})}), flush=True)
    return 0


def service_probe() -> dict:
    """Keep the serve driver's clients and the server's metrics snapshots
    (with the host time of each) as the run makes them."""
    from portbench.harness import serve
    from repro_torch.service.metrics import ServiceMetrics
    seen = {"clients": [], "snapshots": []}

    class Clients(serve.Clients):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["clients"].append(self)

    snapshot = ServiceMetrics.snapshot

    def kept(metrics):
        out = snapshot(metrics)
        seen["snapshots"].append((time.perf_counter(), out))
        return out

    serve.Clients = Clients
    ServiceMetrics.snapshot = kept
    return seen


def service_readings(seen: dict) -> dict:
    import numpy as np
    (t0, before), (t1, after) = seen["snapshots"][-2:]
    batches = after["batches"] - before["batches"]
    waits = [r.queue_s for _, t, r in seen["clients"][-1].answers
             if t0 < t <= t1 and r is not None and r.ok()]
    return {"waiting_at_launch": (after["waiting_at_launch"]
                                  - before["waiting_at_launch"]) / batches,
            "queue_wait_p95_s": float(np.percentile(waits, 95)),
            "batches": batches}


if __name__ == "__main__":
    sys.exit(main())
