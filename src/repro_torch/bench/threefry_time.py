"""Times the threefry kernel against the plain path on the card, at the
shapes the port draws: the sweeps' uniform draw (one key, 1,024 x 12,500,
``sched/table.tf_random``), the genetic search's population draw (8 keys,
8 x 1,024 x 12,500), ``randint`` at the draw's shape and a chain of 64
``split``s (the searches' key chains). The plain path is
``kernels/threefry/ref`` run on the card. Each time is the median of CUDA
events around one call, L2 flushed before each; the bounds are the least
time of the outputs' bytes at 3.35 TB/s and of ~80 int32 instructions an
output at 132 SMs x 64 lanes x the card's maximum SM clock. Prints one JSON
line. Run from the repository root on a machine with the card:

    PYTHONPATH=src python3 src/repro_torch/bench/threefry_time.py
"""
from __future__ import annotations

import json
import statistics
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.threefry import ops, ref

INSTR_PER_OUTPUT = 80
HBM_BYTES_S = 3.35e12
SLEEP_CYCLES = 2_000_000      # ~1 ms of device clock before a timed call


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    _build.library()
    clock_ghz = float(smi("clocks.max.sm").split()[0]) / 1e3
    k = ref.split(ref.key(7, dev), 4)
    ga = ref.split(k[2], 8)
    draws = {
        "uniform (1024, 12500)": (lambda m: m.uniform(k[1], (1024, 12_500)),
                                  1024 * 12_500, 4),
        "uniform (8, 1024, 12500)": (lambda m: m.uniform(ga, (1024, 12_500)),
                                     8 * 1024 * 12_500, 4),
        "randint (1024, 12500)": (
            lambda m: m.randint(k[3], 0, 12_500, (1024, 12_500)),
            2 * 1024 * 12_500, 8),
    }
    out = {"card": smi("name,power.limit"), "max_sm_clock_ghz": clock_ghz}
    for name, (fn, hashes, out_bytes) in draws.items():
        want = fn(ref)
        before = ops.threefry_cuda.launches
        got = fn(ops)
        launches = ops.threefry_cuda.launches - before
        assert torch.equal(got, want), f"{name}: kernel and plain bits differ"
        del got, want
        outputs = hashes if "randint" not in name else hashes // 2
        out[name] = {
            "kernel_ms": time_ms(lambda: fn(ops)),
            "plain_ms": time_ms(lambda: fn(ref), reps=3, warmup=1),
            "launches": launches,
            "issue_bound_ms": hashes * INSTR_PER_OUTPUT
            / (132 * 64 * clock_ghz * 1e9) * 1e3,
            "bytes_bound_ms": outputs * out_bytes / HBM_BYTES_S * 1e3}

    def chain(m):
        key = k[0]
        for _ in range(64):
            key = m.split(key)[1]
        return key

    assert torch.equal(chain(ops), chain(ref))
    out["split chain x64"] = {"kernel_ms": time_ms(lambda: chain(ops)),
                              "plain_ms": time_ms(lambda: chain(ref))}
    ptx = str(_build.BUILD_INFO.get("ptxas", ""))
    ptx = ptx.split("== threefry.cu")[-1].split("\n== ")[0]
    out["ptxas"] = [line.strip() for line in ptx.splitlines()
                    if "registers" in line or "spill" in line]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
