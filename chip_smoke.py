#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py [--jobs 16000] [--windows 64]

Phases, each printing its own lines:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the four CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
     seconds and ptxas register/shared-memory lines);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the paper's cell A, on grid-aligned inputs made from a seed
     (integers and sums bitwise, variances within rtol 2.5e-7; segment_usage also
     off the grid);
  4. the main path: ``Simulation`` with ``greedy`` over a synthetic GCD
     trace at cell A (12,500 nodes, 262,144 task slots, sched_batch 1,024)
     for 64 windows with one accounting resync, then ``first_fit`` for a
     few windows (the commit kernel's static mode); launch counts are reset
     just before each run and read just after it; a torch.profiler trace
     of 16 warm windows (device time by kernel, busy share of wall time);
     plus a small run checked against the plain versions on the CPU;
  5. kernel times at the main path's shapes (CUDA events, L2 flushed,
     median) beside the plain version, the library call where one exists,
     and the bound;
  6. a ``kernels:`` status line and the JSON kernel table.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before it; without a CUDA device, or without the repository
beside this file, the script fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
PROFILE_WINDOWS = 16          # traced windows of the main path (phase 4)
ULP_RTOL = 2.5e-7             # "within 2 ulp" for the variances


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def grid(rng, lo, hi, shape, q=128):
    """Values exactly representable in f32 (multiples of 1/q)."""
    return (rng.integers(lo, hi, shape) / q).astype(np.float32)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` with L2 flushed before each run."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_main_path(torch, cfg, windows, dev, Simulation) -> None:
    """torch.profiler over a warm greedy run of ``windows``: the top device
    time by name and the summed device time over the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    warm = Simulation(cfg, iter(windows), scheduler="greedy",
                      batch_windows=len(windows), device=dev)
    warm.run()
    sim = Simulation(cfg, iter(windows), scheduler="greedy",
                     batch_windows=len(windows), device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        sim.run()
        wall_us = (time.time() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's row repeats its kernels' time
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: {len(windows)} windows, wall {wall_us / 1e3:.3f} ms, "
          f"summed device time {busy / 1e3:.3f} ms "
          f"(busy share {busy / wall_us:.3f})")
    for dev_us, count, key in rows[:15]:
        print(f"  {dev_us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=16_000)
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import agocs_cell_a
    from repro_torch.core import tracegen
    from repro_torch.core.pipeline import Simulation
    from repro_torch.core.state import validate_invariants
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.kernels import _build
    from repro_torch.kernels.constraint_match import ops as cm_ops
    from repro_torch.kernels.constraint_match.ref import constraint_match_ref
    from repro_torch.kernels.placement_commit import ops as pc_ops
    from repro_torch.kernels.placement_commit.ref import placement_commit_ref
    from repro_torch.kernels.segment_usage import ops as su_ops
    from repro_torch.kernels.segment_usage.ref import segment_usage_ref
    from repro_torch.kernels.window_stats import ops as ws_ops
    from repro_torch.kernels.window_stats.ref import window_reductions_ref
    from repro_torch.launch.simulate import summary_row
    from repro_torch.parsers import GCDParser, default_start_us

    # ---- 1. device ----------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = gpu_name_and_power_limit()
    assert smi, "nvidia-smi did not report the card"
    print(f"device: {kind} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s))")
    print("nvidia-smi --query-gpu=name,power.limit:")
    print(smi)

    # ---- 2. build -----------------------------------------------------
    t0 = time.time()
    _build.library()
    print(f"build: {time.time() - t0:.1f}s -> {_build.BUILD_INFO['path']}")
    for line in str(_build.BUILD_INFO["ptxas"]).splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line:
            print("  " + line.strip())

    cfg = agocs_cell_a.CONFIG
    P, N, T = cfg.sched_batch, cfg.max_nodes, cfg.max_tasks
    R, U, K, C = (cfg.n_resources, cfg.n_usage_stats, cfg.n_attr_slots,
                  cfg.max_constraints)
    rng = np.random.default_rng(args.seed)

    def cuda(x):
        return torch.as_tensor(x).to(dev)

    counters = {"constraint_match": cm_ops.constraint_match_cuda,
                "placement_commit": pc_ops.placement_commit_cuda,
                "window_stats": ws_ops.window_stats_cuda,
                "segment_usage": su_ops.segment_usage_cuda}
    results = {name: {} for name in counters}

    # ---- 3. kernels against their plain versions, cell-A shapes -------
    # A: constraint_match
    req = cuda(grid(rng, 1, 48, (P, R)))
    cons = np.stack([rng.integers(0, K, (P, C)),
                     np.where(rng.random((P, C)) < 0.8, 0,
                              rng.integers(1, 5, (P, C))),
                     rng.integers(0, 4, (P, C))], axis=-1).astype(np.int32)
    cons = cuda(cons)
    node_total = cuda(grid(rng, 64, 256, (N, R)))
    node_res = cuda(grid(rng, 0, 64, (N, R)))
    node_attrs = cuda(rng.integers(0, 4, (N, K)).astype(np.int32))
    node_active = cuda(rng.random(N) < 0.95)
    a_args = (req, cons, node_total, node_res, node_attrs, node_active)
    sc_k = cm_ops.constraint_match(*a_args)
    sc_r = constraint_match_ref(*a_args)
    torch.cuda.synchronize()
    fin = torch.isfinite(sc_r)
    assert torch.equal(torch.isfinite(sc_k), fin), "A: feasibility differs"
    assert torch.equal(sc_k[fin], sc_r[fin]), "A: scores not bitwise"
    results["constraint_match"]["max_abs_err"] = float(
        (sc_k[fin] - sc_r[fin]).abs().max())
    print(f"A constraint_match P={P} N={N}: bitwise, "
          f"{int(fin.sum())} feasible pairs")

    # B: placement_commit, both modes, on the same operands
    ok = fin.contiguous()
    valid = cuda(rng.random(P) < 0.9)
    total_f = torch.where(node_active[:, None], node_total, -1.0)
    denom = torch.clamp_min(node_total, 1e-6)
    b_err = 0.0
    for dynamic in (False, True):
        b_args = (sc_r, req, ok, valid, total_f, denom, node_res)
        no_k, ta_k = pc_ops.placement_commit(*b_args, dynamic,
                                             return_tally=True)
        no_r, ta_r = placement_commit_ref(*b_args, dynamic)
        torch.cuda.synchronize()
        mode = "dynamic" if dynamic else "static"
        assert torch.equal(no_k, no_r), f"B {mode}: node_of differs"
        assert torch.equal(ta_k, ta_r), f"B {mode}: tally not bitwise"
        b_err = max(b_err, float((ta_k - ta_r).abs().max()))
        print(f"B placement_commit {mode} P={P} N={N}: node_of exact, "
              f"tally bitwise, {int((no_k >= 0).sum())} placed")
    results["placement_commit"]["max_abs_err"] = b_err

    # C: window_stats
    task_state = cuda(rng.integers(0, 3, T).astype(np.int8))
    task_usage = cuda(grid(rng, 0, 16, (T, U)))
    task_prio = cuda(rng.integers(-1, 13, T).astype(np.int32))
    node_used = cuda(grid(rng, 0, 64, (N, R)))
    c_args = (task_state, task_usage, task_prio, node_active, node_total,
              node_res, node_used)
    red_k = ws_ops.window_reductions(*c_args)
    red_r = window_reductions_ref(*c_args)
    torch.cuda.synchronize()
    c_err = 0.0
    for f in red_k._fields:
        a = getattr(red_k, f).cpu().numpy()
        b = getattr(red_r, f).cpu().numpy()
        if f in ("util_var", "res_var"):
            assert np.allclose(a, b, rtol=ULP_RTOL, atol=0), \
                f"C {f}: {a!r} vs {b!r} beyond rtol {ULP_RTOL}"
        else:
            assert np.array_equal(a, b), f"C {f}: {a!r} vs {b!r}"
        c_err = max(c_err, float(np.abs(a.astype(np.float64)
                                        - b.astype(np.float64)).max()))
    results["window_stats"]["max_abs_err"] = c_err
    print(f"C window_stats T={T} N={N}: counts/histogram exact, sums "
          f"bitwise, variances within rtol {ULP_RTOL}")

    # E: segment_usage, grid data bitwise and off-grid data within rtol
    task_node = cuda(rng.integers(-1, N, T).astype(np.int32))
    mask = cuda(rng.random(T) < 0.7)
    values = cuda(grid(rng, 0, 48, (T, R)))
    e_args = (task_node, values, mask, N)
    out_k = su_ops.segment_usage(*e_args)
    out_r = segment_usage_ref(*e_args)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_r), "E: grid sums not bitwise"
    e_err = float((out_k - out_r).abs().max())
    values_off = cuda(rng.random((T, R), dtype=np.float32))
    out_k2 = su_ops.segment_usage(task_node, values_off, mask, N)
    out_r2 = segment_usage_ref(task_node, values_off, mask, N)
    torch.cuda.synchronize()
    assert torch.allclose(out_k2, out_r2, rtol=1e-6, atol=0), \
        "E: off-grid sums beyond rtol 1e-6"
    e_err = max(e_err, float((out_k2 - out_r2).abs().max()))
    results["segment_usage"]["max_abs_err"] = e_err
    print(f"E segment_usage T={T} -> N={N}: bitwise on grid, off-grid max "
          f"abs err {e_err:.3g} (rtol 1e-6)")

    # ---- 4. the main path at cell A -----------------------------------
    tmp = tempfile.TemporaryDirectory()
    t0 = time.time()
    summary = tracegen.generate_trace(
        tmp.name, n_machines=N, n_jobs=args.jobs,
        horizon_windows=args.windows, seed=args.seed,
        usage_period_us=max(cfg.window_us * 4, 20_000_000))
    t_gen = time.time() - t0
    t0 = time.time()
    parser = GCDParser(cfg, tmp.name)
    windows = list(parser.packed_windows(
        args.windows, start_us=default_start_us("gcd", cfg)))
    t_parse = time.time() - t0
    tmp.cleanup()
    n_events = int(sum(int(w.n_valid) for w in windows))
    print(f"trace: {summary} generated in {t_gen:.1f}s")
    print(f"parse: {len(windows)} windows, {n_events} events in "
          f"{t_parse:.1f}s; parser: {parser.stats}")
    assert parser.stats.slot_overflow == 0, "slot_overflow in the parse"

    for fn in counters.values():
        fn.launches = 0
    sim = Simulation(cfg, iter(windows), scheduler="greedy",
                     batch_windows=32, device=dev)
    t0 = time.time()
    state = sim.run()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    sf = sim.stats_frame()
    n_rows = len(sf["n_running"])
    assert n_rows == args.windows and sim.windows_done == args.windows
    for k, v in sf.items():
        assert v.shape[0] == n_rows and np.all(np.isfinite(v)), k
    pend = sf["n_pending"]
    print(f"main path greedy: {sim.windows_done} windows in {wall:.3f}s "
          f"-> {sim.windows_done / wall:.2f} windows/s (parse "
          f"{t_parse:.1f}s apart), {sim.resyncs_done} resync(s)")
    print(f"pending per window: median {int(np.median(pend))}, "
          f"{int((pend >= P).sum())}/{n_rows} windows >= sched_batch {P}")
    print(json.dumps(summary_row("greedy", sf), indent=1))
    problems = validate_invariants(state, cfg)
    print("invariants:", problems or "OK")
    assert not problems, problems
    print(f"launches (greedy run): {launches}")
    assert all(n > 0 for n in launches.values()), launches
    assert launches["segment_usage"] >= 2, launches
    del state, sim

    for fn in counters.values():
        fn.launches = 0
    ff_windows = 8
    sim_ff = Simulation(cfg, iter(windows[:ff_windows]),
                        scheduler="first_fit", batch_windows=ff_windows,
                        device=dev)
    state_ff = sim_ff.run()
    launches_ff = {name: fn.launches for name, fn in counters.items()}
    problems = validate_invariants(state_ff, cfg)
    assert not problems, problems
    print(f"first_fit ({ff_windows} windows, static commit): placements "
          f"{int(sim_ff.stats_frame()['placements'][-1])}, invariants OK, "
          f"launches {launches_ff}")
    assert launches_ff["placement_commit"] == ff_windows, launches_ff
    del state_ff, sim_ff

    profile_main_path(torch, cfg, windows[:PROFILE_WINDOWS], dev, Simulation)

    # the card against the plain versions on a small cell, end to end
    small = dataclasses.replace(cfg, max_nodes=48, max_tasks=1024,
                                max_events_per_window=1024, sched_batch=64)
    with tempfile.TemporaryDirectory() as d:
        tracegen.generate_trace(d, n_machines=48, n_jobs=120,
                                horizon_windows=40, seed=args.seed + 1)
        small_ws = list(GCDParser(small, d).packed_windows(
            40, start_us=default_start_us("gcd", small)))
    runs = {}
    for device in (dev, torch.device("cpu")):
        s = Simulation(small, iter(small_ws), scheduler="greedy",
                       batch_windows=8, device=device)
        runs[device.type] = (s.run(), s.stats_frame())
    (st_g, sf_g), (st_c, sf_c) = runs["cuda"], runs["cpu"]
    for f in ("task_state", "task_node", "node_active"):
        assert torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f)), f
    for k in sf_c:
        if sf_c[k].dtype.kind in "iub":
            assert np.array_equal(sf_g[k], sf_c[k]), k
        else:
            np.testing.assert_allclose(sf_g[k], sf_c[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    print(f"small cell (48 nodes, 40 windows): card == plain CPU path "
          f"(decisions exact, stats rtol 1e-5)")

    # ---- 5. times at the main path's shapes ---------------------------
    W = args.windows
    lib_idx = torch.where(mask & (task_node >= 0), task_node.long(), N)
    pl_bytes = nbytes(req, ok, valid, total_f, denom, node_res) \
        + P * 4 + N * R * 4
    timings = {
        "constraint_match": (
            lambda: cm_ops.constraint_match(*a_args),
            lambda: constraint_match_ref(*a_args), None, 10, 3,
            nbytes(req, cons, node_total, node_res, node_attrs, node_active)
            + P * N * 4, P * N * (6 * R + 2 * C)),
        "placement_commit": (
            lambda: pc_ops.placement_commit(sc_r, req, ok, valid, total_f,
                                            denom, node_res, True),
            lambda: placement_commit_ref(sc_r, req, ok, valid, total_f,
                                         denom, node_res, True), None, 5, 2,
            pl_bytes, P * N * 6 * R),
        "window_stats": (
            lambda: ws_ops.window_reductions(*c_args),
            lambda: window_reductions_ref(*c_args), None, 20, 5,
            nbytes(task_state, task_usage, task_prio, node_active,
                   node_total, node_res, node_used) + (3 + 24 + U + 3 * R
                                                       + 2) * 4,
            T * (2 * U + 4) + N * (8 * R + 8)),
        "segment_usage": (
            lambda: su_ops.segment_usage(*e_args),
            lambda: segment_usage_ref(*e_args),
            lambda: torch.zeros(N + 1, R, device=dev).index_add_(
                0, lib_idx, values)[:N], 10, 5,
            nbytes(task_node, values, mask) + N * R * 4,
            int((mask & (task_node >= 0)).sum()) * R),
    }
    for name, (kfn, pfn, lfn, reps, preps, nb, nops) in timings.items():
        ms = time_ms(torch, kfn, reps)
        plain_ms = time_ms(torch, pfn, preps, warmup=1)
        lib_ms = time_ms(torch, lfn, reps) if lfn else None
        b_ms, b_by = bound_ms(nb, nops)
        results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by)
        lib = f"{lib_ms:.4f}" if lib_ms is not None else "-"
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib} ms, {launches[name] / W:.4g} launches/window, "
              f"bound {b_ms:.4f} ms ({b_by}) [{smi}]")

    # ---- 6. the kernel table ------------------------------------------
    meta = {
        "constraint_match": ("src/repro/kernels/constraint_match/kernel.py:76",),
        "placement_commit": ("src/repro/kernels/placement_commit/kernel.py:121",),
        "window_stats": ("src/repro/kernels/window_stats/kernel.py:124",),
        "segment_usage": ("src/repro/kernels/segment_usage/kernel.py:39",),
    }
    table = []
    for name in counters:
        r = results[name]
        table.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": meta[name][0], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print("kernels: " + " ".join(f"{t['name']}=ok(cuda)" for t in table))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
