#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py [--jobs 16000] [--windows 64]

Phases, each printing its own lines:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the seven CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
     one process per source, seconds and ptxas register/shared-memory
     lines), and beside them the two bench programs of phase 9
     (``src/repro_torch/bench/match_store.cu``, ``stats_split.cu``);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the paper's cell A, on grid-aligned inputs made from a seed
     (integers and sums bitwise, variances within rtol 2.5e-7);
     window_stats also at the fleet's B=8 (one launch, each lane against
     the plain version, two calls bitwise equal);
     segment_usage in its lane form at B=1 and B=8 (one launch), uniform
     and Zipf-skewed nodes, also off the grid, there bitwise against the
     host's f32 sum in task order; the fleet's shapes too, B=8 lanes:
     constraint_match with its lane axis, placement_commit with a per-lane
     flag ('both'), and sched_commit with lanes of all three proposal
     families in modes
     static, dynamic and both, one operand shared by the lanes; B and D
     past the old node ceiling (N=20,000 and 150,000, P=64, R=3, every
     mode and family, bitwise; the cluster size each chose) and E at
     70,000 nodes with V=12 (three digit passes, two column groups,
     bitwise);
     flash_attention at the serving shape of qwen3-4b (B=4, S=512, H=32,
     D=128, bf16, causal; max abs err 2e-2; its tensor-core body) and in
     f32 at a ragged S, causal and full (1e-5; its SIMT body); fused_ce
     at qwen3-4b's training shape
     (T=2,048, d=2,560, Vp=152,064, V=151,936, bf16, one label in seven
     ignored; per-token nll and lse within 2e-3; its tensor-core body) and
     in f32 at a ragged T with V < Vp (1e-4; its SIMT body);
  4. the main path: ``Simulation`` with ``greedy`` over a synthetic GCD
     trace at cell A (12,500 nodes, 262,144 task slots, sched_batch 1,024)
     for 64 windows with one accounting resync, then ``first_fit`` for a
     few windows (the commit kernel's static mode); launch counts are reset
     just before each run and read just after it; a torch.profiler trace
     of 16 warm windows (device time by kernel, busy share of wall time);
     plus a small run checked against the plain versions on the CPU;
  5. the scenario fleet at cell A: ``ScenarioFleet`` with 8 lanes (three
     baselines, outage, capacity, storm, amplification and a lane of an
     external-family plugin) over 32 windows of the same trace packed with
     the ``whatif`` CLI's injection rows (1,024), one resync; launch counts
     reset just before and read just after; every lane's invariants; lane
     0 against a ``Simulation`` of the same windows, bitwise; a
     torch.profiler trace of 16 warm fleet windows; plus a small fleet on
     the card against the CPU, both dispatch paths;
  6. stochastic schedulers, snapshots and replay at cell A: the key
     stream (``core.prng``: split, uniform, randint) on the card against
     the CPU, bitwise, at (1,024 x 12,500) and the GA population's (8,
     1,024, 12,500), and the times of one (1,024 x 12,500) uniform and of
     one GA generation's pair of draws; kernel E at the searches' surrogate
     shapes (T=1,024, V=3, N=12,500; B=1 for SA and tabu, B=8 for the
     GA's population, the rows expanded over the lanes as the surrogate
     passes them), one launch a call, bitwise against its plain version,
     with its times; ``Simulation`` with ``random``,
     ``simulated_annealing``, ``tabu_search`` and ``genetic`` for 8 windows
     each (batches of 4; counts reset before and read after each run; E's
     launches exactly 65, 49 and 5 a window for the three searches),
     invariants, windows/s, and one traced window's device time beside
     its search's own; a 4-lane fleet of one lane each, switchless (the
     searches' preferences reach kernel D as external rows), each lane
     bitwise equal to its scheduler's ``Simulation``; a
     ``simulated_annealing`` run paused at window 4, saved, restored and
     run to window 8 equal to the straight run in every state field; the
     fleet's 8 windows pre-compiled, and a fleet ``from_precompiled(
     start_window=4)`` restored from its snapshot there equal to the
     uninterrupted fleet (every state field, trailing stats rows);
  7. the serving path: qwen3-4b at full width (36 layers, d_model 2560,
     vocab 151,936; f32 parameters from a torch.Generator seeded 0 on the
     card, bf16 activations and cache), ``ServingEngine.generate`` on 4
     prompts of 512 random tokens, 32 new tokens each, with
     ``attention_impl="pallas"`` (kernel F in every layer of the prefill);
     launch counts reset just before and read just after (F: 36, all
     through its tensor-core body); prefill
     ms, decode ms per token, new tokens/s and peak memory; torch.profiler
     traces of a prefill and of 8 decode steps; then the same parameters
     and prompts with ``attention_impl="xla"``: greedy agreement of the
     first token within 0.05 of the xla logits' maximum; the two impls'
     prefill logit rows within 2e-2 relative L2 with f32 activations (in
     bf16 each impl's rows lie ~2e-2 from the f32 rows, so the bf16
     distances are printed beside them, not held to that bar);
  8. the training path: the serving phase's memory released, then
     qwen3-4b at full width (the same widths and depth; f32 parameters
     from a torch.Generator seeded 0 on the card, AdamW's f32 moments,
     bf16 activations) with ``chunked_ce=True`` and the reference's
     training attention (``attention_impl="xla"``, full remat), on
     ``SyntheticLM`` batches of 4 x 512 tokens (seed 0), through
     ``train.step.make_train_step`` as ``FaultTolerantRunner.run`` calls
     it: the first batch's loss and its gradient with respect to the final
     hidden states through kernel G against the plain chunked loss on the
     card (loss within 1e-3, gradient within 1e-2 of its largest value);
     one warm-up step and three timed steps, kernel G's launch counts reset
     just before and read just after (3, all through its tensor-core
     body); finite losses; step ms,
     tokens/s, peak memory; a torch.profiler trace of one step (device
     time by kernel, G's share, busy share); then the training CLI's
     configuration at reduced width through ``FaultTolerantRunner`` with a
     checkpoint directory in a tempdir, once uninterrupted and once with
     a crash injected at step 4: it must recover, and its losses must
     match within 1e-5 (the largest difference, and whether the two are
     bitwise, printed);
  9. kernel times at the main path's shapes (CUDA events, L2 flushed,
     the host queued ahead of the device, median) beside the plain
     version, the library call where one exists, and the bound;
     sched_commit (and constraint_match and segment_usage) at the
     fleet's, flash_attention at the serving path's, fused_ce at the
     training path's (the library yardstick there is two calls:
     ``linear`` and ``cross_entropy``); window_stats also at the fleet's
     B=8; constraint_match as the paths call it (``node_active`` folded
     inside the kernel); the bench programs' lines: constraint_match's
     TMA tile store and task-run lengths against its shipped form, and
     window_stats against the two stages of its parent design timed
     apart; for placement_commit and
     sched_commit also the cluster size the scan chose and its latency
     floor (the same P tasks over one node a block, where a task is one
     block reduction and one exchange of the blocks' pairs and nothing
     else);
  10. the what-if service at cell A: the trace of phases 4-5 packed with
     the ``whatif`` CLI's 1,024 injection rows, pre-compiled in phase 4
     (64 windows, chunks of 32); a ``WhatIfServer`` (greedy, first_fit,
     random; 8 lanes; batch_windows 32) warmed, fork points every 32
     windows from a 3-lane trunk; burst 1, eight strangers from window 0
     (3 schedulers x outage {0, 0.2}, capacity 0.9, storm 0.05), must ride
     one launch and equal a direct 8-lane ``ScenarioFleet.from_precompiled``
     lane by lane, every column bitwise, with A, C and D launched once a
     window and E as often as in the direct fleet (counts reset just
     before the batch, read just after); burst 2, three fork continuations
     from window 32, each bitwise equal to windows [32, 64) of its trunk
     lane run from window 0; a burst-1 query re-served under two injected
     ``engine_launch`` faults, the same frame, two retries, no errors; the
     service's numbers (warm and fork-point seconds, a fork point's bytes,
     latency percentiles, lane-windows/s, window-cache hits and misses,
     peak memory); then ``core.fleet.run_fleet`` (random, 4 replicas, 8
     windows; counts reset before, read after), each replica bitwise equal
     to ``run_windows`` seeded seed + i; a ``Simulation`` paused from
     another thread for 0.2 s (it must not advance) and resumed, equal to
     a straight run; ``monitor.render`` of phase 4's final state;
  11. the MoE and SSD families, after every earlier phase's memory is
     released: qwen2-moe-a2.7b at full width and depth (24 layers, 60
     experts top-4 and 4 shared, 14.3 B f32 parameters seeded 0 on the
     card), F at its prefill shape (4, 512, 16, 128) bf16 against its plain
     version and timed beside SDPA, ``ServingEngine.generate`` on 4 x 512
     prompts and 32 new tokens through F (24 launches, counts reset just
     before and read just after), one MoE layer at the prefill shape run
     twice and bitwise equal, the share of layer 0's tokens whose experts
     move between the kernel and xla attention in bf16, greedy tokens of
     the two paths equal in f32 compute (>= 0.98; the f32 prefill logits
     within 2e-2 relative L2), and with capacity factor 16 in f32 a 24-token
     prefill plus 7 decode steps within 2e-2 of the full forward (argmax
     agreement > 0.98); mamba2-780m at full width (48 layers, 0.78 B):
     serving at 4 x 512 (no kernel: no attention layer), a 512-token
     prefill plus 31 decode steps in f32 within 2e-2 of a full forward over
     640 tokens, the intra-chunk decay's gradient at chunk 128 (the
     reference's form NaN, the port's finite), G at its training shape
     (2,048, 1,536, 50,432) bf16 against its plain version and timed, and
     three training steps with ``chunked_ce=True`` and full remat (G once a
     step, finite losses and gradient norms); jamba-1.5-large-398b reduced
     (one repeat of its 8 positions, chunk 8, capacity factor 16, f32, F
     pallas) prefill plus 7 decode steps within 1e-3 of its full forward;
     prefill, decode, step times, tokens/s, peak memory and a profile of
     each path, printed beside the card's name and power limit;
  12. the mesh-sharded fleet and the full cell: phase 5's 8 lanes, trace
     and windows through ``ScenarioFleet(mesh=fleet_mesh(1))``, a world of
     1 over NCCL (the group destroyed before the phase ends); every stats
     column, state field and ``report()`` bitwise phase 5's unsharded
     (switchless) fleet; launch counts reset just before and read just
     after (A, B in mode 'both' and C once a window, D never, E as in
     phase 5); a sharded snapshot restored into an unsharded fleet,
     bitwise; windows/s and lane-windows/s beside phase 5's; then
     ``configs/agocs_full_cell`` (12,500 nodes, 262,144 task slots, E =
     8,192) at the path's ``sched_batch`` of 1,024: node ADDs streamed
     over two windows, 2,048 tasks, a 2,000-node removal and
     ``evict_invalid``, a resync, the invariants, against the same windows
     through the plain versions on the card (state bitwise, stats bitwise
     but the variances, within rtol 2.5e-7; no kernel launched there);
  13. the LM on a mesh, a world of 1 over NCCL (``make_host_mesh(1, 1)``,
     destroyed in a ``finally`` each time): its serving part runs inside
     phase 11 on qwen2-moe-a2.7b's parameter tensors (placed by
     ``param_shardings`` with no copy; ``moe_impl="shard_map"`` under
     ``choose_serve_mode``'s rules; bf16 prefill logits bitwise the
     unsharded path's, f32 greedy tokens equal phase 11's, F launched once
     a layer a prefill, peak memory within 1 GiB of phase 11's; one
     decode step traced unsharded, on the mesh through the EP path and
     through gspmd: device time by kernel, busy share, and the host's
     Python time by package); then qwen3-4b trained 2 steps at full width
     under 'train' rules (first loss bitwise phase 8's, G once a step),
     one more mesh step and one unsharded step on the same tensors traced
     (device time by category, busy share, peak, the operators whose
     memory differs), the runner restoring onto the mesh through an
     injected crash at reduced width, and ``compressed_psum`` over NCCL
     bitwise a numpy oracle;
  14. the dry-run planners (fake worlds; every number beside the card,
     none a claim): phase 8's step planned on a fake (1, 1) mesh with fake
     CUDA tensors, held to phase 8's real step (one more step counted by
     ``FlopCounterMode`` with G by its formula, its peak memory, the traced
     step's device time): planned flops equal exactly, planned peak within
     0.8-1.25x ``max_memory_allocated``, the roofline bound max(compute,
     memory) at most 1.05x the device time; qwen3-4b ``train_4k`` and
     qwen2-moe-a2.7b ``decode_32k`` on 16x16 (fake worlds of 256 in their
     own processes, started before phase 11): fake-pass seconds, live
     GiB/dev, fits, the three terms, the dominant one; ``lower_fleet`` at
     cell A (greedy, 8 of phase 5's windows) on 16x16, rank 0's replica
     bitwise ``run_fleet``'s replica 0, its kernels' launches counted;
  15. a ``kernels:`` status line, phase 6's, phase 10's, phase 11's,
     phase 12's, phase 13's and phase 14's numbers as JSON lines, and the
     JSON kernel table (seven kernels, launches by path; F's body and
     tensor-core launches, F at qwen2-moe's and G at mamba2's shapes, B and
     D's cluster size; E's surrogate shape).

The seven CUDA kernels are built at first use from every
``src/repro_torch/csrc/*.cu`` (one nvcc per source, all started together)
into the git-ignored ``build/kernels/<hash>/``.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before it; without a CUDA device, or without the repository
beside this file, the script fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
PROFILE_WINDOWS = 16          # traced windows of the main path (phase 4)
FLEET_WINDOWS = 32            # windows of the cell-A fleet (phase 5)
FLEET_B = 8                   # lanes of the cell-A fleet
# the kernels each driven path runs (launch counts must be > 0 there)
MAIN_PATH = ("constraint_match", "placement_commit", "window_stats",
             "segment_usage")
FLEET_PATH = ("constraint_match", "window_stats", "sched_commit",
              "segment_usage")
SERVE_PATH = ("flash_attention",)
TRAIN_PATH = ("fused_ce",)
SERVE_ARCH = "qwen3-4b"       # the served model, at full width
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
TRAIN_ARCH = "qwen3-4b"       # the trained model, at full width
TRAIN_B, TRAIN_SEQ = 4, 512   # 2,048 tokens a step
TRAIN_TIMED = 3               # timed steps after one warm-up step
# device kernels of a train step by name, first match wins
TRAIN_CATEGORIES = (
    ("G fused_ce", ("fused_ce",)),
    ("f32 GEMMs (SIMT: attention products, G's backward recompute)",
     ("f32f32", "sgemm", "gemmSN", "gemv")),
    ("bf16 GEMMs (projections, MLP, their gradients)", ("nvjet", "gemm")),
    ("copies and casts", ("copy", "Copy", "Memset", "Memcpy")),
    ("elementwise and reductions (norms, RoPE, softmax, AdamW)",
     ("elementwise", "reduce", "Reduce", "softmax", "Softmax")),
)
ULP_RTOL = 2.5e-7             # "within 2 ulp" for the variances
SLEEP_CYCLES = 2_000_000      # ~1 ms of device clock before a timed call
G_TC_BODY = "tensor cores: TMA + wgmma m64n256k16, bf16 in, f32 out"
BIG_N = (20_000, 150_000)     # B and D past the old node ceiling
BIG_P = 64
E_BIG_N, E_BIG_V = 70_000, 12  # E past its old ceilings (3 passes)
STOCHASTIC = ("random", "simulated_annealing", "tabu_search", "genetic")
STOCH_WINDOWS = 8             # windows of each stochastic run (phase 6)
STOCH_BATCH = 4               # their batches: a snapshot between two
GA_POP = 8                    # the genetic scheduler's population
SERVICE_SCHEDULERS = ("greedy", "first_fit", "random")   # phase 10's table
SERVICE_LANES = 8             # the server's lanes (max_lanes)
SERVICE_BW = 32               # its batch_windows and fork cadence
FLEET_REPLICAS = 4            # run_fleet's replicas (phase 10)
FAMILY_MOE = "qwen2-moe-a2.7b"        # served at full width (phase 11)
FAMILY_SSM = "mamba2-780m"            # served and trained at full width
FAMILY_HYBRID = "jamba-1.5-large-398b"  # reduced: 398 B parameters at full
SSM_CHECK_LEN = 640                   # the f32 check's full forward: 5 chunks
MESH_TRAIN_STEPS = 2                  # phase 13's training steps on the mesh
TRACE_STEPS = 4                       # phase 13's traced decode steps


PLUGIN = "smoke_pack_left"     # the fleet's external-family lane


def _tf_pack_left(cfg, ctx, rng, params):
    """Consolidation: prefer the most-reserved node (a proposal the fused
    kernel cannot derive, so its rows reach kernel D as ``ext``)."""
    return ctx.node_reserved.sum(-1)[None, :].expand(ctx.base_ok.shape)


def _propose_pack_left(state, cfg, rng, idx, valid, base_ok, scores):
    return state.node_reserved.sum(-1)[None, :].expand(base_ok.shape)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def grid(rng, lo, hi, shape, q=128):
    """Values exactly representable in f32 (multiples of 1/q)."""
    return (rng.integers(lo, hi, shape) / q).astype(np.float32)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` with L2 flushed before each run.
    A ~1 ms device sleep queued before the start event lets the host
    enqueue ``fn``'s launches ahead of the device, so a call whose device
    time is below its host enqueue time is timed on the device."""
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
    return float(np.median(times))


BENCHES = ("match_store", "stats_split")   # src/repro_torch/bench/*.cu


def start_bench_builds(build) -> dict:
    """Start one nvcc a bench program, beside the kernels' own build;
    returns {name: (executable, process)}."""
    out = build.build_dir().parent / "bench"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in BENCHES:
        exe = out / name
        cmd = [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-O3", "-std=c++17", "--fmad=false", "-I",
               str(build.CSRC), str(ROOT / "src/repro_torch/bench" /
                                    f"{name}.cu"), "-o", str(exe), "-ldl"]
        procs[name] = (exe, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def run_bench(exe: Path) -> dict:
    """Run a bench program; print its lines; return its last line's JSON."""
    done = subprocess.run([str(exe)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=300)
    lines = done.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    assert done.returncode == 0 and lines, \
        f"{exe.name} failed ({done.returncode}):\n{done.stdout}"
    return json.loads(lines[-1])


def profile_call(torch, fn, label: str, top: int = 15) -> dict:
    """torch.profiler over one call of ``fn``: the top device time by name
    and the summed device time over the wall time. Returns the device
    microseconds and launch count by kernel name."""
    return profile_detail(torch, fn, label, top)["rows"]


def profile_detail(torch, fn, label: str, top: int = 15,
                   memory: bool = False, cpu: bool = True) -> dict:
    """:func:`profile_call`'s trace, returned with its wall time and, with
    ``memory``, the operators that allocated the most device memory (net
    of what they freed; the profiler's ``profile_memory``). ``cpu=False``
    records the device's kernels alone (the host's operators are many
    thousands a decode step, and summing them takes seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA],
                 profile_memory=memory) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    rows, mem = {}, {}
    for e in prof.key_averages():
        # device-side events only: a CPU op's row repeats its kernels' time
        if e.device_type != DeviceType.CUDA:
            if memory:
                b = getattr(e, "self_device_memory_usage", None)
                if b is None:
                    b = e.self_cuda_memory_usage
                if b > 0:
                    mem[e.key] = (b, e.count)
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows[e.key] = (dev_us, e.count)
    busy = sum(r[0] for r in rows.values())
    print(f"profile {label}, wall {wall_us / 1e3:.3f} ms, "
          f"summed device time {busy / 1e3:.3f} ms "
          f"(busy share {busy / wall_us:.3f})")
    for key, (dev_us, count) in sorted(rows.items(),
                                       key=lambda kv: -kv[1][0])[:top]:
        print(f"  {dev_us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")
    return dict(rows=rows, wall_us=wall_us, busy_us=busy, mem=mem)


def by_category(rows: dict) -> dict:
    """A train step's device time and launches by ``TRAIN_CATEGORIES``."""
    cats = {}
    for k, (dev_us, count) in rows.items():
        cat = next((c for c, keys in TRAIN_CATEGORIES if any(
            key in k for key in keys)), "other")
        us, n = cats.get(cat, (0.0, 0))
        cats[cat] = (us + dev_us, n + count)
    return cats


def decode_step_trace(torch, engine, toks, label: str) -> dict:
    """One decode step of ``engine`` on the card and on the host: the
    device time by kernel (two device-only profiles, ``generate`` of 1 and
    of 1 + ``TRACE_STEPS`` tokens, their difference over ``TRACE_STEPS``),
    its wall time and busy share, and where the host's Python time goes
    (cProfile over the longer run, self time by file: DTensor's dispatch,
    the rest of torch, this package)."""
    import cProfile
    import pstats
    n = TRACE_STEPS
    engine.generate(toks, 2)                          # warm
    pre = profile_detail(torch, lambda: engine.generate(toks, 1),
                         f"{label}: prefill", top=0, cpu=False)
    dec = profile_detail(torch, lambda: engine.generate(toks, 1 + n),
                         f"{label}: prefill + {n} decode steps", top=0,
                         cpu=False)
    per = {k: ((v[0] - pre["rows"].get(k, (0, 0))[0]) / n,
               (v[1] - pre["rows"].get(k, (0, 0))[1]) / n)
           for k, v in dec["rows"].items()}
    wall = (dec["wall_us"] - pre["wall_us"]) / n
    dev_us = sum(v[0] for v in per.values())
    n_k = sum(v[1] for v in per.values())
    print(f"{label}: one decode step: wall {wall / 1e3:.3f} ms, device "
          f"{dev_us / 1e3:.3f} ms (busy share {dev_us / wall:.3f}), "
          f"{n_k:.1f} kernel launches")
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    for key, (us, count) in top:
        print(f"  {us / 1e3:10.3f} ms  x{count:<6.4g} {key[:90]}")
    pr = cProfile.Profile()
    pr.enable()
    engine.generate(toks, 1 + n)
    torch.cuda.synchronize()
    pr.disable()
    dt_py = "torch.distributed.tensor (DTensor dispatch, redistribute)"
    groups = {dt_py: 0.0, "torch's other Python": 0.0, "repro_torch": 0.0,
              "C calls (torch operators, their launches)": 0.0,
              "other Python": 0.0}
    for (fname, _, _), (_, _, tt, _, _) in pstats.Stats(pr).stats.items():
        fname = fname.replace("\\", "/")
        g = (dt_py if "torch/distributed/tensor" in fname else
             "torch's other Python" if "/torch/" in fname else
             "repro_torch" if "repro_torch" in fname else
             "C calls (torch operators, their launches)" if fname == "~"
             else "other Python")
        groups[g] += tt
    total = sum(groups.values())
    print(f"{label}: host Python self time over prefill + {n} decode steps "
          f"(cProfile, {total * 1e3:.1f} ms with its own overhead): " +
          ", ".join(f"{g} {t / total:.3f}" for g, t in groups.items()))
    return dict(wall_ms=wall / 1e3, device_ms=dev_us / 1e3,
                busy_share=dev_us / wall, launches=n_k,
                top=[(k[:60], us / 1e3, c) for k, (us, c) in top],
                host_self_share={g: t / total for g, t in groups.items()})


def profile_run(torch, make_driver, label: str, n_windows: int) -> None:
    """torch.profiler over a warm run of the driver ``make_driver()``
    builds."""
    make_driver().run()                     # warm-up
    profile_call(torch, make_driver().run, f"{label}: {n_windows} windows")


def families_phase(torch, dev, smi, reset_counts, counters, results,
                   seed: int) -> dict:
    """Phase 11: the MoE and SSD families (qwen2-moe-a2.7b and mamba2-780m
    at full width, jamba-1.5-large-398b reduced). Phase 13's serving part
    (:func:`mesh_serve_moe`) runs on qwen2-moe's parameters while they are
    alive. Returns the launch counts by path and the phase's numbers;
    raises on any failed check."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.fused_ce import ops as ce_ops
    from repro_torch.kernels.fused_ce.ref import fused_ce_ref
    from repro_torch.models import attention, mamba, moe
    from repro_torch.models import model as lm
    from repro_torch.models.layers import rms_norm
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train import optim
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.step import make_train_step

    t_phase = time.time()
    launches, nums = {}, {"card": smi}

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    def timed_ms(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3, out

    def tensors(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in tensors(v)]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in tensors(v)]
        return [tree]

    def describe_params(cfg, params, t0):
        ts = tensors(params)
        n = sum(t.numel() for t in ts)
        gb = sum(t.numel() * t.element_size() for t in ts) / 1e9
        print(f"families: {cfg.name} at full width: {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab_size} (padded "
              f"{cfg.padded_vocab}); {n / 1e9:.4f} B parameters counted on "
              f"the card (the config's param_count {cfg.param_count() / 1e9:.4f}"
              f" B), {gb:.3f} GB {cfg.param_dtype}, initialised in "
              f"{time.time() - t0:.1f}s")
        return n

    def serve_timed(cfg, engine, prompts, path):
        engine.generate(prompts, 2)        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        gen_ms, out = timed_ms(lambda: engine.generate(prompts, SERVE_GEN))
        launches[path] = counts()
        f_tc = fa_ops.flash_attention_cuda.launches_tc
        peak = torch.cuda.max_memory_allocated(dev)
        assert out.shape == (SERVE_B, SERVE_GEN) and out.dtype == torch.int32
        assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
        pre_ms = float(np.median([timed_ms(lambda: engine.generate(
            prompts, 1))[0] for _ in range(3)]))
        full_ms = float(np.median([gen_ms] + [timed_ms(
            lambda: engine.generate(prompts, SERVE_GEN))[0]
            for _ in range(2)]))
        dec_ms = (full_ms - pre_ms) / (SERVE_GEN - 1)
        row = dict(prefill_ms=pre_ms, decode_ms=dec_ms, generate_ms=full_ms,
                   new_tokens_per_s=SERVE_B * SERVE_GEN / full_ms * 1e3,
                   decode_tokens_per_s=SERVE_B / dec_ms * 1e3,
                   peak_gib=peak / 2 ** 30)
        print(f"families serve {cfg.name}: {SERVE_B} prompts x "
              f"{SERVE_PROMPT} tokens, {SERVE_GEN} new tokens each: prefill "
              f"{pre_ms:.3f} ms, decode {dec_ms:.3f} ms a step, generate "
              f"{full_ms:.3f} ms (medians of 3), new tokens/s "
              f"{row['new_tokens_per_s']:.2f} end to end, "
              f"{row['decode_tokens_per_s']:.2f} in decode; peak "
              f"{row['peak_gib']:.3f} GiB [{smi}]")
        print(f"launches ({path} run): {launches[path]}; F through its "
              f"tensor-core body: {f_tc}")
        prof = profile_call(torch, lambda: engine.generate(prompts, 2),
                            f"{cfg.name} prefill + 1 decode step", top=10)
        row["busy_ms"] = sum(v[0] for v in prof.values()) / 1e3
        return out, row, f_tc

    def decode_vs_forward(params, cfg, toks, n_prompt, n_steps, cache_dtype):
        """prefill on toks[:, :n_prompt], n_steps - 1 decode steps fed
        from toks; (max abs difference from the full forward's logits at
        those positions, argmax agreement, the forward's aux)."""
        with torch.inference_mode():
            full, aux = lm.forward(params, cfg, toks)
            want = full[:, n_prompt - 1:n_prompt - 1 + n_steps]
            del full
            logits, cache = lm.prefill(params, cfg, toks[:, :n_prompt],
                                       toks.shape[1], cache_dtype=cache_dtype)
            outs = [logits]
            for i in range(n_steps - 1):
                logits, cache = lm.decode_step(
                    params, cfg, toks[:, n_prompt + i:n_prompt + i + 1],
                    cache, n_prompt + i)
                outs.append(logits)
            dec = torch.cat(outs, dim=1)
        V = cfg.vocab_size
        err = float((dec[..., :V] - want[..., :V]).abs().max())
        agree = float((dec[..., :V].argmax(-1) == want[..., :V].argmax(-1))
                      .float().mean())
        return err, agree, float(aux)

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"families: memory held before the phase "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} GiB")

    # ---- qwen2-moe-a2.7b at full width and depth ----------------------
    mcfg = dataclasses.replace(get_config(FAMILY_MOE),
                               attention_impl="pallas")
    t0 = time.time()
    params = lm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    nums["moe_params"] = describe_params(mcfg, params, t0)
    T_pre = SERVE_B * SERVE_PROMPT
    print(f"families: {mcfg.name} MoE capacity {moe.capacity(T_pre, mcfg)} "
          f"a prefill ({T_pre} tokens, {mcfg.n_experts} experts top-"
          f"{mcfg.moe_top_k}: {mcfg.n_experts * moe.capacity(T_pre, mcfg)} "
          f"slots for {T_pre * mcfg.moe_top_k} assignments), "
          f"{moe.capacity(SERVE_B, mcfg)} a decode step")
    prompts = torch.randint(
        0, mcfg.vocab_size, (SERVE_B, SERVE_PROMPT),
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
        device=dev, dtype=torch.int32)
    max_seq = SERVE_PROMPT + SERVE_GEN + 1

    # F at this path's shape against its plain version, and its times
    fshape = (SERVE_B, SERVE_PROMPT, mcfg.n_heads, mcfg.resolved_head_dim)
    fg = torch.Generator(device=dev).manual_seed(seed + 5)
    fq, fk, fv = (torch.randn(fshape, generator=fg, device=dev,
                              dtype=torch.bfloat16) for _ in range(3))
    f_scale = 1.0 / mcfg.resolved_head_dim ** 0.5
    n_tc = fa_ops.flash_attention_cuda.launches_tc
    got = fa_ops.flash_attention(fq, fk, fv, causal=True, scale=f_scale)
    assert fa_ops.flash_attention_cuda.launches_tc == n_tc + 1
    err = float((got.float() - attention_ref(
        fq, fk, fv, causal=True, scale=f_scale).float()).abs().max())
    assert err <= 2e-2, f"F at {fshape}: max abs err {err}"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    Bq, Sq, Hq, Dq = fshape
    f_row = dict(shape=list(fshape), dtype="bfloat16", max_abs_err=err,
                 ms=time_ms(torch, lambda: fa_ops.flash_attention(
                     fq, fk, fv, causal=True, scale=f_scale), 20),
                 plain_ms=time_ms(torch, lambda: attention_ref(
                     fq, fk, fv, causal=True, scale=f_scale), 5, warmup=1),
                 library_ms=time_ms(torch, lambda: sdpa(
                     fq.transpose(1, 2), fk.transpose(1, 2),
                     fv.transpose(1, 2), is_causal=True, scale=f_scale), 20))
    f_row["bound_ms"], f_row["bound_by"] = bound_ms(
        nbytes(fq, fk, fv) + fq.numel() * 2,
        4 * Bq * Hq * Dq * Sq * (Sq + 1) / 2, BF16_OPS_PER_S)
    print(f"F flash_attention at {mcfg.name}'s prefill B={Bq} S={Sq} "
          f"H={Hq} D={Dq} bf16 causal (tensor-core body): max abs err "
          f"{err:.3g} (<= 2e-2); kernel {f_row['ms']:.4f} ms, plain "
          f"{f_row['plain_ms']:.4f} ms, library {f_row['library_ms']:.4f} ms"
          f" (scaled_dot_product_attention), bound {f_row['bound_ms']:.4f} "
          f"ms ({f_row['bound_by']}) [{smi}]")
    del fq, fk, fv, got

    engine = ServingEngine(mcfg, params, max_seq)
    out_k, nums["moe_serve"], f_tc = serve_timed(mcfg, engine, prompts,
                                                 "serve_moe")
    assert launches["serve_moe"]["flash_attention"] == mcfg.n_layers
    assert f_tc == mcfg.n_layers, f"F's TC body launched {f_tc} times"
    f_row["launches_per_prefill"] = launches["serve_moe"]["flash_attention"]
    results["flash_attention"]["qwen2_moe_serve"] = f_row

    # one MoE layer at the prefill shape, twice: bitwise equal
    run = engine._run_params
    layer = {n: w[0] for n, w in run["blocks"][0]["mlp"].items()}
    h = torch.randn((SERVE_B, SERVE_PROMPT, mcfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed),
                    dtype=torch.bfloat16)
    with torch.inference_mode():
        y1, a1 = moe.apply(layer, mcfg, h)
        y2, a2 = moe.apply(layer, mcfg, h)
    assert torch.equal(y1, y2) and torch.equal(a1, a2), "MoE not bitwise"
    assert bool(torch.isfinite(y1.float()).all()) and bool(torch.isfinite(a1))
    print(f"families: one MoE layer at the prefill shape {tuple(h.shape)} "
          f"bf16, run twice: output and aux bitwise equal (aux "
          f"{float(a1):.6f})")

    # in bf16 the two attention paths differ by ~1e-2 relative; where a
    # token's 4th and 5th router probabilities are that close its experts
    # change, and with them its output outright. Counted at layer 0, the
    # first place it can happen:
    xla_cfg = dataclasses.replace(mcfg, attention_impl="xla")
    with torch.inference_mode():
        p0 = lm._layer(run["blocks"][0], 0)
        x0, pos = lm._prefix(run, mcfg, prompts, None)
        routes = []
        for c in (mcfg, xla_cfg):
            hh = rms_norm(x0, p0["norm_mixer"]["w"], c.norm_eps)
            x1 = x0 + attention.apply(p0["mixer"], c, hh, pos)
            hh = rms_norm(x1, p0["norm_mlp"]["w"], c.norm_eps)
            routes.append(moe.route(hh.reshape(-1, c.d_model),
                                    p0["mlp"]["router"], c)[1].sort(-1).values)
    flips = float((routes[0] != routes[1]).any(-1).float().mean())
    del run, layer, h, y1, y2, engine, p0, x0, x1, hh, routes
    gc.collect()

    # the same parameters and prompts through the plain einsum attention:
    # bf16 generations (reported), then f32 ones, whose greedy tokens are
    # held to agree
    engine_x = ServingEngine(xla_cfg, params, max_seq)
    engine_x.generate(prompts, 2)
    xla_ms, out_x = timed_ms(lambda: engine_x.generate(prompts, SERVE_GEN))
    del engine_x
    agree16 = int((out_k == out_x).sum())
    out32, rows = {}, {}
    V = mcfg.vocab_size
    for c in (mcfg, xla_cfg):
        c = dataclasses.replace(c, dtype="float32")
        eng = ServingEngine(c, params, max_seq)   # f32: casts nothing
        out32[c.attention_impl] = eng.generate(prompts, SERVE_GEN)
        del eng
        with torch.inference_mode():
            rows[c.attention_impl] = lm.prefill(
                params, c, prompts, max_seq)[0][:, 0, 0, :V].float()
    gc.collect()
    for r in rows.values():
        assert bool(torch.isfinite(r).all()), "non-finite logits"
    a, b = rows["pallas"], rows["xla"]
    first = out32["pallas"][:, 0].long()
    gap = b.max(-1).values - b.gather(1, first[:, None])[:, 0]
    rel32 = ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()
    agree32 = int((out32["pallas"] == out32["xla"]).sum())
    n_tok = out_k.numel()
    print(f"families serve {mcfg.name} xla: generate {xla_ms:.3f} ms (one "
          f"run, bf16) [{smi}]; bf16: kernel and xla paths agree on "
          f"{agree16} of {n_tok} tokens, layer 0 routes {flips:.4f} of the "
          f"{T_pre} prompt tokens to other experts; f32: agree on {agree32} "
          f"of {n_tok} tokens (>= 0.98), xla logit at the kernel path's "
          f"first token {gap.tolist()} below its maximum (<= 0.05), prefill "
          f"logits relative L2 kernel vs xla {rel32} (< 2e-2)")
    assert agree32 >= 0.98 * n_tok, (agree32, n_tok)
    assert bool((gap <= 0.05).all()), gap
    assert max(rel32) < 2e-2, rel32
    nums["moe_serve"].update(xla_generate_ms=xla_ms, bf16_tokens_agree=agree16,
                             layer0_route_moved=flips,
                             f32_tokens_agree=agree32,
                             f32_first_token_gap=gap.tolist(),
                             rel_l2_f32=rel32)
    nums["mesh_serve"] = mesh_serve_moe(torch, dev, smi, reset_counts,
                                        counters, mcfg, params, prompts,
                                        max_seq, nums["moe_serve"],
                                        out32["pallas"])
    launches["mesh_serve"] = nums["mesh_serve"].pop("launches")
    del rows, a, b, out32

    # f32 compute, a loose capacity: 24-token prefill + 7 decode steps
    # through the whole model against its full forward
    fcfg = dataclasses.replace(mcfg, dtype="float32", capacity_factor=16.0)
    toks = torch.randint(0, V, (2, 32), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 2))
    err, agree_f, aux = decode_vs_forward(params, fcfg, toks, 24, 8,
                                          torch.float32)
    print(f"families {mcfg.name} f32, capacity_factor 16: prefill of 24 + 7 "
          f"decode steps against the full forward: max abs {err:.3g} "
          f"(< 2e-2), argmax agreement {agree_f:.4f} (> 0.98); aux {aux:.6f}"
          f" (finite)")
    assert err < 2e-2 and agree_f > 0.98, (err, agree_f)
    assert np.isfinite(aux) and aux > 0, aux
    nums["moe_decode_check"] = dict(max_abs=err, agree=agree_f, aux=aux)
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()

    # ---- mamba2-780m at full width: serve, check, train -----------------
    scfg = get_config(FAMILY_SSM)
    t0 = time.time()
    params = lm.init_params(scfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    nums["ssm_params"] = describe_params(scfg, params, t0)
    prompts = torch.randint(
        0, scfg.vocab_size, (SERVE_B, SERVE_PROMPT),
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
        device=dev, dtype=torch.int32)
    engine = ServingEngine(scfg, params, max_seq)
    _, nums["ssm_serve"], _ = serve_timed(scfg, engine, prompts, "serve_ssm")
    del engine
    gc.collect()
    # f32 compute: the prompts' 512 tokens (4 chunks of 128), then 31
    # decode steps; the full forward runs over 640 tokens (5 chunks) and
    # causality leaves its first 543 positions those of the 543-token
    # sequence
    tail = torch.randint(0, scfg.vocab_size,
                         (SERVE_B, SSM_CHECK_LEN - SERVE_PROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 3), dtype=torch.int32)
    toks = torch.cat([prompts, tail], dim=1)
    err, agree_s, _ = decode_vs_forward(
        params, dataclasses.replace(scfg, dtype="float32"), toks,
        SERVE_PROMPT, SERVE_GEN, torch.float32)
    print(f"families {scfg.name} f32: prefill of {SERVE_PROMPT} + "
          f"{SERVE_GEN - 1} decode steps against the full forward over "
          f"{SSM_CHECK_LEN} tokens: max abs {err:.3g} (< 2e-2), argmax "
          f"agreement {agree_s:.4f} (> 0.98)")
    assert err < 2e-2 and agree_s > 0.98, (err, agree_s)
    nums["ssm_decode_check"] = dict(max_abs=err, agree=agree_s)
    del toks, tail, prompts, params
    gc.collect()
    torch.cuda.empty_cache()

    # at this shape the reference's decay form gives a NaN
    # gradient at chunk 128, the port's masked exponent a finite one
    Q, H = scfg.ssm_chunk, scfg.ssm_heads
    dg = torch.Generator(device=dev).manual_seed(seed + 4)
    dt_raw = torch.randn((TRAIN_B, Q, H), generator=dg, device=dev)
    upstream = torch.randn((TRAIN_B, Q, Q, H), generator=dg, device=dev)
    nan_counts = []
    for form in ("reference", "port"):
        dt = torch.nn.functional.softplus(dt_raw).requires_grad_()
        cumq = torch.cumsum(dt * -np.e, dim=1)
        if form == "port":
            decay = mamba.intra_chunk_decay(cumq)
        else:
            ltri = torch.ones((Q, Q), dtype=torch.bool,
                              device=dev).tril()[None, :, :, None]
            decay = torch.where(ltri, torch.exp(cumq[:, :, None]
                                                - cumq[:, None]), 0.0)
        (decay * upstream).sum().backward()
        nan_counts.append(int(torch.isnan(dt.grad).sum()))
    print(f"families: the intra-chunk decay's gradient at chunk {Q} (B="
          f"{TRAIN_B}, H={H}, A=-e, dt=softplus(normal)): NaN in "
          f"{nan_counts[0]} of {dt.numel()} with the reference's "
          f"where(exp) form, in {nan_counts[1]} with the masked exponent")
    assert nan_counts[1] == 0
    nums["decay_grad_nan"] = dict(reference=nan_counts[0],
                                  port=nan_counts[1], of=dt.numel())
    del dt_raw, upstream, dt, cumq, decay

    # G at this path's shape against its plain version, and its times
    tcfg = dataclasses.replace(scfg, chunked_ce=True)
    gT, gd, gVp, gV = (TRAIN_B * TRAIN_SEQ, tcfg.d_model, tcfg.padded_vocab,
                       tcfg.vocab_size)
    gg = torch.Generator(device=dev).manual_seed(seed + 6)
    gx = torch.randn((gT, gd), generator=gg, device=dev).bfloat16()
    gw = (torch.randn((gVp, gd), generator=gg, device=dev) * 0.02).bfloat16()
    glab = torch.randint(0, gV, (gT,), generator=gg, device=dev,
                         dtype=torch.int32)
    glab[::7] = -1
    n_tc = ce_ops.fused_ce_cuda.launches_tc
    nll_k, lse_k = ce_ops.fused_ce_with_lse(gx, gw, glab, gV)
    assert ce_ops.fused_ce_cuda.launches_tc == n_tc + 1, "G: not the TC body"
    nll_r, lse_r = fused_ce_ref(gx, gw, glab, gV)
    err = max(float((nll_k - nll_r).abs().max()),
              float((lse_k - lse_r).abs().max()))
    assert err <= 2e-3, f"G at mamba2's shape: max abs err {err}"
    fnl = torch.nn.functional
    glab_l = glab.long()
    g_row = dict(T=gT, d=gd, Vp=gVp, V=gV, dtype="bfloat16", max_abs_err=err,
                 ms=time_ms(torch, lambda: ce_ops.fused_ce_with_lse(
                     gx, gw, glab, gV), 5),
                 plain_ms=time_ms(torch, lambda: fused_ce_ref(
                     gx, gw, glab, gV), 3, warmup=1),
                 library_ms=time_ms(torch, lambda: fnl.cross_entropy(
                     fnl.linear(gx, gw[:gV]).float(), glab_l,
                     reduction="none", ignore_index=-1), 5))
    g_row["bound_ms"], g_row["bound_by"] = bound_ms(
        nbytes(gx, gw, glab) + 2 * gT * 4, 2 * gT * gVp * gd, BF16_OPS_PER_S)
    print(f"G fused_ce at {tcfg.name}'s training shape T={gT} d={gd} "
          f"Vp={gVp} V={gV} bf16 (tensor-core body): max abs err {err:.3g} "
          f"(<= 2e-3); kernel {g_row['ms']:.4f} ms, plain "
          f"{g_row['plain_ms']:.4f} ms, library {g_row['library_ms']:.4f} ms"
          f" (linear + cross_entropy), bound {g_row['bound_ms']:.4f} ms "
          f"({g_row['bound_by']}) [{smi}]")
    del gx, gw, glab, glab_l, nll_k, lse_k, nll_r, lse_r

    # three training steps, chunked_ce (kernel G), full remat
    t0 = time.time()
    tparams = lm.init_params(tcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    topt = optim.init_opt_state(tparams)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"families train: {tcfg.name} at full width, chunked_ce "
          f"(ce_chunks {tcfg.ce_chunks}), remat {tcfg.remat_policy}, "
          f"{tcfg.dtype} activations, SSD chunk {tcfg.ssm_chunk}; "
          f"parameters and moments initialised in {time.time() - t0:.1f}s")
    data = SyntheticLM(tcfg, TRAIN_B, TRAIN_SEQ, seed=0)
    step_fn = make_train_step(tcfg, TrainConfig())

    def train_step(i):
        nonlocal tparams, topt
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.global_batch(i).items()}
        tparams, topt, m = step_fn(tparams, topt, batch, None)
        return float(m["loss"]), float(m["grad_norm"])

    t0 = time.time()
    hist = [train_step(0)]                 # warm-up
    warm_s = time.time() - t0
    reset_counts()
    step_ms = []
    for i in range(1, 1 + TRAIN_TIMED):
        ms, lg = timed_ms(lambda: train_step(i))
        step_ms.append(ms)
        hist.append(lg)
    launches["train_ssm"] = counts()
    g_tc = ce_ops.fused_ce_cuda.launches_tc
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"launches (train_ssm run, {TRAIN_TIMED} steps): "
          f"{launches['train_ssm']}; G through its tensor-core body: {g_tc}")
    assert launches["train_ssm"]["fused_ce"] == TRAIN_TIMED
    assert g_tc == TRAIN_TIMED, f"G's TC body launched {g_tc} times"
    assert all(np.isfinite(v) for lg in hist for v in lg), hist
    med = float(np.median(step_ms))
    print(f"families train {tcfg.name} (loss, grad_norm) (warm-up + "
          f"{TRAIN_TIMED}): {hist}; every gradient finite (a NaN or inf "
          f"leaf would make the norm so)")
    print(f"families train step: {step_ms} ms, median {med:.3f} ms for "
          f"{gT} tokens (warm-up step {warm_s * 1e3:.1f} ms), tokens/s "
          f"{gT / med * 1e3:.2f}, peak {peak / 2 ** 30:.3f} GiB [{smi}]")
    prof = profile_call(torch, lambda: train_step(1 + TRAIN_TIMED),
                        f"{tcfg.name} train step (4 x 512 tokens)", top=10)
    g_row["launches_per_step"] = launches["train_ssm"]["fused_ce"] / TRAIN_TIMED
    results["fused_ce"]["mamba2_train"] = g_row
    nums["ssm_train"] = dict(step_ms=step_ms, median_ms=med,
                             busy_ms=sum(v[0] for v in prof.values()) / 1e3,
                             tokens_per_s=gT / med * 1e3,
                             peak_gib=peak / 2 ** 30, losses=hist,
                             warmup_ms=warm_s * 1e3)
    del tparams, topt, step_fn, data
    gc.collect()
    torch.cuda.empty_cache()

    # ---- jamba-1.5-large-398b reduced: SSD, dense, MoE and F together ----
    jcfg = dataclasses.replace(reduced(get_config(FAMILY_HYBRID)),
                               remat_policy="none", ssm_chunk=8,
                               capacity_factor=16.0, attention_impl="pallas")
    jparams = lm.init_params(jcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    toks = torch.randint(0, jcfg.vocab_size, (2, 32), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed))
    jshape = (2, 32, jcfg.n_heads, jcfg.resolved_head_dim)
    xs = [torch.randn(jshape, generator=fg, device=dev) for _ in range(3)]
    err_f = float((fa_ops.flash_attention(*xs, causal=True)
                   - attention_ref(*xs, causal=True)).abs().max())
    assert err_f <= 1e-5, f"F f32 at {jshape}: max abs err {err_f}"
    reset_counts()
    err, agree_j, aux = decode_vs_forward(jparams, jcfg, toks, 24, 8,
                                          torch.float32)
    launches["hybrid_reduced"] = counts()
    print(f"families {jcfg.name} reduced ({jcfg.n_layers} layers "
          f"{[m + '+' + f for m, f in jcfg.layer_pattern()]}, f32, chunk 8, "
          f"capacity_factor 16): prefill of 24 + 7 decode steps against the "
          f"full forward: max abs {err:.3g} (< 1e-3), argmax agreement "
          f"{agree_j:.4f}, aux {aux:.6f}; F at its shape {jshape} f32 (SIMT "
          f"body) max abs err {err_f:.3g} (<= 1e-5); launches "
          f"{launches['hybrid_reduced']}")
    assert err < 1e-3, err
    assert launches["hybrid_reduced"]["flash_attention"] > 0
    nums["hybrid_check"] = dict(max_abs=err, agree=agree_j, aux=aux)
    del jparams, toks, xs
    nums["phase_s"] = time.time() - t_phase
    print(f"phase 11: {nums['phase_s']:.1f}s [{smi}]")
    return {"launches": launches, "numbers": nums}


class plain_on_card:
    """The engine's four kernel entry points (A, B, C, E) replaced by their
    plain PyTorch versions, run on the card's own tensors: the ops' CPU
    branch, whatever the device. No kernel launches inside."""

    def __init__(self, torch):
        from repro_torch.core import engine, stats
        from repro_torch.sched import base, commit
        self.torch = torch
        self.sites = [(base, "constraint_match", self._match),
                      (commit, "placement_commit", self._commit),
                      (stats, "window_reductions", self._reductions),
                      (engine, "segment_usage_lanes", self._usage)]

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in self.sites]
        for mod, name, fn in self.sites:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def _match(self, *args):
        from repro_torch.kernels.constraint_match.ref import (
            constraint_match_ref)
        if args[0].dim() == 2:
            return constraint_match_ref(*args)
        return self.torch.stack([constraint_match_ref(*[x[b] for x in args])
                                 for b in range(args[0].shape[0])])

    def _commit(self, pref, req, base_ok, valid, total, denom, reserved0,
                dynamic_bestfit=False, *, return_tally=False):
        from repro_torch.kernels.placement_commit.ref import (
            placement_commit_ref)
        args = (pref, req, base_ok, valid, total, denom, reserved0)
        if pref.dim() == 2:
            out = placement_commit_ref(*args, dynamic_bestfit)
        else:
            per_lane = isinstance(dynamic_bestfit, self.torch.Tensor)
            lanes = [placement_commit_ref(
                *[x[b if x.shape[0] > 1 else 0] for x in args],
                dynamic_bestfit[b] if per_lane else dynamic_bestfit)
                for b in range(max(x.shape[0] for x in args))]
            out = tuple(self.torch.stack(f) for f in zip(*lanes))
        return out if return_tally else out[0]

    def _reductions(self, *args):
        from repro_torch.kernels.window_stats.ref import (
            WindowReductions, window_reductions_ref)
        if args[0].dim() == 1:
            return window_reductions_ref(*args)
        lanes = [window_reductions_ref(*[x[b] for x in args])
                 for b in range(args[0].shape[0])]
        return WindowReductions(*[self.torch.stack(f) for f in zip(*lanes)])

    def _usage(self, task_node, values, mask, n_nodes):
        from repro_torch.kernels.segment_usage.ref import (
            segment_usage_lanes_ref)
        return segment_usage_lanes_ref(task_node, values, mask, n_nodes)


def mesh_serve_moe(torch, dev, smi, reset_counts, counters, mcfg, params,
                   prompts, max_seq, phase11, out32) -> dict:
    """Phase 13, serving: qwen2-moe-a2.7b at full width on a world of 1
    over NCCL (``make_host_mesh(1, 1)``), on phase 11's parameter tensors
    (called from phase 11 while they are alive; placing them wraps them
    with no copy): ``moe_impl="shard_map"`` under the rules that
    ``choose_serve_mode`` picks. bf16 prefill logits bitwise the unsharded
    path's, f32 greedy tokens equal phase 11's, F launched as many times,
    timed beside phase 11's serving. Returns its launches and numbers."""
    import torch.distributed as dist
    from repro_torch.config import ShapeConfig
    from repro_torch.distributed import placement
    from repro_torch.distributed.sharding import axis_rules, make_rules
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.engine import ServingEngine

    t_phase = time.time()
    cfg = dataclasses.replace(mcfg, moe_impl="shard_map")

    def timed_ms(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3, out

    # the unsharded path's bf16 prefill logits, on the same parameters,
    # and its decode step traced (the mesh's is traced below)
    engine = ServingEngine(mcfg, params, max_seq)
    with torch.inference_mode():
        want = engine._prefill(engine._run_params, prompts)[0].float()
    trace_plain = decode_step_trace(torch, engine, prompts,
                                    f"{mcfg.name} unsharded, gspmd")
    del engine
    gc.collect()
    mesh = make_host_mesh(data=1, model=1)
    try:
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        shape = ShapeConfig("mesh_serve", "decode", max_seq, SERVE_B)
        mode = placement.choose_serve_mode(shape, mesh)
        rules = make_rules(mesh, mode, cfg)
        with axis_rules(mesh, rules):
            placed = placement.place_tree(
                params, placement.param_shardings(cfg, mesh, rules))
            same = all(a.to_local().data_ptr() == b.data_ptr()
                       for a, b in zip(_leaves(placed), _leaves(params)))
            assert same, "placing the parameters copied a leaf"
            toks = placement.place_tree(
                {"t": prompts},
                {"t": placement.batch_shardings(cfg, mesh, rules)["tokens"]}
            )["t"]
            engine = ServingEngine(cfg, placed, max_seq)
            with torch.no_grad():
                got = engine._prefill(engine._run_params, toks)[0]
            got = got.full_tensor().float()
            bitwise = bool(torch.equal(got, want))
            print(f"mesh serve {cfg.name}: world of 1 over NCCL, mode "
                  f"{mode!r}, moe_impl shard_map; bf16 prefill logits "
                  f"bitwise the unsharded path's: {bitwise} (max abs "
                  f"{float((got - want).abs().max()):.3g})")
            assert bitwise, "mesh prefill logits differ"
            del got, want
            engine.generate(toks, 2)                  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            gen_ms, out = timed_ms(lambda: engine.generate(toks, SERVE_GEN))
            launches = {n: fn.launches for n, fn in counters.items()}
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            pre_ms = float(np.median([timed_ms(lambda: engine.generate(
                toks, 1))[0] for _ in range(3)]))
            full_ms = gen_ms                  # one run: decode is ~10 s
            dec_ms = (full_ms - pre_ms) / (SERVE_GEN - 1)
            trace_mesh = decode_step_trace(
                torch, engine, toks, f"{cfg.name} on the mesh, shard_map")
            del engine
            # the same mesh through the gspmd MoE: what the EP path adds
            # apart from DTensor
            engine = ServingEngine(mcfg, placed, max_seq)
            trace_gspmd = decode_step_trace(
                torch, engine, toks, f"{cfg.name} on the mesh, gspmd")
            del engine
            gc.collect()
            # f32 greedy tokens (f32 casts nothing): equal to phase 11's
            c32 = dataclasses.replace(cfg, dtype="float32")
            eng32 = ServingEngine(c32, placed, max_seq)
            tok32 = eng32.generate(toks, SERVE_GEN).full_tensor()
            del eng32, placed, toks
        agree = int((tok32 == out32).sum())
        print(f"mesh serve {cfg.name}: f32 greedy tokens equal phase 11's "
              f"{agree} of {tok32.numel()}")
        assert torch.equal(tok32, out32), "mesh f32 tokens differ"
        out = out.full_tensor()
        assert out.shape == (SERVE_B, SERVE_GEN)
        p11 = phase11
        row = dict(mode=mode, prefill_ms=pre_ms, decode_ms=dec_ms,
                   generate_ms=full_ms,
                   new_tokens_per_s=SERVE_B * SERVE_GEN / full_ms * 1e3,
                   decode_tokens_per_s=SERVE_B / dec_ms * 1e3,
                   peak_gib=peak, phase11={k: p11[k] for k in (
                       "prefill_ms", "decode_ms", "new_tokens_per_s",
                       "decode_tokens_per_s", "peak_gib")},
                   decode_trace=trace_mesh, decode_trace_gspmd=trace_gspmd,
                   decode_trace_unsharded=trace_plain,
                   launches=launches, card=smi)
        print(f"mesh serve {cfg.name}: one traced decode step, mesh "
              f"shard_map / mesh gspmd / unsharded: wall "
              f"{trace_mesh['wall_ms']:.3f} / {trace_gspmd['wall_ms']:.3f} "
              f"/ {trace_plain['wall_ms']:.3f} ms, device "
              f"{trace_mesh['device_ms']:.3f} / "
              f"{trace_gspmd['device_ms']:.3f} / "
              f"{trace_plain['device_ms']:.3f} ms, kernel launches "
              f"{trace_mesh['launches']:.1f} / {trace_gspmd['launches']:.1f}"
              f" / {trace_plain['launches']:.1f} [{smi}]")
        print(f"mesh serve {cfg.name}: prefill {pre_ms:.3f} ms (phase 11 "
              f"{p11['prefill_ms']:.3f}), decode {dec_ms:.3f} ms a step "
              f"({p11['decode_ms']:.3f}), new tokens/s "
              f"{row['new_tokens_per_s']:.2f} "
              f"({p11['new_tokens_per_s']:.2f}), peak {peak:.3f} GiB "
              f"({p11['peak_gib']:.3f}) [{smi}]")
        print(f"launches (mesh_serve run): {launches}")
        assert launches["flash_attention"] == cfg.n_layers, launches
        assert abs(peak - p11["peak_gib"]) <= 1.0, (peak, p11["peak_gib"])
    finally:
        dist.destroy_process_group()
    row["phase_s"] = time.time() - t_phase
    print(f"phase 13 (serving, inside phase 11): {row['phase_s']:.1f}s "
          f"[{smi}]")
    return row


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def mesh_train_phase(torch, dev, smi, reset_counts, counters, tcfg,
                     phase8) -> dict:
    """Phase 13, training and the rest: qwen3-4b at full width, 2 steps
    under 'train' rules on a world of 1 over NCCL (first loss bitwise
    phase 8's, G once a step); the runner restoring onto the mesh at
    reduced width through an injected crash; ``compressed_psum`` over
    NCCL against a numpy oracle. Returns its launches and numbers."""
    import torch.distributed as dist
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import compression, placement
    from repro_torch.distributed.fault import FaultPlan, FaultTolerantRunner
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  axis_rules, import_shard_map,
                                                  make_rules)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.train import optim
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import map_tree

    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    nums = {"card": smi}
    mesh = make_host_mesh(data=1, model=1)
    try:
        rules = make_rules(mesh, "train", tcfg)
        psh = placement.param_shardings(tcfg, mesh, rules)
        params = lm.init_params(tcfg, torch.Generator(device=dev).manual_seed(
            0), dev)
        opt = optim.init_opt_state(params)
        params, opt = placement.place_tree(
            (params, opt), (psh, placement.opt_shardings(psh, mesh)))
        data = SyntheticLM(tcfg, TRAIN_B, TRAIN_SEQ, seed=0)
        bsh = placement.batch_shardings(tcfg, mesh, rules)
        step_fn = make_train_step(tcfg, TrainConfig())
        losses, step_ms = [], []
        reset_counts()
        with axis_rules(mesh, rules):
            for i in range(MESH_TRAIN_STEPS):
                batch = placement.place_tree(
                    {k: torch.from_numpy(v).to(dev)
                     for k, v in data.global_batch(i).items()},
                    {k: bsh[k] for k in ("tokens", "labels")})
                torch.cuda.synchronize()
                t0 = time.time()
                params, opt, m = step_fn(params, opt, batch, None)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                step_ms.append((time.time() - t0) * 1e3)
        launches = {n: fn.launches for n, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30

        # one more step traced on the mesh, then one on the same tensors
        # unwrapped (to_local: no copy on a world of 1) through a plain
        # step; each step's peak measured once its gradient buffer exists
        def traced(fn, i, label, placed):
            nonlocal params, opt

            def run():
                nonlocal params, opt
                b = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.global_batch(i).items()}
                if placed:
                    b = placement.place_tree(b, {k: bsh[k] for k in b})
                params, opt, _ = fn(params, opt, b, None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            with axis_rules(mesh if placed else None, rules):
                tr = profile_detail(torch, run, label, top=8, memory=True)
            tr["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            return tr
        tr_mesh = traced(step_fn, MESH_TRAIN_STEPS,
                         "mesh train step (4 x 512 tokens)", True)
        del step_fn, batch, m
        gc.collect()
        params, opt = map_tree(
            lambda t: t.to_local() if hasattr(t, "to_local") else t,
            (params, opt))
        plain_fn = make_train_step(tcfg, TrainConfig())
        traced(plain_fn, MESH_TRAIN_STEPS + 1, "plain step (warm)", False)
        tr_plain = traced(plain_fn, MESH_TRAIN_STEPS + 2,
                          "unsharded train step, same tensors", False)
        cm, cp = by_category(tr_mesh["rows"]), by_category(tr_plain["rows"])
        print(f"mesh train step against the unsharded step on the same "
              f"tensors: wall {tr_mesh['wall_us'] / 1e3:.3f} against "
              f"{tr_plain['wall_us'] / 1e3:.3f} ms, device "
              f"{tr_mesh['busy_us'] / 1e3:.3f} against "
              f"{tr_plain['busy_us'] / 1e3:.3f} ms (busy share "
              f"{tr_mesh['busy_us'] / tr_mesh['wall_us']:.3f} against "
              f"{tr_plain['busy_us'] / tr_plain['wall_us']:.3f}), peak "
              f"{tr_mesh['peak_gib']:.3f} against {tr_plain['peak_gib']:.3f}"
              f" GiB [{smi}]; device time by category, mesh / unsharded:")
        for cat in sorted(set(cm) | set(cp),
                          key=lambda c: -cm.get(c, (0, 0))[0]):
            (um, nm), (up, n_p) = cm.get(cat, (0, 0)), cp.get(cat, (0, 0))
            print(f"  {um / 1e3:10.3f} / {up / 1e3:10.3f} ms  x{nm} / "
                  f"x{n_p}  {cat}")
        mem_d = {k: tr_mesh["mem"].get(k, (0, 0))[0]
                 - tr_plain["mem"].get(k, (0, 0))[0]
                 for k in set(tr_mesh["mem"]) | set(tr_plain["mem"])}
        print("operators by device memory they allocated and kept, mesh "
              "step less unsharded step (GiB; the profiler's "
              "profile_memory):")
        for k, b in sorted(mem_d.items(), key=lambda kv: -abs(kv[1]))[:8]:
            print(f"  {b / 2 ** 30:+10.3f}  {k[:90]}")
        nums["train_trace"] = dict(
            wall_ms=tr_mesh["wall_us"] / 1e3,
            device_ms=tr_mesh["busy_us"] / 1e3, peak_gib=tr_mesh["peak_gib"],
            unsharded_wall_ms=tr_plain["wall_us"] / 1e3,
            unsharded_device_ms=tr_plain["busy_us"] / 1e3,
            unsharded_peak_gib=tr_plain["peak_gib"],
            categories={c: v[0] / 1e3 for c, v in cm.items()},
            unsharded_categories={c: v[0] / 1e3 for c, v in cp.items()})
        del params, opt, plain_fn, tr_mesh, tr_plain
        gc.collect()
        torch.cuda.empty_cache()
        print(f"mesh train {tcfg.name} at full width, world of 1 over NCCL, "
              f"'train' rules, chunked_ce: losses {losses}; first loss "
              f"bitwise phase 8's ({phase8['first_loss']}): "
              f"{losses[0] == phase8['first_loss']}; steps {step_ms} ms "
              f"(phase 8 median {phase8['step_ms']:.3f}); peak {peak:.3f} "
              f"GiB (phase 8 {phase8['peak_gib']:.3f}) [{smi}]")
        print(f"launches (mesh_train run, {MESH_TRAIN_STEPS} steps): "
              f"{launches}")
        assert losses[0] == phase8["first_loss"], (losses, phase8)
        assert all(np.isfinite(losses)), losses
        assert launches["fused_ce"] == MESH_TRAIN_STEPS, launches
        nums["train"] = dict(losses=losses, step_ms=step_ms, peak_gib=peak,
                             launches=launches,
                             phase8={k: phase8[k] for k in (
                                 "first_loss", "step_ms", "peak_gib")})

        # the runner at reduced width: a crash at step 4 restored onto the
        # mesh, against the uninterrupted run on the same mesh
        rcfg = dataclasses.replace(reduced(get_config(TRAIN_ARCH)),
                                   remat_policy="none")
        rrules = make_rules(mesh, "train", rcfg)
        rpsh = placement.param_shardings(rcfg, mesh, rrules)
        rsh = (rpsh, placement.opt_shardings(rpsh, mesh))
        reps = []
        for plan in (FaultPlan(), FaultPlan(crashes={4: "smoke"})):
            with tempfile.TemporaryDirectory() as d, \
                    axis_rules(mesh, rrules):
                rtc = TrainConfig(learning_rate=3e-4, total_steps=8,
                                  warmup_steps=1, checkpoint_every=3,
                                  checkpoint_dir=d)
                reps.append(FaultTolerantRunner(
                    rcfg, rtc, batch=4, seq_len=64, fault_plan=plan,
                    shardings=rsh, device=dev).run(8))
        diff = float(np.abs(np.subtract(reps[0]["losses"],
                                        reps[1]["losses"])).max())
        print(f"mesh runner (reduced {rcfg.name}, 8 steps, crash at 4, "
              f"restored by shardings): recoveries {reps[1]['recoveries']}"
              f", largest loss difference {diff:.3g} (<= 1e-5)")
        assert reps[1]["recoveries"] == [4] and diff <= 1e-5, diff
        nums["runner_max_diff"] = diff

        # compressed_psum over the 'data' axis, NCCL, in local_map
        from torch.distributed.tensor import Replicate
        x = torch.randn(4096, generator=torch.Generator(device=dev)
                        .manual_seed(7), device=dev)
        local_map, kw = import_shard_map()
        dmesh = NamedSharding(mesh, P()).device_mesh
        got = local_map(lambda v: compression.compressed_psum(v, "data",
                                                              mesh),
                        out_placements=[Replicate()],
                        in_placements=([Replicate()],), device_mesh=dmesh,
                        **kw)(x)
        xn = x.cpu().numpy()
        scale = np.float32(np.abs(xn).max()) / np.float32(127.0) + \
            np.float32(1e-12)
        q = np.clip(np.round(xn / scale), -127, 127).astype(np.int32)
        want = q.astype(np.float32) * scale
        ok = np.array_equal(got.cpu().numpy(), want)
        print(f"compressed_psum over NCCL (world of 1, 4,096 values): "
              f"bitwise the numpy oracle: {ok}")
        assert ok, "compressed_psum differs from its oracle"
    finally:
        dist.destroy_process_group()
    nums["phase_s"] = time.time() - t_phase
    print(f"phase 13 (training, runner, compressed_psum): "
          f"{nums['phase_s']:.1f}s [{smi}]")
    return nums


PLAN_CELLS = (("qwen3-4b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"))
PLAN_FLEET_WINDOWS = 8        # lower_fleet's windows at cell A (phase 14)
PLAN_TIMEOUT_S = 900          # the production plans' processes


def start_production_plans(out_dir: str) -> list:
    """Phase 14's production plans (``PLAN_CELLS`` on the 16x16 mesh, a
    fake world of 256, fake tensors on the card) through the dry-run CLI,
    one process a cell, started early so that their host time overlaps
    phases 11-13; :func:`planner_phase` waits for them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in PLAN_CELLS:
        log = open(Path(out_dir) / f"{arch}__{shape}.log", "w")
        procs.append((arch, shape, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out_dir], env=env,
            stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT))))
    return procs


def planner_phase(torch, dev, smi, reset_counts, counters, tcfg, phase8,
                  fcfg, fleet_ws, plan_procs, plan_dir: str) -> dict:
    """Phase 14: the dry-run planners. (a) Phase 8's configuration planned
    on a fake (1, 1) mesh with fake CUDA tensors, held to phase 8's real
    step: the planned flops equal its ``FlopCounterMode`` count exactly,
    the planned peak lies within 0.8-1.25x its ``max_memory_allocated``,
    the roofline bound max(compute, memory) is at most 1.05x its device
    time. (b) The production plans of ``PLAN_CELLS`` on 16x16 (their
    processes' artifacts), and ``lower_fleet`` at cell A (greedy, 8
    windows) on 16x16, rank 0's replica bitwise ``run_fleet``'s replica 0.
    Every number printed beside the card; none is a claim. Returns its
    launches and numbers."""
    import torch.distributed as dist
    from repro_torch.config import ShapeConfig
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.core.events import stack_windows, window_to_torch
    from repro_torch.launch import dryrun, hardware
    from repro_torch.launch.mesh import make_production_mesh

    t_phase = time.time()
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"planner: hardware.HBM_BYTES {hardware.HBM_BYTES} "
          f"({hardware.CARD}); this card's total_memory {total} [{smi}]")
    nums = {"card": smi, "hbm_bytes": hardware.HBM_BYTES,
            "total_memory": total}

    # (a) the world of 1 against phase 8's real step
    shape = ShapeConfig("phase8_train", "train", TRAIN_SEQ, TRAIN_B)
    with dryrun.fake_world(1):
        mesh = dryrun.plan_mesh((1, 1), dev)
        art = dryrun.plan_cell(tcfg, shape, mesh, "1x1", dev)
    assert not dist.is_initialized()
    terms = art["roofline"]
    bound_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    peak_ratio = art["live_bytes_per_dev"] / phase8["step_peak_bytes"]
    w1 = dict(planned_flops=art["hlo_flops_per_dev"],
              full_pass_flops=art["full_program_cost_once"]["flops"],
              measured_flops=phase8["flops"],
              planned_peak_gib=art["live_bytes_per_dev"] / 2 ** 30,
              measured_peak_gib=phase8["step_peak_bytes"] / 2 ** 30,
              peak_ratio=peak_ratio, compute_ms=terms["compute_s"] * 1e3,
              memory_ms=terms["memory_s"] * 1e3, bound_ms=bound_ms,
              device_ms=phase8["step_device_ms"],
              bound_over_device=bound_ms / phase8["step_device_ms"],
              plan_s=art["compile_s"] + art["probe_s"])
    print(f"planner, world of 1 ({tcfg.name}, 4 x 512, chunked_ce, "
          f"{tcfg.attention_impl} attention, {tcfg.remat_policy} remat): "
          f"planned flops {w1['planned_flops']:.6e} (full pass "
          f"{w1['full_pass_flops']:.6e}) == FlopCounterMode's count of "
          f"phase 8's step {w1['measured_flops']:.6e}; planned peak "
          f"{w1['planned_peak_gib']:.3f} GiB against max_memory_allocated "
          f"{w1['measured_peak_gib']:.3f} (ratio {peak_ratio:.4f}, 0.8-1.25);"
          f" roofline bound {bound_ms:.3f} ms (compute "
          f"{w1['compute_ms']:.3f}, memory {w1['memory_ms']:.3f}) against "
          f"the step's device time {w1['device_ms']:.3f} ms (ratio "
          f"{w1['bound_over_device']:.4f}, <= 1.05); planned in "
          f"{w1['plan_s']:.1f}s [{smi}]")
    assert w1["planned_flops"] == w1["full_pass_flops"] == \
        w1["measured_flops"], w1
    assert 0.8 <= peak_ratio <= 1.25, w1
    assert w1["bound_over_device"] <= 1.05, w1
    nums["world_of_one"] = w1

    # (b) the production plans, from their processes
    nums["production"] = {}
    for arch, shape_name, log, proc in plan_procs:
        proc.wait(timeout=PLAN_TIMEOUT_S)
        log.close()
        text = (Path(plan_dir) / f"{arch}__{shape_name}.log").read_text()
        assert proc.returncode == 0, f"plan {arch} {shape_name}:\n{text}"
        a = json.loads((Path(plan_dir) /
                        f"{arch}__{shape_name}.json").read_text())
        t = a["roofline"]
        row = dict(compile_s=a["compile_s"], probe_s=a["probe_s"],
                   live_gib=a["live_bytes_per_dev"] / 2 ** 30,
                   fits=a["fits_hbm"], compute_ms=t["compute_s"] * 1e3,
                   memory_ms=t["memory_s"] * 1e3,
                   collective_ms=t["collective_s"] * 1e3,
                   dominant=a["dominant"],
                   collectives={k: v["count"]
                                for k, v in a["collectives"].items()},
                   roofline_fraction=a["roofline_fraction"])
        nums["production"][f"{arch} {shape_name}"] = row
        print(f"planner, {arch} {shape_name} on 16x16: compile "
              f"{row['compile_s']:.1f}s (the fake pass), probes "
              f"{row['probe_s']:.1f}s, live {row['live_gib']:.2f} GiB/dev, "
              f"fits {row['fits']}, compute {row['compute_ms']:.2f} ms, "
              f"memory {row['memory_ms']:.2f} ms, collective "
              f"{row['collective_ms']:.2f} ms, dominant {row['dominant']}, "
              f"collectives {row['collectives']} [{smi}]")

    # lower_fleet at cell A on 16x16: rank 0's replica against run_fleet's
    w8 = window_to_torch(stack_windows(fleet_ws[:PLAN_FLEET_WINDOWS]), dev)
    reset_counts()
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device=dev)
        plan = fleet_mod.lower_fleet(fcfg, mesh, "greedy",
                                     n_windows=PLAN_FLEET_WINDOWS, windows=w8)
    launches = {n: fn.launches for n, fn in counters.items()}
    assert not dist.is_initialized()
    assert all(launches[k] == v for k, v in plan.kernel_launches.items()), \
        (launches, plan.kernel_launches)
    assert plan.replicas == [0], plan.replicas
    states, stats = fleet_mod.run_fleet(w8, fcfg, "greedy", n_replicas=1)
    for f in states._fields:
        assert torch.equal(getattr(plan.states, f), getattr(states, f)), f
    for k in stats:
        assert torch.equal(plan.stats[k], stats[k]), k
    cost, mem = plan.cost_analysis(), plan.memory_analysis()
    t = dryrun.roofline_terms(plan.cost, 256)
    live = mem.peak_bytes
    fl = dict(seconds=plan.seconds, live_gib=live / 2 ** 30,
              fits=live <= hardware.HBM_BYTES, flops=cost["flops"],
              bytes=cost["bytes accessed"],
              compute_ms=t["compute_s"] * 1e3, memory_ms=t["memory_s"] * 1e3,
              collective_ms=t["collective_s"] * 1e3,
              dominant=max(("compute_s", "memory_s", "collective_s"),
                           key=lambda k: t[k]),
              kernel_launches=plan.kernel_launches)
    nums["lower_fleet"] = fl
    print(f"planner, lower_fleet at cell A on 16x16 (greedy, "
          f"{PLAN_FLEET_WINDOWS} windows, 16 replicas, rank 0's: 1): ran in "
          f"{fl['seconds']:.2f}s, live {fl['live_gib']:.3f} GiB/dev, fits "
          f"{fl['fits']}, torch ops' flops {fl['flops']:.4g} and bytes "
          f"{fl['bytes']:.4g} (compute {fl['compute_ms']:.3f} ms, memory "
          f"{fl['memory_ms']:.3f} ms, collective {fl['collective_ms']:.3f} "
          f"ms, dominant {fl['dominant']}); kernels by launches "
          f"{fl['kernel_launches']}; replica 0 bitwise run_fleet's [{smi}]")
    nums["phase_s"] = time.time() - t_phase
    print(f"phase 14: {nums['phase_s']:.1f}s [{smi}]")
    return {"launches": launches, "numbers": nums}


def full_cell_windows(cfg, n_tasks: int, seed: int):
    """The full cell's four windows (the shape of
    ``tests/test_torch_full_cell.py``'s): 12,500 node ADDs streamed over
    two windows (E = 8,192), a task wave, then 2,000 node removals that
    strand placed tasks. Capacities are multiples of 1/128 and requests of
    1/1024 in the test's ranges, so every sum is exact in any order."""
    from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                         stack_windows)
    r = np.random.default_rng(seed)
    N, E = cfg.max_nodes, cfg.max_events_per_window

    def node(i):
        return HostEvent(0, EventKind.ADD_NODE, i,
                         a=(float(r.integers(51, 129)) / 128,
                            float(r.integers(51, 129)) / 128, 1.0))

    def req():
        return float(r.integers(2, 21)) / 1024

    wins = [[node(i) for i in range(E)], [node(i) for i in range(E, N)],
            [HostEvent(2, EventKind.ADD_TASK, t, a=(req(), req(), 0.0),
                       prio=int(r.integers(0, 12))) for t in range(n_tasks)],
            [HostEvent(3, EventKind.REMOVE_NODE, i) for i in range(2_000)]]
    return stack_windows([pack_window(cfg, e, i)
                          for i, e in enumerate(wins)])


def sharded_and_full_cell_phase(torch, dev, smi, reset_counts, counters,
                                fcfg, fleet_ws, specs, phase5, sched_batch):
    """Phase 12: phase 5's fleet through ``ScenarioFleet(mesh=fleet_mesh(1))``
    (a world of 1 over NCCL), held bitwise to phase 5's unsharded fleet, a
    sharded snapshot restored into an unsharded fleet; then the full cell at
    the path's ``sched_batch`` against the plain versions on the card.
    Returns (sharded launches, full-cell launches, numbers)."""
    import torch.distributed as dist
    from repro_torch.configs import agocs_full_cell
    from repro_torch.core import engine
    from repro_torch.core.events import EventKind, window_to_torch
    from repro_torch.core.state import (drop, init_state, lift,
                                        state_to_numpy, validate_invariants)
    from repro_torch.kernels.placement_commit import ops as pc_ops
    from repro_torch.scenarios import ScenarioFleet, fleet_mesh
    from repro_torch.sched import get_scheduler

    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    nums = {"card": smi}
    mesh = fleet_mesh(1)
    try:
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        reset_counts()
        fleet = ScenarioFleet(fcfg, iter(fleet_ws), specs, batch_windows=32,
                              mesh=mesh, device=dev)
        t0 = time.time()
        fleet.run()
        wall = time.time() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        both = pc_ops.placement_commit_cuda.launches_both
        frame, state = fleet.stats_frame(), state_to_numpy(fleet.state)
        for k, v in phase5["frame"].items():
            assert np.array_equal(frame[k], v), f"sharded stats {k}"
            assert frame[k].dtype == v.dtype, k
        for f, v in phase5["state"].items():
            assert np.array_equal(state[f], v), f"sharded state {f}"
        assert fleet.report() == phase5["report"], "sharded report"
        n_w = fleet.windows_done
        print(f"sharded fleet (mesh 1 over NCCL, {fleet.n_lanes} lanes): "
              f"every stats column, state field and the report bitwise "
              f"phase 5's switchless fleet; launches {launches}, "
              f"B in mode 'both' {both}")
        assert launches["constraint_match"] == n_w, launches
        assert launches["placement_commit"] == both == n_w, launches
        assert launches["window_stats"] == n_w, launches
        assert launches["sched_commit"] == 0, launches
        assert launches["segment_usage"] == \
            phase5["launches"]["segment_usage"], launches
        with tempfile.TemporaryDirectory() as d:
            path = str(Path(d) / "sharded.npz")
            fleet.save(path)
            back = ScenarioFleet(fcfg, iter(()), specs, device=dev)
            back.restore(path)
            for f, v in state_to_numpy(back.state).items():
                assert np.array_equal(v, phase5["state"][f]), \
                    f"restored {f}"
        print("sharded snapshot restored into an unsharded fleet: bitwise")
        nums.update(sharded_windows_per_s=n_w / wall,
                    sharded_lane_windows_per_s=n_w * fleet.n_lanes / wall,
                    phase5_windows_per_s=n_w / phase5["wall"],
                    phase5_lane_windows_per_s=n_w * fleet.n_lanes
                    / phase5["wall"])
        print(f"sharded fleet: {n_w} windows in {wall:.3f}s -> "
              f"{nums['sharded_windows_per_s']:.2f} windows/s, "
              f"{nums['sharded_lane_windows_per_s']:.2f} lane-windows/s "
              f"(phase 5's unsharded fleet: "
              f"{nums['phase5_windows_per_s']:.2f} windows/s, "
              f"{nums['phase5_lane_windows_per_s']:.2f} lane-windows/s) "
              f"[{smi}]")
        del fleet, back
    finally:
        dist.destroy_process_group()

    # the full cell at the path's sched_batch, kernels against plain
    fc = dataclasses.replace(agocs_full_cell.CONFIG, sched_batch=sched_batch)
    ws = window_to_torch(full_cell_windows(fc, 2 * sched_batch, 0), dev)
    adds = (ws.kind == EventKind.ADD_NODE).sum(-1).tolist()
    assert adds[:2] == [fc.max_events_per_window,
                        fc.max_nodes - fc.max_events_per_window], adds
    runs = {}
    for label in ("kernels", "plain"):
        reset_counts()
        t0 = time.time()
        if label == "plain":
            with plain_on_card(torch):
                st, rows = engine.run_windows(init_state(fc, dev), ws, fc,
                                              get_scheduler("greedy"), 0)
                st = drop(engine.recompute_accounting(lift(st), fc))
        else:
            st, rows = engine.run_windows(init_state(fc, dev), ws, fc,
                                          get_scheduler("greedy"), 0)
            st = drop(engine.recompute_accounting(lift(st), fc))
        torch.cuda.synchronize()
        runs[label] = (st, rows, time.time() - t0,
                       {name: fn.launches for name, fn in counters.items()})
    (sk, rk, tk, lk), (sp, rp, tp, lp) = runs["kernels"], runs["plain"]
    assert not any(lp.values()), f"the plain run launched a kernel: {lp}"
    for f in sk._fields:
        assert torch.equal(getattr(sk, f), getattr(sp, f)), f"full cell {f}"
    for k in rp:
        a, b = rk[k].cpu().numpy(), rp[k].cpu().numpy()
        if k in ("util_balance_var", "reserved_balance_var"):
            assert np.allclose(a, b, rtol=ULP_RTOL, atol=0), (k, a, b)
        else:
            assert np.array_equal(a, b), f"full cell stats {k}"
    problems = validate_invariants(sk, fc)
    assert not problems, problems
    n_active = int(sk.node_active.sum())
    assert n_active == fc.max_nodes - 2_000, n_active
    assert int(rk["evictions"][-1]) > 0 and int(rk["placements"][-1]) > 0
    for name in ("constraint_match", "placement_commit", "window_stats",
                 "segment_usage"):
        assert lk[name] > 0, lk
    print(f"full cell (N={fc.max_nodes}, T={fc.max_tasks}, E="
          f"{fc.max_events_per_window}, sched_batch {fc.sched_batch}): node "
          f"ADDs streamed {adds[:2]}, {int(rk['placements'][-1])} placed, "
          f"{int(rk['evictions'][-1])} evicted by the 2,000-node removal, "
          f"{n_active} nodes active, invariants OK; state bitwise and stats "
          f"bitwise (variances within rtol {ULP_RTOL}) against the plain "
          f"versions on the card; kernels {tk:.2f}s, plain {tp:.2f}s; "
          f"launches {lk}")
    nums.update(full_cell_kernels_s=tk, full_cell_plain_s=tp,
                phase_s=time.time() - t_phase)
    print(f"phase 12: {nums['phase_s']:.1f}s [{smi}]")
    return launches, lk, nums


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
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.fused_ce import ops as ce_ops
    from repro_torch.kernels.fused_ce.ref import fused_ce_ref
    from repro_torch.kernels.placement_commit import ops as pc_ops
    from repro_torch.kernels.placement_commit.ref import placement_commit_ref
    from repro_torch.kernels.segment_usage import ops as su_ops
    from repro_torch.kernels.segment_usage.ref import (
        segment_usage_lanes_ref, segment_usage_ref)
    from repro_torch.kernels.window_stats import ops as ws_ops
    from repro_torch.kernels.window_stats.ref import window_reductions_ref
    from repro_torch.kernels.placement_commit.ref import (
        sched_commit_fleet_ref)
    from repro_torch import resilience
    from repro_torch.core import engine, monitor, prng
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.core.precompile import precompile_trace
    from repro_torch.core.engine import run_windows
    from repro_torch.core.state import init_state
    from repro_torch.service import WhatIfQuery, WhatIfServer
    from repro_torch.core.events import stack_windows, window_to_torch
    from repro_torch.core.precompile import precompile_stream, verify_stack
    from repro_torch.core.snapshot import save_snapshot
    from repro_torch.core.state import SimState, lane, state_to_numpy
    from repro_torch.scenarios import fleet_mesh
    from repro_torch.sched import PROPOSERS, base_pass, get_scheduler
    from repro_torch.launch import whatif
    from repro_torch.launch.simulate import summary_row
    from repro_torch.parsers import GCDParser, default_start_us
    from repro_torch.scenarios import ScenarioFleet, ScenarioSpec
    from repro_torch.sched import TableForm, register_scheduler
    from repro_torch.configs import get_config
    from repro_torch.models import model as lm
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.config import TrainConfig
    from repro_torch.configs import reduced
    from repro_torch.distributed.fault import FaultPlan, FaultTolerantRunner
    from repro_torch.train import optim
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.step import make_train_step

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
    benches = start_bench_builds(_build)
    _build.library()
    print(f"build: {time.time() - t0:.1f}s -> {_build.BUILD_INFO['path']}")
    for line in str(_build.BUILD_INFO["ptxas"]).splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line:
            print("  " + line.strip())
    for name, (exe, proc) in benches.items():
        text, _ = proc.communicate()
        assert proc.returncode == 0, f"nvcc failed for {name}:\n{text}"
    print(f"bench programs built in {time.time() - t0:.1f}s: "
          f"{', '.join(benches)}")

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
                "sched_commit": pc_ops.sched_commit_cuda,
                "segment_usage": su_ops.segment_usage_cuda,
                "flash_attention": fa_ops.flash_attention_cuda,
                "fused_ce": ce_ops.fused_ce_cuda}
    results = {name: {} for name in counters}
    stoch_split = {}       # phase 6: windows/s and a window's device split

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        ce_ops.fused_ce_cuda.launches_tc = 0    # G's tensor-core body
        fa_ops.flash_attention_cuda.launches_tc = 0  # F's
        pc_ops.placement_commit_cuda.launches_both = 0   # B's per-lane mode

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
    print(f"C window_stats T={T} N={N}: counts/histogram exact, sums "
          f"bitwise, variances within rtol {ULP_RTOL}")
    # C at the fleet's B=8 in one launch, on its own random stream (the
    # later phases' inputs stay those of earlier versions of this script);
    # each lane against the plain version, and two calls bitwise equal
    def c_lane_inputs():
        """C's B=8 inputs (made again for phase 9, so that they do not
        count in the serving and training phases' peak memory)."""
        crng = np.random.default_rng(args.seed + 17)
        return (cuda(crng.integers(0, 3, (FLEET_B, T)).astype(np.int8)),
                cuda(grid(crng, 0, 16, (FLEET_B, T, U))),
                cuda(crng.integers(-1, 13, (FLEET_B, T)).astype(np.int32)),
                cuda(crng.random((FLEET_B, N)) < 0.95),
                cuda(grid(crng, 64, 256, (FLEET_B, N, R))),
                cuda(grid(crng, 0, 64, (FLEET_B, N, R))),
                cuda(grid(crng, 0, 64, (FLEET_B, N, R))))

    c_lanes = c_lane_inputs()
    n0 = ws_ops.window_stats_cuda.launches
    red_k = ws_ops.window_reductions(*c_lanes)
    red_again = ws_ops.window_reductions(*c_lanes)
    assert ws_ops.window_stats_cuda.launches == n0 + 2
    for f in red_k._fields:
        assert torch.equal(getattr(red_k, f), getattr(red_again, f)), \
            f"C B={FLEET_B} {f}: two calls differ"
    for b in range(FLEET_B):
        red_r = window_reductions_ref(*[x[b] for x in c_lanes])
        for f in red_k._fields:
            a = getattr(red_k, f)[b].cpu().numpy()
            w = getattr(red_r, f).cpu().numpy()
            if f in ("util_var", "res_var"):
                assert np.allclose(a, w, rtol=ULP_RTOL, atol=0), \
                    f"C B={FLEET_B} lane {b} {f}: {a!r} vs {w!r}"
            else:
                assert np.array_equal(a, w), \
                    f"C B={FLEET_B} lane {b} {f}: {a!r} vs {w!r}"
            c_err = max(c_err, float(np.abs(a.astype(np.float64)
                                            - w.astype(np.float64)).max()))
    results["window_stats"]["max_abs_err"] = c_err
    print(f"C window_stats B={FLEET_B} T={T} N={N} (one launch): each lane "
          f"counts/histogram exact, sums bitwise, variances within rtol "
          f"{ULP_RTOL}; two calls bitwise equal")
    del c_lanes, red_k, red_again, red_r

    # E: segment_usage in its lane form, at the main path's B=1 and the
    # fleet's B=8 (one launch for all lanes), uniform and Zipf-skewed
    # nodes: grid data bitwise against the plain version, off-grid data
    # bitwise against the host's f32 sum in task order (np.add.at)
    task_node = cuda(rng.integers(-1, N, T).astype(np.int32))
    mask = cuda(rng.random(T) < 0.7)
    values = cuda(grid(rng, 0, 48, (T, R)))
    e_args = (task_node, values, mask, N)
    e_lanes = (cuda(rng.integers(-1, N, (FLEET_B, T)).astype(np.int32)),
               cuda(grid(rng, 0, 48, (FLEET_B, T, R))),
               cuda(rng.random((FLEET_B, T)) < 0.7), N)
    zipf = np.minimum(rng.zipf(1.3, (FLEET_B, T)) - 1, N - 1)
    e_err = 0.0
    for label, (node_e, mask_e) in (
            ("uniform", (e_lanes[0], e_lanes[2])),
            ("zipf", (cuda(zipf.astype(np.int32)), e_lanes[2]))):
        for B_e in (1, FLEET_B):
            nd, mk = node_e[:B_e], mask_e[:B_e]
            n0 = su_ops.segment_usage_cuda.launches
            out_k = su_ops.segment_usage_lanes(nd, e_lanes[1][:B_e], mk, N)
            assert su_ops.segment_usage_cuda.launches == n0 + 1
            out_r = segment_usage_lanes_ref(nd, e_lanes[1][:B_e], mk, N)
            torch.cuda.synchronize()
            assert torch.equal(out_k, out_r), f"E {label} B={B_e}: grid"
            off = rng.random((B_e, T, R), dtype=np.float32)
            got = su_ops.segment_usage_lanes(nd, cuda(off), mk, N).cpu()
            nd_h, mk_h = nd.cpu().numpy(), mk.cpu().numpy()
            for b in range(B_e):
                keep = mk_h[b] & (nd_h[b] >= 0)
                want = np.zeros((N, R), np.float32)
                np.add.at(want, nd_h[b][keep], off[b][keep])
                assert np.array_equal(got[b].numpy(), want), \
                    f"E {label} B={B_e} lane {b}: off-grid not bitwise"
                e_err = max(e_err, float(np.abs(got[b].numpy() - want).max()))
            print(f"E segment_usage {label} B={B_e} T={T} -> N={N} V={R} "
                  f"(one launch): bitwise against the plain version on "
                  f"grid data and against the host's task-order f32 sum "
                  f"off the grid")
    results["segment_usage"]["max_abs_err"] = e_err

    # fleet shapes, B=8 lanes: A with its lane axis, B with a per-lane
    # flag, D with lanes of all three families in each mode
    Bf = FLEET_B
    f_cons = np.stack([rng.integers(0, K, (Bf, P, C)),
                       np.where(rng.random((Bf, P, C)) < 0.8, 0,
                                rng.integers(1, 5, (Bf, P, C))),
                       rng.integers(0, 4, (Bf, P, C))],
                      axis=-1).astype(np.int32)
    f_total = cuda(grid(rng, 64, 256, (Bf, N, R)))
    f_active = cuda(rng.random((Bf, N)) < 0.95)
    fa_args = (cuda(grid(rng, 1, 48, (Bf, P, R))), cuda(f_cons), f_total,
               cuda(grid(rng, 0, 64, (Bf, N, R))),
               cuda(rng.integers(0, 4, (Bf, N, K)).astype(np.int32)),
               f_active)
    fsc_k = cm_ops.constraint_match(*fa_args)
    fsc_r = torch.stack([constraint_match_ref(*[x[b] for x in fa_args])
                         for b in range(Bf)])
    torch.cuda.synchronize()
    f_ok = torch.isfinite(fsc_r)
    assert torch.equal(torch.isfinite(fsc_k), f_ok), "A lanes: feasibility"
    assert torch.equal(fsc_k[f_ok], fsc_r[f_ok]), "A lanes: not bitwise"
    print(f"A constraint_match B={Bf} P={P} N={N} (one launch): bitwise")

    f_req, f_res = fa_args[0], fa_args[3]
    f_valid = cuda(rng.random((Bf, P)) < 0.9)
    f_total_fold = torch.where(f_active[..., None], f_total, -1.0)
    f_denom = torch.clamp_min(f_total, 1e-6)
    flags = cuda(np.arange(Bf) % 3 == 0)
    fb_args = (fsc_r, f_req, f_ok, f_valid, f_total_fold, f_denom, f_res)
    no_k, ta_k = pc_ops.placement_commit(*fb_args, flags, return_tally=True)
    plain = [placement_commit_ref(*[x[b] for x in fb_args], bool(flags[b]))
             for b in range(Bf)]
    torch.cuda.synchronize()
    assert torch.equal(no_k, torch.stack([p[0] for p in plain])), \
        "B both: node_of differs"
    assert torch.equal(ta_k, torch.stack([p[1] for p in plain])), \
        "B both: tally not bitwise"
    b_err = max(b_err, float((ta_k - torch.stack([p[1] for p in plain]))
                             .abs().max()))
    results["placement_commit"]["max_abs_err"] = b_err
    print(f"B placement_commit both B={Bf} P={P} N={N}: node_of exact, "
          f"tally bitwise, {int((no_k >= 0).sum())} placed")

    # the fleet's lane layout: greedy x5 (scores), first_fit, round_robin
    # x2 (node order), the plugin (external)
    S_, NO_, EX_ = pc_ops.FAM_SCORES, pc_ops.FAM_NODE_ORDER, \
        pc_ops.FAM_EXTERNAL
    fleet_fam = (S_, NO_, NO_, S_, S_, S_, NO_, EX_)
    fleet_dyn = (True, False, False, True, True, True, False, False)
    d_ext = cuda(grid(rng, -64, 64, (2, P, N)))
    d_ext_row = (0,) * (Bf - 1) + (1,)
    d_start = cuda(rng.integers(0, N, Bf).astype(np.int32))
    d_err = 0.0
    for mode, dyn, shared in (("static", (False,) * Bf, False),
                              ("dynamic", (True,) * Bf, False),
                              ("both", fleet_dyn, True)):
        ops = [fsc_r, f_ok, f_req, f_valid, f_total_fold, f_denom, f_res]
        if shared:        # the lanes share one request matrix
            ops[2] = ops[2][:1].contiguous()
        got = pc_ops.sched_commit_fleet(*ops, d_start, fam=fleet_fam,
                                        dynamic=dyn, ext=d_ext,
                                        ext_row=d_ext_row)
        want = sched_commit_fleet_ref(*ops, d_start, fleet_fam, dyn, d_ext,
                                      d_ext_row)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), f"D {mode}: node_of differs"
        assert torch.equal(got[1], want[1]), f"D {mode}: tally not bitwise"
        d_err = max(d_err, float((got[1] - want[1]).abs().max()))
        print(f"D sched_commit {mode} B={Bf} P={P} N={N} families "
              f"{fleet_fam}{' (req shared by the lanes)' if shared else ''}"
              f": node_of exact, tally bitwise, "
              f"{int((got[0] >= 0).sum())} placed")
    results["sched_commit"]["max_abs_err"] = d_err

    # B and D past the old ceiling of one block's shared memory (N*R <=
    # 58,112 floats): 20,000 and 150,000 nodes, P=64, R=3, every mode and
    # family, on their own random stream (the later phases' inputs stay
    # those of earlier versions of this script)
    big = np.random.default_rng(args.seed + 16)

    def commit_ops(lanes, n_nodes):
        total = cuda(grid(big, 16, 256, (lanes, n_nodes, R)))
        active = cuda(big.random((lanes, n_nodes)) < 0.8)
        return [cuda(grid(big, -256, 0, (lanes, BIG_P, n_nodes))),
                cuda(grid(big, 1, 64, (lanes, BIG_P, R))),
                cuda(big.random((lanes, BIG_P, n_nodes)) < 0.7),
                cuda(big.random((lanes, BIG_P)) < 0.85),
                torch.where(active[..., None], total, -1.0),
                torch.clamp_min(total, 1e-6),
                cuda(grid(big, 0, 96, (lanes, n_nodes, R)))]

    big_fam = (S_, NO_, EX_, NO_)
    for n_big in BIG_N:
        ops = commit_ops(2, n_big)
        flags = cuda(np.array([True, False]))
        for mode in ("static", "dynamic", "both"):
            no_k, ta_k = pc_ops.placement_commit_cuda(*ops, mode, flags)
            for b in range(2):
                dyn = bool(flags[b]) if mode == "both" else mode == "dynamic"
                no_r, ta_r = placement_commit_ref(*[x[b] for x in ops], dyn)
                torch.cuda.synchronize()
                assert torch.equal(no_k[b], no_r), f"B N={n_big} {mode}"
                assert torch.equal(ta_k[b], ta_r), f"B N={n_big} {mode}"
        print(f"B placement_commit N={n_big} P={BIG_P} B=2 static, dynamic, "
              f"both: node_of exact, tally bitwise (cluster of "
              f"{pc_ops.cluster_size('placement_commit', 2)} blocks)")
        pref4, req4, ok4, valid4, tot4, den4, res4 = commit_ops(4, n_big)
        ops = [torch.where(ok4, pref4, float("-inf")), ok4, req4, valid4,
               tot4, den4, res4]
        ext4 = cuda(grid(big, -64, 64, (2, BIG_P, n_big)))
        start4 = cuda(np.array([0, n_big // 3, 0, n_big - 1], np.int32))
        for mode, dyn in (("static", (False,) * 4), ("dynamic", (True,) * 4),
                          ("both", (True, False, False, True))):
            got = pc_ops.sched_commit_fleet(
                *ops, start4, fam=big_fam, dynamic=dyn, ext=ext4,
                ext_row=(0, 0, 1, 0))
            want = sched_commit_fleet_ref(*ops, start4, big_fam, dyn, ext4,
                                          (0, 0, 1, 0))
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), f"D N={n_big} {mode}"
            assert torch.equal(got[1], want[1]), f"D N={n_big} {mode}"
        print(f"D sched_commit N={n_big} P={BIG_P} B=4 families {big_fam} "
              f"static, dynamic, both: node_of exact, tally bitwise "
              f"(cluster of {pc_ops.cluster_size('sched_commit', 4)} "
              f"blocks)")
        del ops, pref4, req4, ok4, valid4, tot4, den4, res4, ext4

    # E past its old ceilings (16,384 nodes, V <= 8): three 7-bit digit
    # passes and two column groups, cell A's task table, bitwise
    for label in ("uniform", "zipf"):
        nd = (big.integers(-1, E_BIG_N, (2, T)) if label == "uniform" else
              np.minimum(big.zipf(1.3, (2, T)) - 1, E_BIG_N - 1))
        eb = (cuda(nd.astype(np.int32)), cuda(grid(big, 0, 48,
                                                    (2, T, E_BIG_V))),
              cuda(big.random((2, T)) < 0.7), E_BIG_N)
        got = su_ops.segment_usage_lanes(*eb)
        want = segment_usage_lanes_ref(*eb)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"E {label} N={E_BIG_N} V={E_BIG_V}"
        print(f"E segment_usage {label} B=2 T={T} -> N={E_BIG_N} V={E_BIG_V} "
              f"({su_ops.digit_passes(E_BIG_N)} digit passes, one launch): "
              f"bitwise against the plain version")
    del eb, got, want

    # F: flash_attention at the serving path's shape (qwen3-4b prefill:
    # B=4, S=512, H=32, D=128, bf16, causal), then in f32 at a ragged S
    scfg = get_config(SERVE_ARCH)
    f_shape = (SERVE_B, SERVE_PROMPT, scfg.n_heads, scfg.resolved_head_dim)
    fg = torch.Generator(device=dev).manual_seed(args.seed)
    fq, fk, fv = (torch.randn(f_shape, generator=fg, device=dev,
                              dtype=torch.bfloat16) for _ in range(3))
    f_scale = 1.0 / scfg.resolved_head_dim ** 0.5
    assert fa_ops.uses_tensor_cores(fq.dtype, f_shape[3])
    n_tc = fa_ops.flash_attention_cuda.launches_tc
    f_out = fa_ops.flash_attention(fq, fk, fv, causal=True, scale=f_scale)
    assert fa_ops.flash_attention_cuda.launches_tc == n_tc + 1, \
        "F bf16: not the tensor-core body"
    f_want = attention_ref(fq, fk, fv, causal=True, scale=f_scale)
    torch.cuda.synchronize()
    assert f_out.dtype == torch.bfloat16 and f_out.shape == f_shape
    f_err = float((f_out.float() - f_want.float()).abs().max())
    assert f_err <= 2e-2, f"F bf16 causal: max abs err {f_err} > 2e-2"
    results["flash_attention"]["max_abs_err"] = f_err
    print(f"F flash_attention B={f_shape[0]} S={f_shape[1]} H={f_shape[2]} "
          f"D={f_shape[3]} bf16 causal (body: {fa_ops.TC_BODY}): max abs "
          f"err {f_err:.3g} (<= 2e-2)")
    for causal in (False, True):
        xs = [torch.randn((2, 200, 8, 128), generator=fg, device=dev)
              for _ in range(3)]
        n_tc = fa_ops.flash_attention_cuda.launches_tc
        got = fa_ops.flash_attention(*xs, causal=causal)
        assert fa_ops.flash_attention_cuda.launches_tc == n_tc, \
            "F f32: not the SIMT body"
        want = attention_ref(*xs, causal=causal)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert err <= 1e-5, f"F f32 causal={causal}: max abs err {err}"
        print(f"F flash_attention B=2 S=200 H=8 D=128 f32 "
              f"{'causal' if causal else 'full'} (body: {fa_ops.SIMT_BODY}):"
              f" max abs err {err:.3g} (<= 1e-5)")
    del f_out, f_want, xs, got, want

    # G: fused_ce at the training path's shape (qwen3-4b, 4 x 512 tokens,
    # bf16), then in f32 at a ragged T with V < Vp
    tcfg = dataclasses.replace(get_config(TRAIN_ARCH), chunked_ce=True,
                               attention_impl="xla")
    ce_T, ce_d = TRAIN_B * TRAIN_SEQ, tcfg.d_model
    ce_Vp, ce_V = tcfg.padded_vocab, tcfg.vocab_size

    def ce_inputs():
        """x, w (the head's scale), labels with one in seven ignored."""
        g = torch.Generator(device=dev).manual_seed(args.seed + 2)
        x = torch.randn((ce_T, ce_d), generator=g, device=dev).bfloat16()
        w = (torch.randn((ce_Vp, ce_d), generator=g, device=dev)
             * 0.02).bfloat16()
        lab = torch.randint(0, ce_V, (ce_T,), generator=g, device=dev,
                            dtype=torch.int32)
        lab[::7] = -1
        return x, w, lab

    cx, cw, clab = ce_inputs()
    n_tc = ce_ops.fused_ce_cuda.launches_tc
    nll_k, lse_k = ce_ops.fused_ce_with_lse(cx, cw, clab, ce_V)
    assert ce_ops.fused_ce_cuda.launches_tc == n_tc + 1, "G: not the TC body"
    nll_r, lse_r = fused_ce_ref(cx, cw, clab, ce_V)
    torch.cuda.synchronize()
    g_err = max(float((nll_k - nll_r).abs().max()),
                float((lse_k - lse_r).abs().max()))
    assert nll_k.shape == (ce_T,) and bool(torch.isfinite(nll_k).all())
    assert g_err <= 2e-3, f"G bf16: max abs err {g_err} > 2e-3"
    assert not bool(nll_k[clab < 0].any()), "G: ignored labels not 0"
    results["fused_ce"]["max_abs_err"] = g_err
    print(f"G fused_ce T={ce_T} d={ce_d} Vp={ce_Vp} V={ce_V} bf16 "
          f"(body: {G_TC_BODY}): nll and lse max abs err {g_err:.3g} "
          f"(<= 2e-3), ignored labels exactly 0")
    gx = torch.randn((200, 256), generator=fg, device=dev)
    gw = torch.randn((4096, 256), generator=fg, device=dev)
    glab = torch.randint(-1, 4000, (200,), generator=fg, device=dev,
                         dtype=torch.int32)
    n_tc = ce_ops.fused_ce_cuda.launches_tc
    got = ce_ops.fused_ce_with_lse(gx, gw, glab, 4000)
    assert ce_ops.fused_ce_cuda.launches_tc == n_tc, "G f32: not SIMT"
    want = fused_ce_ref(gx, gw, glab, 4000)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    assert err <= 1e-4, f"G f32 ragged: max abs err {err} > 1e-4"
    print(f"G fused_ce T=200 d=256 Vp=4096 V=4000 f32 (body: SIMT): nll "
          f"and lse max abs err {err:.3g} (<= 1e-4)")
    del cx, cw, clab, nll_k, lse_k, nll_r, lse_r, gx, gw, glab, got, want

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
    # the fleet's windows: the same trace, packed with the injection rows
    # the whatif CLI reserves for an --arrival rate above 1 at cell A
    fcfg = whatif.build_cfg(argparse.Namespace(
        cell_a=True, nodes=None, tasks=None, use_kernels=False,
        stats_stride=1, dispatch=None, inject_slots=None,
        arrival="1.0,1.5"))
    assert fcfg.inject_slots == 1024, fcfg.inject_slots
    fcfg = dataclasses.replace(fcfg, resync_windows=FLEET_WINDOWS)
    t0 = time.time()
    fparser = GCDParser(fcfg, tmp.name)
    fleet_ws = list(fparser.packed_windows(
        FLEET_WINDOWS, start_us=default_start_us("gcd", fcfg)))
    t_fparse = time.time() - t0
    # phase 10's stack: the same trace and packing, args.windows windows
    serve_tmp = tempfile.TemporaryDirectory()
    serve_stack = str(Path(serve_tmp.name) / "stack.npz")
    t0 = time.time()
    n_stack = precompile_trace(fcfg, tmp.name, serve_stack, args.windows,
                               start_us=default_start_us("gcd", fcfg),
                               shard_windows=SERVICE_BW)
    t_stack = time.time() - t0
    tmp.cleanup()
    assert fparser.stats.slot_overflow == 0, "slot_overflow in the parse"
    n_events = int(sum(int(w.n_valid) for w in windows))
    print(f"trace: {summary} generated in {t_gen:.1f}s")
    print(f"parse: {len(windows)} windows, {n_events} events in "
          f"{t_parse:.1f}s; parser: {parser.stats}")
    assert parser.stats.slot_overflow == 0, "slot_overflow in the parse"

    reset_counts()
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
    assert all(launches[k] > 0 for k in MAIN_PATH), launches
    assert launches["segment_usage"] >= 2, launches
    monitor_text = monitor.render(state, cfg, sim.windows_done)  # phase 10
    del state, sim

    reset_counts()
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

    prof_ws = windows[:PROFILE_WINDOWS]
    profile_run(torch, lambda: Simulation(
        cfg, iter(prof_ws), scheduler="greedy", batch_windows=len(prof_ws),
        device=dev), "main path greedy", len(prof_ws))

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

    # ---- 5. the scenario fleet at cell A -------------------------------
    register_scheduler(PLUGIN, _propose_pack_left,
                       table_form=TableForm(_tf_pack_left))
    specs = [ScenarioSpec(name="greedy"),
             ScenarioSpec(name="first_fit", scheduler="first_fit"),
             ScenarioSpec(name="round_robin", scheduler="round_robin"),
             ScenarioSpec(name="greedy/outage=0.2", node_outage_frac=0.2),
             ScenarioSpec(name="greedy/cap=0.8", capacity_scale=0.8),
             ScenarioSpec(name="greedy/storm=0.05", evict_storm_frac=0.05),
             ScenarioSpec(name="round_robin/rate=1.5",
                          scheduler="round_robin", arrival_rate=1.5),
             ScenarioSpec(name=PLUGIN, scheduler=PLUGIN)]
    assert len(specs) == FLEET_B
    reset_counts()
    fleet = ScenarioFleet(fcfg, iter(fleet_ws), specs, batch_windows=32,
                          device=dev)
    t0 = time.time()
    fstate = fleet.run()
    fwall = time.time() - t0
    launches_fleet = {name: fn.launches for name, fn in counters.items()}
    fsf = fleet.stats_frame()
    assert fleet.windows_done == FLEET_WINDOWS and fleet.resyncs_done == 1
    for k, v in fsf.items():
        assert v.shape[:2] == (FLEET_WINDOWS, FLEET_B), (k, v.shape)
        assert np.all(np.isfinite(v)), k
    print(f"fleet: {FLEET_B} lanes x {FLEET_WINDOWS} windows in "
          f"{fwall:.3f}s -> {FLEET_WINDOWS / fwall:.2f} windows/s, "
          f"{FLEET_B * FLEET_WINDOWS / fwall:.2f} lane-windows/s (parse "
          f"{t_fparse:.1f}s apart, inject_slots {fcfg.inject_slots}), "
          f"{fleet.resyncs_done} resync(s)")
    report = fleet.report()
    for b, row in enumerate(report["scenarios"]):
        problems = validate_invariants(lane(fstate, b), fcfg)
        assert not problems, (row["scenario"], problems)
        print(f"  lane {b} {row['scenario']:<22} placed {row['placements']:>6}"
              f" evicted {row['evictions']:>5} injected {row['injected']:>5}"
              f" pending {row['pending_final']:>6} invariants: OK")
    print(f"launches (fleet run): {launches_fleet}")
    assert all(launches_fleet[k] > 0 for k in FLEET_PATH), launches_fleet
    assert launches_fleet["sched_commit"] == FLEET_WINDOWS, launches_fleet
    assert report["scenarios"][6]["injected"] > 0
    assert report["scenarios"][5]["evictions"] > \
        report["scenarios"][0]["evictions"]

    lane0 = Simulation(fcfg, iter(fleet_ws), scheduler="greedy",
                       batch_windows=32, device=dev)
    state0 = lane0.run()
    sf0 = lane0.stats_frame()
    for f in state0._fields:
        assert torch.equal(getattr(fstate, f)[0], getattr(state0, f)), \
            f"lane 0 {f} differs from Simulation"
    for k, v in sf0.items():
        assert np.array_equal(fsf[k][:, 0], v), f"lane 0 stats {k}"
    print(f"fleet lane 0 == Simulation over the same {FLEET_WINDOWS} "
          "windows: state and stats bitwise")
    # what phase 12's sharded fleet is held to, kept on the host
    phase5 = {"frame": fsf, "state": state_to_numpy(fstate),
              "report": report, "launches": launches_fleet, "wall": fwall}
    del fleet, fstate, lane0, state0
    prof_fws = fleet_ws[:PROFILE_WINDOWS]
    profile_run(torch, lambda: ScenarioFleet(
        fcfg, iter(prof_fws), specs, batch_windows=len(prof_fws),
        device=dev), f"fleet B={FLEET_B}", len(prof_fws))

    # a small fleet on the card against the plain CPU path, both dispatches
    small_f = dataclasses.replace(small, inject_slots=128)
    with tempfile.TemporaryDirectory() as d:
        tracegen.generate_trace(d, n_machines=48, n_jobs=120,
                                horizon_windows=40, seed=args.seed + 1)
        small_fws = list(GCDParser(small_f, d).packed_windows(
            40, start_us=default_start_us("gcd", small_f)))
    small_specs = [specs[0], specs[1], specs[5], specs[6], specs[7],
                   ScenarioSpec(name="greedy/outage=0.2",
                                node_outage_frac=0.2)]
    for dispatch in ("auto", "switch"):
        c = dataclasses.replace(small_f, sched_dispatch=dispatch)
        runs = {}
        for device in (dev, torch.device("cpu")):
            fl = ScenarioFleet(c, iter(small_fws), small_specs,
                               batch_windows=8, device=device)
            runs[device.type] = (fl.run(), fl.stats_frame())
        (st_g, sf_g), (st_c, sf_c) = runs["cuda"], runs["cpu"]
        for f in st_c._fields:
            if getattr(st_c, f).dtype != torch.float32:
                assert torch.equal(getattr(st_g, f).cpu(),
                                   getattr(st_c, f)), (dispatch, f)
        for k in sf_c:
            if sf_c[k].dtype.kind in "iub":
                assert np.array_equal(sf_g[k], sf_c[k]), (dispatch, k)
            else:
                np.testing.assert_allclose(sf_g[k], sf_c[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
        print(f"small fleet ({len(small_specs)} lanes, 48 nodes, 40 "
              f"windows, dispatch {dispatch}): card == plain CPU path "
              "(state and decisions exact, stats rtol 1e-5)")

    # ---- 6. stochastic schedulers, snapshots and replay at cell A -----
    # (a) the key stream on the card against the CPU, bitwise, at cell A's
    # (P, N) and the GA population's (8, P, N); the two draw times
    kcpu = prng.split(prng.key(args.seed + 5), 4)
    kdev = prng.split(prng.key(args.seed + 5, dev), 4)
    torch.cuda.synchronize()
    assert torch.equal(kdev.cpu(), kcpu), "split on the card differs"
    ga_shape = (GA_POP, P, N)
    for label, draw in (
            ("split x3", lambda k: prng.split(k, 3)),
            (f"uniform ({P}, {N})", lambda k: prng.uniform(k[1], (P, N))),
            (f"randint ({P}, {N}) in [0, {N})",
             lambda k: prng.randint(k[2], 0, N, (P, N))),
            (f"uniform {ga_shape}, a key a row",
             lambda k: prng.uniform(prng.split(k[3], GA_POP), (P, N)))):
        got, want = draw(kdev), draw(kcpu)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want), \
            f"key draw {label}: card and CPU bits differ"
        print(f"keys {label}: card == CPU, bitwise")
        del got, want
    draw_ms = {
        "uniform_cell_a": time_ms(torch, lambda: prng.uniform(
            kdev[1], (P, N)), 5),
        "ga_generation_pair": time_ms(torch, lambda: (
            prng.uniform(kdev[1], ga_shape),
            prng.uniform(kdev[2], ga_shape)), 3)}
    print(f"time key draws: one uniform ({P}, {N}) "
          f"{draw_ms['uniform_cell_a']:.4f} ms, one GA generation's pair "
          f"of uniform {ga_shape} {draw_ms['ga_generation_pair']:.4f} ms "
          f"(plain PyTorch int64 threefry, {prng.CHUNK} positions a "
          f"chunk) [{smi}]")

    # (b) E at the searches' surrogate shapes, against its plain version:
    # B=1 (SA, tabu) and B=GA_POP (the GA's population, a lane an
    # individual), the inputs built as the surrogate builds them (one
    # request and weight row expanded over the lanes); one launch a call;
    # library yardstick index_add_
    srng = np.random.default_rng(args.seed + 18)
    s_req1 = cuda(grid(srng, 1, 48, (P, R)))
    s_weight1 = cuda(srng.random(P) < 0.9)
    surrogate = {}
    for B in (1, GA_POP):
        s_choice = cuda(srng.integers(0, N, (B, P)).astype(np.int32))
        s_args = (s_choice, s_req1.expand(B, P, R),
                  s_weight1.expand(B, P), N)
        before = counters["segment_usage"].launches
        got = su_ops.segment_usage_lanes(*s_args)
        assert counters["segment_usage"].launches == before + 1, \
            f"E at the surrogate's shape B={B}: not one launch"
        want = segment_usage_lanes_ref(*s_args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"E at the surrogate's shape B={B}"
        s_idx = (torch.where(s_args[2], s_choice.long(), N)
                 + torch.arange(B, device=dev)[:, None] * (N + 1)
                 ).reshape(-1)
        s_src = s_args[1].reshape(B * P, R)
        s_ms = time_ms(torch, lambda: su_ops.segment_usage_lanes(*s_args),
                       20)
        s_plain = time_ms(torch, lambda: segment_usage_lanes_ref(*s_args),
                          10, warmup=1)
        s_lib = time_ms(torch, lambda: torch.zeros(
            B * (N + 1), R, device=dev).index_add_(0, s_idx, s_src), 20)
        # the expanded rows are read once a lane, as the kernel reads them
        s_bound, s_by = bound_ms(
            nbytes(s_choice) + B * P * (R * 4 + 1) + B * N * R * 4,
            int(s_args[2].sum()) * R)
        surrogate[f"B{B}"] = dict(
            B=B, T=P, V=R, N=N, ms=s_ms, plain_ms=s_plain,
            library_ms=s_lib, bound_ms=s_bound, bound_by=s_by)
        print(f"E segment_usage at the surrogate's shape B={B} T={P} "
              f"V={R} N={N} (rows expanded over lanes): one launch, "
              f"bitwise against the plain version; kernel {s_ms:.4f} ms, "
              f"plain {s_plain:.4f} ms, library {s_lib:.4f} ms "
              f"(index_add_), bound {s_bound:.3g} ms ({s_by}) [{smi}]")
        del got, want, s_idx, s_src
    results["segment_usage"]["surrogate"] = surrogate

    # (c) the main path: Simulation with each stochastic scheduler, 8
    # windows at cell A; counts reset just before each run, read after
    stoch_ws = windows[:STOCH_WINDOWS]
    launches_stoch, stoch_states = {}, {}
    e_per_window = {"random": 0, "simulated_annealing": 65,
                    "tabu_search": 49, "genetic": 5}
    for name in STOCHASTIC:
        reset_counts()
        s = Simulation(cfg, iter(stoch_ws), scheduler=name,
                       batch_windows=STOCH_BATCH, seed=args.seed,
                       device=dev)
        t0 = time.time()
        st = s.run()
        swall = time.time() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        launches_stoch[name] = got
        problems = validate_invariants(st, cfg)
        assert not problems, (name, problems)
        sf = s.stats_frame()
        assert all(np.all(np.isfinite(v)) for v in sf.values()), name
        print(f"main path {name}: {s.windows_done} windows in {swall:.3f}s "
              f"-> {s.windows_done / swall:.2f} windows/s, placements "
              f"{int(sf['placements'][-1])}, invariants: OK, launches "
              f"{got}")
        assert all(got[k] > 0 for k in MAIN_PATH[:3]), (name, got)
        assert got["placement_commit"] == STOCH_WINDOWS, (name, got)
        assert got["segment_usage"] == STOCH_WINDOWS * e_per_window[name], \
            (name, got)
        stoch_states[name] = st
        # one traced window from this state: its device time, and the
        # search's own (its proposal alone on the same pending batch)
        lane_st = SimState(*[x.clone() for x in st])
        key = engine.window_keys(args.seed, 1, dev)[0]
        p_args = base_pass(st, cfg)        # idx, valid, ok, scores
        propose = PROPOSERS[name]
        propose(st, cfg, key, *p_args)                       # warm
        w1 = window_to_torch(stack_windows(windows[STOCH_WINDOWS:
                                                   STOCH_WINDOWS + 1]), dev)
        engine.run_windows(SimState(*[x.clone() for x in st]), w1, cfg,
                           get_scheduler(name), args.seed)     # warm
        rows_w = profile_call(torch, lambda: engine.run_windows(
            lane_st, w1, cfg, get_scheduler(name), args.seed),
            f"{name}: one window", top=6)
        rows_s = profile_call(torch, lambda: propose(st, cfg, key, *p_args),
                              f"{name}: its search", top=4)
        win_us = sum(r[0] for r in rows_w.values())
        search_us = sum(r[0] for r in rows_s.values())
        stoch_split[name] = dict(
            windows_per_s=s.windows_done / swall,
            window_device_ms=win_us / 1e3, search_device_ms=search_us / 1e3)
        print(f"{name}: one window's device time {win_us / 1e3:.3f} ms, the "
              f"search {search_us / 1e3:.3f} ms, the rest "
              f"{(win_us - search_us) / 1e3:.3f} ms [{smi}]")
        del s, lane_st, p_args

    # (d) the fleet: one lane of each, switchless (their preferences reach
    # kernel D as external rows); each lane against its scheduler's
    # Simulation over the same windows and seed, bitwise
    stoch_specs = [ScenarioSpec(name=n, scheduler=n) for n in STOCHASTIC]
    reset_counts()
    sfleet = ScenarioFleet(fcfg, iter(fleet_ws[:STOCH_WINDOWS]),
                           stoch_specs, batch_windows=STOCH_BATCH,
                           seed=args.seed, device=dev)
    t0 = time.time()
    sfstate = sfleet.run()
    sfwall = time.time() - t0
    launches_sfleet = {k: fn.launches for k, fn in counters.items()}
    assert sfleet.dispatch_table.switchless
    assert launches_sfleet["sched_commit"] == STOCH_WINDOWS, launches_sfleet
    assert launches_sfleet["placement_commit"] == 0, launches_sfleet
    assert launches_sfleet["segment_usage"] == STOCH_WINDOWS * sum(
        e_per_window.values()), launches_sfleet
    assert all(launches_sfleet[k] > 0 for k in FLEET_PATH), launches_sfleet
    sfsf = sfleet.stats_frame()
    print(f"stochastic fleet: {len(stoch_specs)} lanes x {STOCH_WINDOWS} "
          f"windows in {sfwall:.3f}s -> {STOCH_WINDOWS / sfwall:.2f} "
          f"windows/s, launches {launches_sfleet} [{smi}]")
    for b, name in enumerate(STOCHASTIC):
        problems = validate_invariants(lane(sfstate, b), fcfg)
        assert not problems, (name, problems)
        s = Simulation(fcfg, iter(fleet_ws[:STOCH_WINDOWS]), scheduler=name,
                       batch_windows=STOCH_BATCH, seed=args.seed,
                       device=dev)
        st = s.run()
        for f in st._fields:
            assert torch.equal(getattr(sfstate, f)[b], getattr(st, f)), \
                f"fleet lane {b} ({name}) {f} differs from Simulation"
        for k, v in s.stats_frame().items():
            assert np.array_equal(sfsf[k][:, b], v), (name, k)
        print(f"  lane {b} {name:<20} invariants: OK, == Simulation "
              "(state and stats bitwise)")
        del s, st

    # (e) snapshots: simulated_annealing paused at window 4, saved,
    # restored, run to window 8 == the straight run to window 8
    half = STOCH_WINDOWS // 2
    with tempfile.TemporaryDirectory() as d:
        snap = str(Path(d) / "sa.npz")
        s1 = Simulation(cfg, iter(stoch_ws), scheduler="simulated_annealing",
                        batch_windows=STOCH_BATCH, seed=args.seed,
                        device=dev)
        s1.run(max_windows=half)
        assert s1.windows_done == half
        save_snapshot(snap, s1.state, cfg, s1.windows_done)
        snap_mb = Path(snap).stat().st_size / 2 ** 20
        del s1
        s2 = Simulation(cfg, iter(stoch_ws[half:]),
                        scheduler="simulated_annealing",
                        batch_windows=STOCH_BATCH, seed=args.seed,
                        device=dev)
        s2.restore(snap)
        assert s2.windows_done == half
        st = s2.run()
        straight = stoch_states["simulated_annealing"]
        for f in st._fields:
            assert torch.equal(getattr(st, f), getattr(straight, f)), \
                f"resumed simulated_annealing: {f} differs"
        print(f"snapshot: simulated_annealing paused at window {half} "
              f"({snap_mb:.1f} MiB npz), restored on the card, run to "
              f"window {STOCH_WINDOWS}: every state field == the straight "
              "run")
        del s2, st

        # (f) replay: the fleet's 8 windows pre-compiled; a fleet fed from
        # window 4 of the stack and restored from its snapshot there ==
        # the uninterrupted fleet (state and trailing stats rows)
        stack = str(Path(d) / "stack.npz")
        precompile_stream(fcfg, iter(fleet_ws[:STOCH_WINDOWS]), stack,
                          STOCH_WINDOWS, shard_windows=half)
        verify_stack(stack)
        kw = dict(batch_windows=STOCH_BATCH, seed=args.seed, device=dev)
        f1 = ScenarioFleet.from_precompiled(fcfg, stack, stoch_specs,
                                            n_windows=half, **kw)
        f1.run()
        fsnap = str(Path(d) / "fleet.npz")
        f1.save(fsnap)
        del f1
        f2 = ScenarioFleet.from_precompiled(fcfg, stack, stoch_specs,
                                            start_window=half, **kw)
        f2.restore(fsnap)
        f2.run()
        assert f2.windows_done == STOCH_WINDOWS
        for f in sfstate._fields:
            assert torch.equal(getattr(f2.state, f), getattr(sfstate, f)), \
                f"replayed fleet: {f} differs"
        f2sf = f2.stats_frame()
        for k in sfsf:
            assert np.array_equal(f2sf[k], sfsf[k][half:]), k
        print(f"replay: {STOCH_WINDOWS} cell-A windows pre-compiled "
              f"({Path(stack).stat().st_size / 2 ** 20:.1f} MiB, chunks of "
              f"{half}); a fleet from_precompiled(start_window={half}) "
              "restored from its snapshot == the uninterrupted fleet "
              "(every state field, trailing stats rows)")
        del f2
    del sfleet, sfstate, stoch_states, straight, s_args, s_choice, s_req1
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7. the serving path: qwen3-4b at full width ------------------
    serve_cfg = dataclasses.replace(scfg, attention_impl="pallas")
    t0 = time.time()
    params = lm.init_params(serve_cfg,
                            torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    leaves = [t for pos in params["blocks"] for grp in pos.values()
              for t in grp.values()] + [params["embed"],
                                        params["final_norm"]]
    n_par = sum(t.numel() for t in leaves)
    print(f"serve: {serve_cfg.name} at full width: {serve_cfg.n_layers} "
          f"layers, d_model {serve_cfg.d_model}, heads {serve_cfg.n_heads}/"
          f"{serve_cfg.n_kv_heads} x {serve_cfg.resolved_head_dim}, d_ff "
          f"{serve_cfg.d_ff}, vocab {serve_cfg.vocab_size} (padded "
          f"{serve_cfg.padded_vocab}); {n_par / 1e9:.4f} B parameters, "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} "
          f"GB {serve_cfg.param_dtype}, initialised on the card in "
          f"{time.time() - t0:.1f}s")
    prompts = torch.randint(
        0, serve_cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
        device=dev, dtype=torch.int32)
    max_seq = SERVE_PROMPT + SERVE_GEN + 1

    def timed_ms(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3, out

    engine = ServingEngine(serve_cfg, params, max_seq)
    engine.generate(prompts, 2)        # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    gen_ms, out_k = timed_ms(lambda: engine.generate(prompts, SERVE_GEN))
    launches_serve = {name: fn.launches for name, fn in counters.items()}
    f_tc = fa_ops.flash_attention_cuda.launches_tc
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"launches (serve run): {launches_serve}; F through its "
          f"tensor-core body: {f_tc}")
    assert launches_serve["flash_attention"] == serve_cfg.n_layers, \
        launches_serve
    assert f_tc == serve_cfg.n_layers, f"F's TC body launched {f_tc} times"
    assert all(launches_serve[k] > 0 for k in SERVE_PATH), launches_serve
    assert out_k.shape == (SERVE_B, SERVE_GEN) and out_k.dtype == torch.int32
    assert bool(((out_k >= 0) & (out_k < serve_cfg.vocab_size)).all())
    pre_ms = float(np.median([timed_ms(lambda: engine.generate(prompts, 1))[0]
                              for _ in range(3)]))
    full_ms = float(np.median([gen_ms] + [
        timed_ms(lambda: engine.generate(prompts, SERVE_GEN))[0]
        for _ in range(2)]))
    dec_ms = (full_ms - pre_ms) / (SERVE_GEN - 1)
    print(f"serve pallas: {SERVE_B} prompts x {SERVE_PROMPT} tokens, "
          f"{SERVE_GEN} new tokens each: generate {full_ms:.3f} ms "
          f"(median of 3) [{smi}]")
    print(f"serve prefill: {pre_ms:.3f} ms for {SERVE_B} x {SERVE_PROMPT} "
          f"tokens (generate of 1 token, median of 3) [{smi}]")
    print(f"serve decode: {dec_ms:.3f} ms per token step (batch "
          f"{SERVE_B}) [{smi}]")
    print(f"serve new tokens/s: {SERVE_B * SERVE_GEN / full_ms * 1e3:.2f} "
          f"end to end, {SERVE_B / dec_ms * 1e3:.2f} in decode [{smi}]")
    print(f"serve peak memory: {peak / 2 ** 30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated) [{smi}]")
    print(f"serve flash_attention launches: "
          f"{launches_serve['flash_attention']} in one prefill "
          f"({serve_cfg.n_layers} layers) [{smi}]")
    prof_pre = profile_call(torch, lambda: engine.generate(prompts, 1),
                            f"serve prefill (B={SERVE_B}, S={SERVE_PROMPT})")
    prof_dec = profile_call(torch, lambda: engine.generate(prompts, 9),
                            "serve prefill + 8 decode steps")
    per_step = {k: ((v[0] - prof_pre.get(k, (0, 0))[0]) / 8,
                    (v[1] - prof_pre.get(k, (0, 0))[1]) / 8)
                for k, v in prof_dec.items()}
    print(f"serve one decode step, device time by kernel (the two "
          f"profiles' difference over 8): "
          f"{sum(v[0] for v in per_step.values()) / 1e3:.3f} ms")
    for key, (dev_us, count) in sorted(per_step.items(),
                                       key=lambda kv: -kv[1][0])[:10]:
        print(f"  {dev_us / 1e3:10.3f} ms  x{count:<6.4g} {key[:90]}")
    del engine

    # the same parameters and prompts through the plain einsum attention
    xla_cfg = dataclasses.replace(serve_cfg, attention_impl="xla")
    engine_x = ServingEngine(xla_cfg, params, max_seq)
    engine_x.generate(prompts, 2)
    xla_ms, out_x = timed_ms(lambda: engine_x.generate(prompts, SERVE_GEN))
    del engine_x
    print(f"serve xla: generate {xla_ms:.3f} ms (one run) [{smi}]")
    V = serve_cfg.vocab_size
    rows = {}
    with torch.inference_mode():
        for dt in ("bfloat16", "float32"):
            for c in (serve_cfg, xla_cfg):
                c = dataclasses.replace(c, dtype=dt)
                rows[dt, c.attention_impl] = lm.prefill(
                    params, c, prompts, max_seq)[0][:, 0, 0, :V].float()
    for r in rows.values():
        assert bool(torch.isfinite(r).all()), "non-finite logits"

    def rel_l2(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()

    logits_k, logits_x = rows["bfloat16", "pallas"], rows["bfloat16", "xla"]
    first = out_k[:, 0].long()
    gap = logits_x.max(-1).values - logits_x.gather(1, first[:, None])[:, 0]
    rel32 = rel_l2(rows["float32", "pallas"], rows["float32", "xla"])
    agree = int((out_k == out_x).sum())
    print(f"serve check 1: xla logit at the kernel path's first token is "
          f"{gap.tolist()} below its maximum (<= 0.05)")
    print(f"serve check 2: prefill logits with f32 activations, relative L2 "
          f"kernel vs xla {rel32} (< 2e-2)")
    print(f"serve bf16 prefill logits, relative L2: kernel vs xla "
          f"{rel_l2(logits_k, logits_x)}; kernel vs f32 "
          f"{rel_l2(logits_k, rows['float32', 'pallas'])}; xla vs f32 "
          f"{rel_l2(logits_x, rows['float32', 'pallas'])}")
    print(f"serve tokens: kernel and xla paths agree on {agree} of "
          f"{out_k.numel()}; first tokens == argmax of a prefill with the "
          f"f32 weights cast at use: "
          f"{bool((first == logits_k.argmax(-1)).all())}")
    assert bool((gap <= 0.05).all()), gap
    assert max(rel32) < 2e-2, rel32
    del params, rows, logits_k, logits_x, leaves

    # ---- 8. the training path: qwen3-4b at full width -----------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"train: memory held after serving "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} GiB")
    tc = TrainConfig()
    t0 = time.time()
    tparams = lm.init_params(tcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    topt = optim.init_opt_state(tparams)
    torch.cuda.synchronize()
    print(f"train: {tcfg.name} at full width ({tcfg.n_layers} layers, "
          f"d_model {tcfg.d_model}, vocab {tcfg.vocab_size}), chunked_ce "
          f"(ce_chunks {tcfg.ce_chunks}), attention {tcfg.attention_impl}, "
          f"remat {tcfg.remat_policy}, {tcfg.dtype} activations; "
          f"parameters and moments initialised in {time.time() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} GiB held")
    data = SyntheticLM(tcfg, TRAIN_B, TRAIN_SEQ, seed=0)

    def train_batch(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.global_batch(i).items()}

    # the first batch: kernel G's loss and gradient against the plain
    # chunked loss, on the final hidden states of the initial parameters
    b0 = train_batch(0)
    with torch.no_grad():
        hid, _ = lm.hidden_states(tparams, tcfg, b0["tokens"])
        hid = hid.reshape(ce_T, ce_d)
        head = lm._head_weight(tparams, tcfg, 0).to(hid.dtype)
    lab0 = b0["labels"].reshape(-1).to(torch.int32)
    ce_out = []
    for fn in (lm.cross_entropy_chunked, lm.cross_entropy_chunked_plain):
        h = hid.clone().requires_grad_()
        loss = fn(h, head, lab0, tcfg.vocab_size, tcfg.ce_chunks)
        loss.backward()
        ce_out.append((float(loss.detach()), h.grad))
    (l_k, dx_k), (l_p, dx_p) = ce_out
    dl = abs(l_k - l_p)
    ddx = float((dx_k.float() - dx_p.float()).abs().max())
    dx_max = float(dx_p.float().abs().max())
    print(f"train check, first batch: loss through G {l_k:.6f}, plain "
          f"chunked {l_p:.6f}, difference {dl:.3g} (<= 1e-3); d loss / d "
          f"hidden max abs difference {ddx:.3g} of its largest {dx_max:.3g} "
          f"(<= 1e-2 of it)")
    assert dl <= 1e-3 and ddx <= 1e-2 * dx_max, (dl, ddx, dx_max)
    del hid, head, ce_out, dx_k, dx_p, h, loss

    step_fn = make_train_step(tcfg, tc)

    def train_step(i):
        nonlocal tparams, topt
        tparams, topt, m = step_fn(tparams, topt, train_batch(i), None)
        return float(m["loss"])            # the runner's host sync

    t0 = time.time()
    losses = [train_step(0)]               # warm-up
    warm_s = time.time() - t0
    reset_counts()
    step_ms = []
    for i in range(1, 1 + TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.time()
        losses.append(train_step(i))
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
    launches_train = {name: fn.launches for name, fn in counters.items()}
    g_tc = ce_ops.fused_ce_cuda.launches_tc
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"launches (train run, {TRAIN_TIMED} steps): {launches_train}; "
          f"G through its tensor-core body: {g_tc}")
    assert launches_train["fused_ce"] == TRAIN_TIMED, launches_train
    assert g_tc == TRAIN_TIMED, f"G's TC body launched {g_tc} times"
    assert all(launches_train[k] > 0 for k in TRAIN_PATH), launches_train
    assert all(np.isfinite(losses)), losses
    med_ms = float(np.median(step_ms))
    phase8 = dict(first_loss=losses[0], step_ms=med_ms,
                  peak_gib=peak / 2 ** 30)       # phase 13's comparison
    print(f"train losses (warm-up + {TRAIN_TIMED}): {losses}")
    print(f"train step: {step_ms} ms, median {med_ms:.3f} ms for "
          f"{ce_T} tokens (warm-up step {warm_s * 1e3:.1f} ms) [{smi}]")
    print(f"train tokens/s: {ce_T / med_ms * 1e3:.2f} [{smi}]")
    print(f"train peak memory: {peak / 2 ** 30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated) [{smi}]")
    prof_train = profile_call(torch, lambda: train_step(1 + TRAIN_TIMED),
                              "train step (4 x 512 tokens)")
    g_us = sum(v[0] for k, v in prof_train.items() if "fused_ce" in k)
    all_us = sum(v[0] for v in prof_train.values())
    print(f"train: kernel G {g_us / 1e3:.3f} ms of {all_us / 1e3:.3f} ms "
          f"device time in the traced step (share {g_us / all_us:.4f}) "
          f"[{smi}]")
    cats = by_category(prof_train)
    print("train step, device time by category:")
    for cat, (dev_us, count) in sorted(cats.items(),
                                       key=lambda kv: -kv[1][0]):
        print(f"  {dev_us / 1e3:10.3f} ms  x{count:<6d} "
              f"{dev_us / all_us:.3f}  {cat}")
    # what phase 14's plan of this step is held to: one more step's flops
    # (FlopCounterMode; G by its registered formula) and its peak memory,
    # and the traced step's device time
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as fcm:
        train_step(2 + TRAIN_TIMED)
    torch.cuda.synchronize()
    phase8.update(flops=fcm.get_total_flops(),
                  step_peak_bytes=torch.cuda.max_memory_allocated(dev),
                  step_device_ms=all_us / 1e3)
    print(f"train step counted: {phase8['flops']:.6e} flops "
          f"(FlopCounterMode), peak {phase8['step_peak_bytes'] / 2 ** 30:.3f}"
          f" GiB, device time {phase8['step_device_ms']:.3f} ms (the traced "
          f"step) [{smi}]")
    del tparams, topt, step_fn, b0
    gc.collect()
    torch.cuda.empty_cache()

    # the training CLI's configuration at reduced width through the runner,
    # uninterrupted and with a crash injected at step 4
    rcfg = dataclasses.replace(reduced(get_config(TRAIN_ARCH)),
                               remat_policy="none")
    reps = []
    for plan in (FaultPlan(), FaultPlan(crashes={4: "smoke"})):
        with tempfile.TemporaryDirectory() as d:
            rtc = TrainConfig(learning_rate=3e-4, total_steps=8,
                              warmup_steps=1, checkpoint_every=3,
                              checkpoint_dir=d)
            reps.append(FaultTolerantRunner(
                rcfg, rtc, batch=4, seq_len=64, fault_plan=plan,
                device=dev).run(8))
    ref_rep, crash_rep = reps
    diff = float(np.abs(np.subtract(ref_rep["losses"],
                                    crash_rep["losses"])).max())
    print(f"train runner (reduced {rcfg.name}, 8 steps, checkpoint every 3):"
          f" recoveries {crash_rep['recoveries']}, losses "
          f"{crash_rep['losses']}; largest difference from the "
          f"uninterrupted run {diff:.3g} (<= 1e-5), bitwise "
          f"{ref_rep['losses'] == crash_rep['losses']}")
    assert crash_rep["recoveries"] == [4] and crash_rep["final_step"] == 8
    assert len(crash_rep["losses"]) == 8 and diff <= 1e-5, diff

    # ---- 9. times at the main path's shapes ---------------------------
    W = args.windows
    # D at the fleet's shapes and lane layout: the bytes each lane must
    # read once (ok; scores only for static score-family lanes; ext rows of
    # the external lanes; denom only for dynamic lanes) and write
    d_args = (fsc_r, f_ok, f_req, f_valid, f_total_fold, f_denom, f_res)
    d_kw = dict(fam=fleet_fam, dynamic=fleet_dyn, ext=d_ext,
                ext_row=d_ext_row)
    n_dyn = sum(fleet_dyn)
    n_score_static = sum(f == S_ and not d
                         for f, d in zip(fleet_fam, fleet_dyn))
    n_ext_rows = len({r for f, r in zip(fleet_fam, d_ext_row) if f == EX_})
    d_bytes = (Bf * P * N + (n_score_static + n_ext_rows) * P * N * 4
               + nbytes(f_req, f_valid, f_total_fold, f_res)
               + n_dyn * N * R * 4 + Bf * 16 + Bf * P * 4 + Bf * N * R * 4)
    d_ops = Bf * P * N * (3 * R + 1) + n_dyn * P * N * 3 * R
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
        "sched_commit": (
            lambda: pc_ops.sched_commit_fleet(*d_args, d_start, **d_kw),
            lambda: sched_commit_fleet_ref(*d_args, d_start, fleet_fam,
                                           fleet_dyn, d_ext, d_ext_row),
            None, 5, 2, d_bytes, d_ops),
    }
    # B and D: the cluster size each scan chose, and its latency floor: the
    # same P tasks over one node a block (N = C), where a task is one block
    # reduction and one exchange of the blocks' pairs and nothing else
    clusters = {"placement_commit": pc_ops.cluster_size("placement_commit",
                                                        1),
                "sched_commit": pc_ops.cluster_size("sched_commit", Bf)}
    c_b, c_d = clusters["placement_commit"], clusters["sched_commit"]
    floor_b = (sc_r[:, :c_b].contiguous(), req, ok[:, :c_b].contiguous(),
               valid, total_f[:c_b].contiguous(), denom[:c_b].contiguous(),
               node_res[:c_b].contiguous())
    floor_d = (fsc_r[..., :c_d].contiguous(), f_ok[..., :c_d].contiguous(),
               f_req, f_valid, f_total_fold[:, :c_d].contiguous(),
               f_denom[:, :c_d].contiguous(), f_res[:, :c_d].contiguous())
    floor_d_kw = dict(d_kw, ext=d_ext[..., :c_d].contiguous())
    floors = {
        "placement_commit": time_ms(torch, lambda: pc_ops.placement_commit(
            *floor_b, True), 5),
        "sched_commit": time_ms(torch, lambda: pc_ops.sched_commit_fleet(
            *floor_d, d_start % c_d, **floor_d_kw), 5)}
    for name, (kfn, pfn, lfn, reps, preps, nb, nops) in timings.items():
        ms = time_ms(torch, kfn, reps)
        plain_ms = time_ms(torch, pfn, preps, warmup=1)
        lib_ms = time_ms(torch, lfn, reps) if lfn else None
        b_ms, b_by = bound_ms(nb, nops)
        results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by)
        lib = f"{lib_ms:.4f}" if lib_ms is not None else "-"
        shapes = (f"fleet B={Bf}" if name == "sched_commit"
                  else "main path, node_active folded inside the kernel"
                  if name == "constraint_match" else "main path")
        scan = ""
        if name in clusters:
            results[name].update(cluster=clusters[name],
                                 latency_floor_ms=floors[name])
            scan = (f", cluster of {clusters[name]} blocks a lane, latency "
                    f"floor {floors[name]:.4f} ms ({P} dependent block "
                    f"reductions and exchanges over one node a block)")
        print(f"time {name} ({shapes}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib} ms, launches/window "
              f"{launches[name] / W:.4g} main, "
              f"{launches_fleet[name] / FLEET_WINDOWS:.4g} fleet, bound "
              f"{b_ms:.4f} ms ({b_by}){scan} [{smi}]")
    # A with its lane axis, at the fleet's shapes
    ms = time_ms(torch, lambda: cm_ops.constraint_match(*fa_args), 10)
    plain_ms = time_ms(torch, lambda: [constraint_match_ref(
        *[x[b] for x in fa_args]) for b in range(Bf)], 2, warmup=1)
    b_ms, b_by = bound_ms(nbytes(*fa_args) + Bf * P * N * 4,
                          Bf * P * N * (6 * R + 2 * C))
    results["constraint_match"]["fleet"] = dict(
        lanes=Bf, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"time constraint_match (fleet B={Bf}, one launch, node_active "
          f"folded inside): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}) [{smi}]")
    # C with its lane axis at the fleet's shapes (B=8, one launch)
    c_lanes = c_lane_inputs()
    ms = time_ms(torch, lambda: ws_ops.window_reductions(*c_lanes), 20)
    plain_ms = time_ms(torch, lambda: [window_reductions_ref(
        *[x[b] for x in c_lanes]) for b in range(Bf)], 3, warmup=1)
    b_ms, b_by = bound_ms(nbytes(*c_lanes) + Bf * (3 + 24 + U + 3 * R + 2)
                          * 4, Bf * (T * (2 * U + 4) + N * (8 * R + 8)))
    results["window_stats"]["fleet"] = dict(
        lanes=Bf, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"time window_stats (fleet B={Bf}, one launch): kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
          f"[{smi}]")
    # the bench programs: A's other store and run forms, C's parent design
    # with its two stages timed apart (each checked against this build)
    bench = {name: run_bench(exe) for name, (exe, _) in benches.items()}
    results["constraint_match"]["forms"] = bench["match_store"]["match_store"]
    results["window_stats"]["parent_split"] = \
        bench["stats_split"]["stats_split"]
    print(f"bench programs [{smi}]")
    # E with its lane axis at the fleet's shapes (B=8, V=3, one launch);
    # the library yardstick is index_add_ over the same lanes, flattened
    el_node, el_vals, el_mask = e_lanes[:3]
    el_idx = (torch.where(el_mask & (el_node >= 0), el_node.long(), N)
              + torch.arange(Bf, device=dev)[:, None] * (N + 1)).reshape(-1)
    el_flat = el_vals.reshape(-1, R)
    ms = time_ms(torch, lambda: su_ops.segment_usage_lanes(*e_lanes), 10)
    plain_ms = time_ms(torch, lambda: segment_usage_lanes_ref(*e_lanes), 5,
                       warmup=1)
    lib_ms = time_ms(torch, lambda: torch.zeros(
        Bf * (N + 1), R, device=dev).index_add_(0, el_idx, el_flat), 10)
    b_ms, b_by = bound_ms(nbytes(el_node, el_vals, el_mask) + Bf * N * R * 4,
                          int((el_mask & (el_node >= 0)).sum()) * R)
    results["segment_usage"]["fleet"] = dict(
        lanes=Bf, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
        bound_by=b_by)
    print(f"time segment_usage (fleet B={Bf} V={R}, one launch): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
          f"(index_add_ over the {Bf} lanes), launches per resync 2, bound "
          f"{b_ms:.4f} ms ({b_by}) [{smi}]")
    # F at the serving path's shape; the library yardstick is PyTorch's
    # scaled_dot_product_attention on the same tensors (head-major views)
    Bq, Sq, Hq, Dq = f_shape
    ms = time_ms(torch, lambda: fa_ops.flash_attention(
        fq, fk, fv, causal=True, scale=f_scale), 20)
    plain_ms = time_ms(torch, lambda: attention_ref(
        fq, fk, fv, causal=True, scale=f_scale), 5, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(
        fq.transpose(1, 2), fk.transpose(1, 2), fv.transpose(1, 2),
        is_causal=True, scale=f_scale), 20)
    # bytes: q, k, v read once, o written once; operations: the causal
    # pairs (S(S+1)/2 per head) times 2 products of D multiply-adds
    b_ms, b_by = bound_ms(nbytes(fq, fk, fv) + fq.numel() * 2,
                          4 * Bq * Hq * Dq * Sq * (Sq + 1) / 2,
                          BF16_OPS_PER_S)
    results["flash_attention"].update(ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=b_ms,
                                      bound_by=b_by)
    print(f"time flash_attention (serve B={Bq} S={Sq} H={Hq} D={Dq} bf16 "
          f"causal, body: {fa_ops.TC_BODY}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library "
          f"{lib_ms:.4f} ms (scaled_dot_product_attention), launches per "
          f"prefill {launches_serve['flash_attention']}, bound "
          f"{b_ms:.4f} ms ({b_by}) [{smi}]")
    # G at the training path's shape; the library yardstick is two calls,
    # linear (bf16, the unpadded vocab) and cross_entropy on the
    # materialised f32 logits
    cx, cw, clab = ce_inputs()
    clab_l = clab.long()
    fnl = torch.nn.functional
    ms = time_ms(torch, lambda: ce_ops.fused_ce_with_lse(cx, cw, clab, ce_V),
                 5)
    plain_ms = time_ms(torch, lambda: fused_ce_ref(cx, cw, clab, ce_V), 3,
                       warmup=1)
    lib_ms = time_ms(torch, lambda: fnl.cross_entropy(
        fnl.linear(cx, cw[:ce_V]).float(), clab_l, reduction="none",
        ignore_index=-1), 5)
    # bytes: x, W and the labels read once, nll and lse written once;
    # operations: T x Vp x d multiply-adds on bf16 operands
    b_ms, b_by = bound_ms(nbytes(cx, cw, clab) + 2 * ce_T * 4,
                          2 * ce_T * ce_Vp * ce_d, BF16_OPS_PER_S)
    results["fused_ce"].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by)
    print(f"time fused_ce (train T={ce_T} d={ce_d} Vp={ce_Vp} bf16, body: "
          f"{G_TC_BODY}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
          f"(two calls: linear + cross_entropy), launches per train step "
          f"{launches_train['fused_ce'] / TRAIN_TIMED:.4g}, bound "
          f"{b_ms:.4f} ms ({b_by}) [{smi}]")
    del cx, cw, clab, clab_l

    # ---- 10. the what-if service, run_fleet, pause, the monitor ---------
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"stack: {n_stack} cell-A windows pre-compiled in {t_stack:.1f}s "
          f"({Path(serve_stack).stat().st_size / 2 ** 20:.1f} MiB, chunks "
          f"of {SERVICE_BW}, inject_slots {fcfg.inject_slots})")
    t0 = time.time()
    srv = WhatIfServer(fcfg, serve_stack, schedulers=SERVICE_SCHEDULERS,
                       max_lanes=SERVICE_LANES, batch_windows=SERVICE_BW,
                       seed=args.seed, device=dev)
    srv.start(warm=True)
    warm_s = time.time() - t0
    trunk = [ScenarioSpec(name=f"trunk/{s}", scheduler=s)
             for s in SERVICE_SCHEDULERS]
    t0 = time.time()
    fork_ws = srv.build_fork_points(trunk, every=SERVICE_BW)
    fork_s = time.time() - t0
    assert fork_ws == list(range(SERVICE_BW, n_stack + 1, SERVICE_BW)), \
        fork_ws
    fork_bytes = nbytes(*srv.forks.get(SERVICE_BW)[0])
    print(f"service: warm in {warm_s:.3f}s, fork points at {fork_ws} from "
          f"a {len(trunk)}-lane trunk in {fork_s:.3f}s, "
          f"{fork_bytes / 2 ** 20:.1f} MiB a fork point on the card [{smi}]")

    # burst 1: eight strangers from window 0, one launch; launch counts
    # reset just before and read just after
    burst1 = [ScenarioSpec(name=f"{s}/outage={o:g}", scheduler=s,
                           node_outage_frac=o)
              for s in SERVICE_SCHEDULERS for o in (0.0, 0.2)]
    burst1 += [ScenarioSpec(name="greedy/cap=0.9", capacity_scale=0.9),
               ScenarioSpec(name="greedy/storm=0.05", evict_storm_frac=0.05)]
    assert len(burst1) == SERVICE_LANES
    batches0 = srv.stats()["batches"]
    reset_counts()
    t0 = time.time()
    tickets = [srv.submit(WhatIfQuery(sp, n_windows=SERVICE_BW,
                                      seed=args.seed)) for sp in burst1]
    res1 = [t.wait(timeout=600) for t in tickets]
    burst1_s = time.time() - t0
    launches_service = {k: fn.launches for k, fn in counters.items()}
    assert all(r.ok() for r in res1), [r.error for r in res1]
    assert {(r.batch_lanes, r.batch_size) for r in res1} == \
        {(SERVICE_LANES, SERVICE_LANES)}, "burst 1 did not ride one launch"
    assert srv.stats()["batches"] == batches0 + 1
    # the same eight specs as a direct fleet: every column bitwise
    reset_counts()
    direct = ScenarioFleet.from_precompiled(
        srv.cfg, serve_stack, burst1, batch_windows=SERVICE_BW,
        seed=args.seed, n_windows=SERVICE_BW, device=dev)
    direct.run()
    launches_direct = {k: fn.launches for k, fn in counters.items()}
    dframe = direct.stats_frame()
    for i, r in enumerate(res1):
        for k, v in r.frame.items():
            assert np.array_equal(v, dframe[k][:, i]), (r.name, k)
    print(f"burst 1: {len(res1)} queries from window 0 rode one launch of "
          f"{SERVICE_LANES} lanes; every frame == its lane of a direct "
          f"{SERVICE_LANES}-lane fleet, every column bitwise")
    print(f"launches (served batch): {launches_service}; direct fleet: "
          f"{launches_direct}")
    for k in ("constraint_match", "window_stats", "sched_commit"):
        assert launches_service[k] == SERVICE_BW, (k, launches_service)
    assert launches_service["placement_commit"] == 0, launches_service
    assert launches_service["segment_usage"] == \
        launches_direct["segment_usage"] > 0, (launches_service,
                                               launches_direct)
    del direct, dframe

    # burst 2: fork continuations of the three trunk lanes, one launch of
    # 3 live and 5 pad lanes, against the trunk lanes run from window 0
    burst2 = [ScenarioSpec(name=f"{s}@w{SERVICE_BW}", scheduler=s)
              for s in SERVICE_SCHEDULERS]
    t0 = time.time()
    tickets = [srv.submit(WhatIfQuery(sp, n_windows=SERVICE_BW,
                                      start_window=SERVICE_BW,
                                      seed=args.seed)) for sp in burst2]
    res2 = [t.wait(timeout=600) for t in tickets]
    burst2_s = time.time() - t0
    assert all(r.ok() for r in res2), [r.error for r in res2]
    assert {r.batch_lanes for r in res2} == {len(burst2)}
    tdirect = ScenarioFleet.from_precompiled(
        srv.cfg, serve_stack, trunk, batch_windows=SERVICE_BW,
        seed=args.seed, n_windows=2 * SERVICE_BW, device=dev)
    tdirect.run()
    tframe = tdirect.stats_frame()
    for i, r in enumerate(res2):
        for k, v in r.frame.items():
            assert np.array_equal(v, tframe[k][SERVICE_BW:, i]), (r.name, k)
    print(f"burst 2: {len(res2)} fork continuations from window "
          f"{SERVICE_BW} ({len(res2)} live + {SERVICE_LANES - len(res2)} "
          f"pad lanes) == windows [{SERVICE_BW}, {2 * SERVICE_BW}) of their "
          "trunk lanes run from window 0, every column bitwise")
    del tdirect, tframe

    # a burst-1 query again under two injected launch faults
    res0 = srv.stats()["resilience"]["retries"]
    plan = resilience.FaultPlan().on("engine_launch", "transient", times=2)
    with resilience.armed(plan):
        again = srv.query(WhatIfQuery(burst1[3], n_windows=SERVICE_BW,
                                      seed=args.seed), timeout=600)
    assert again.ok(), again.error
    for k, v in again.frame.items():
        assert np.array_equal(v, res1[3].frame[k]), k
    st = srv.stats()
    assert st["resilience"]["retries"] - res0 == 2, st["resilience"]
    assert st["errors_by_code"] == {}, st["errors_by_code"]
    print(f"chaos: {burst1[3].name} re-served under two transient "
          "engine_launch faults: 2 retries, errors by code {}, the same "
          "frame bitwise")
    served = res1 + res2 + [again]
    lat = {k: np.percentile([getattr(r, k) for r in served], [50, 99])
           for k in ("total_s", "queue_s", "exec_s")}
    service = dict(
        warm_s=warm_s, fork_points_s=fork_s, fork_point_bytes=fork_bytes,
        burst1_lane_windows_per_s=len(res1) * SERVICE_BW / burst1_s,
        burst2_lane_windows_per_s=len(res2) * SERVICE_BW / burst2_s,
        server_lane_windows_per_s=st["lane_windows_per_s"],
        **{f"{k}_p{q}": float(v[j]) for k, v in lat.items()
           for j, q in enumerate((50, 99))},
        window_cache=st["window_cache"], batches=st["batches"],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"service at cell A ({len(served)} queries; burst 1 "
          f"{service['burst1_lane_windows_per_s']:.2f} lane-windows/s, "
          f"burst 2 {service['burst2_lane_windows_per_s']:.2f}; total_s p50 "
          f"{service['total_s_p50']:.4f} p99 {service['total_s_p99']:.4f}; "
          f"window cache {st['window_cache']}; peak "
          f"{service['peak_gib']:.2f} GiB) [{smi}]")
    srv.stop()
    del srv, res1, res2, again, served
    serve_tmp.cleanup()

    # run_fleet: random, FLEET_REPLICAS replicas over STOCH_WINDOWS windows,
    # each replica against run_windows seeded seed + i
    fw = window_to_torch(stack_windows(windows[:STOCH_WINDOWS]), dev)
    reset_counts()
    t0 = time.time()
    fstates, fstats = fleet_mod.run_fleet(fw, cfg, "random", FLEET_REPLICAS,
                                          seed=args.seed)
    torch.cuda.synchronize()
    rf_s = time.time() - t0
    launches_run_fleet = {k: fn.launches for k, fn in counters.items()}
    assert all(launches_run_fleet[k] > 0 for k in MAIN_PATH[:3]), \
        launches_run_fleet
    for i in range(FLEET_REPLICAS):
        # (phase 7 rebinds the name ``engine`` to its ServingEngine)
        st_i, rows_i = run_windows(init_state(cfg, dev), fw, cfg,
                                   get_scheduler("random"),
                                   seed=args.seed + i)
        for f in st_i._fields:
            assert torch.equal(getattr(fstates, f)[i], getattr(st_i, f)), \
                f"run_fleet replica {i}: {f}"
        for k, v in rows_i.items():
            assert torch.equal(fstats[k][i], v), f"run_fleet replica {i}: {k}"
        del st_i, rows_i
    assert any(not torch.equal(fstates.task_node[0], fstates.task_node[i])
               for i in range(1, FLEET_REPLICAS)), "replicas all equal"
    print(f"run_fleet random: {FLEET_REPLICAS} replicas x {STOCH_WINDOWS} "
          f"windows in {rf_s:.3f}s, each == run_windows seeded seed + i "
          f"(state and stats bitwise), replicas differ; launches "
          f"{launches_run_fleet} [{smi}]")
    del fstates, fstats, fw

    # pause: a Simulation held from another thread for 0.2 s does not
    # advance, and then ends equal to a straight run
    pw = windows[:STOCH_WINDOWS]
    straight = Simulation(cfg, iter(pw), scheduler="greedy",
                          batch_windows=STOCH_BATCH, device=dev)
    straight.run()
    psim = Simulation(cfg, iter(pw), scheduler="greedy",
                      batch_windows=STOCH_BATCH, device=dev)
    first, held, errors = threading.Event(), threading.Event(), []

    def hold_after_first(s):
        if s.windows_done == STOCH_BATCH:
            first.set()
            held.wait(120)

    def drive():
        try:
            psim.run(on_batch=hold_after_first)
        except BaseException as e:          # re-raised on this thread
            errors.append(e)
            first.set()

    runner = threading.Thread(target=drive, daemon=True)
    runner.start()
    assert first.wait(300), "the paused run never reached its first batch"
    psim.pause()
    held.set()
    done = psim.windows_done
    time.sleep(0.2)
    still = psim.windows_done
    psim.resume()
    runner.join(300)
    assert not runner.is_alive(), "the resumed run did not end"
    if errors:
        raise errors[0]
    assert done == still == STOCH_BATCH, (done, still)
    assert psim.windows_done == straight.windows_done == STOCH_WINDOWS
    for f in straight.state._fields:
        assert torch.equal(getattr(psim.state, f),
                           getattr(straight.state, f)), f"paused run: {f}"
    print(f"pause: a Simulation held at window {done} from another thread "
          f"for 0.2 s stayed there, resumed to window {STOCH_WINDOWS}: every "
          "state field == the straight run")
    del straight, psim
    print(f"monitor.render of phase 4's final state:\n{monitor_text}")
    service.update(phase_s=time.time() - t_phase, stack_s=t_stack)
    print(f"phase 10: {service['phase_s']:.1f}s (and the stack's pre-compile "
          f"in phase 4, {t_stack:.1f}s) [{smi}]")

    # ---- 11. the MoE and SSD families ------------------------------------
    # earlier phases' tensors released first (qwen2-moe's f32 parameters
    # alone are 57 GB); the phase prints what is still held
    del windows, pw
    # phase 14's production plans run on the host meanwhile
    plan_dir = tempfile.TemporaryDirectory()
    plan_procs = start_production_plans(plan_dir.name)
    families = families_phase(
        torch, dev, smi, reset_counts, counters, results, args.seed)
    fam_launches = families["launches"]

    # ---- 12. the sharded fleet over NCCL and the full cell --------------
    launches_sharded, launches_full, sharded = sharded_and_full_cell_phase(
        torch, dev, smi, reset_counts, counters, fcfg, fleet_ws, specs,
        phase5, cfg.sched_batch)

    # ---- 13. the LM on a mesh: training (serving ran in phase 11) -------
    mesh_lm = mesh_train_phase(torch, dev, smi, reset_counts, counters,
                               tcfg, phase8)
    launches_mesh_train = mesh_lm["train"].pop("launches")

    # ---- 14. the dry-run planners ----------------------------------------
    try:
        planner = planner_phase(torch, dev, smi, reset_counts, counters,
                                tcfg, phase8, fcfg, fleet_ws, plan_procs,
                                plan_dir.name)
    finally:
        for _, _, log, proc in plan_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        plan_dir.cleanup()
    launches_plan = planner["launches"]

    # ---- 15. the kernel table ------------------------------------------
    meta = {
        "constraint_match": ("src/repro/kernels/constraint_match/kernel.py:76",),
        "placement_commit": ("src/repro/kernels/placement_commit/kernel.py:121",),
        "window_stats": ("src/repro/kernels/window_stats/kernel.py:124",),
        "sched_commit": ("src/repro/kernels/placement_commit/kernel.py:434",),
        "segment_usage": ("src/repro/kernels/segment_usage/kernel.py:39",),
        "flash_attention": ("src/repro/kernels/flash_attention/kernel.py:62",),
        "fused_ce": ("src/repro/kernels/fused_ce/kernel.py:67",),
    }
    table = []
    for name in counters:
        r = results[name]
        table.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": meta[name][0],
            "launches": (launches[name] + launches_fleet[name]
                         + launches_serve[name] + launches_train[name]
                         + sum(v[name] for v in launches_stoch.values())
                         + launches_sfleet[name] + launches_service[name]
                         + launches_run_fleet[name]
                         + sum(v[name] for v in fam_launches.values())
                         + launches_sharded[name] + launches_full[name]
                         + launches_mesh_train[name]
                         + launches_plan[name]),
            "launches_by_path": {"simulate": launches[name],
                                 "fleet": launches_fleet[name],
                                 **{f"simulate_{k}": v[name]
                                    for k, v in launches_stoch.items()},
                                 "fleet_stochastic": launches_sfleet[name],
                                 "service": launches_service[name],
                                 "run_fleet": launches_run_fleet[name],
                                 "serve": launches_serve[name],
                                 "train": launches_train[name],
                                 **{k: v[name]
                                    for k, v in fam_launches.items()},
                                 "fleet_sharded": launches_sharded[name],
                                 "full_cell": launches_full[name],
                                 "mesh_train": launches_mesh_train[name],
                                 "planner_fleet": launches_plan[name]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({k: r[k] for k in ("fleet", "forms", "parent_split",
                                  "surrogate", "qwen2_moe_serve",
                                  "mamba2_train") if k in r}),
            **({k: r[k] for k in ("cluster", "latency_floor_ms") if k in r}),
            **({"body": G_TC_BODY, "launches_tc": g_tc}
               if name == "fused_ce" else {}),
            **({"body": fa_ops.TC_BODY, "launches_tc": f_tc}
               if name == "flash_attention" else {})})
    print("kernels: " + " ".join(f"{t['name']}=ok(cuda)" for t in table))
    print("stochastic schedulers at cell A: " + json.dumps(
        {"key_draw_ms": draw_ms, "by_scheduler": stoch_split}))
    print("service at cell A: " + json.dumps({**service, "card": smi}))
    print("families: " + json.dumps(families["numbers"]))
    print("sharded fleet and full cell: " + json.dumps(sharded))
    print("LM on a mesh: " + json.dumps(
        {"serve": families["numbers"]["mesh_serve"], **mesh_lm}))
    print("planner: " + json.dumps(planner["numbers"]))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
