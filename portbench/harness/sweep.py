"""The sweep cells: one ``ScenarioFleet`` of the traffic's lane grid over
the cell's stream, on the switchless path (kernels A, C, D and E).

Set-up makes the stream and the fleet and runs the declaration and fill
windows (``warm_windows``): the cell fills to its running population,
every shape of the window is warmed and a resync has run. The window then
drives ``ScenarioFleet.run`` over the rest of the stream, which reaches the
program only through its window source (already in host memory); the
harness does nothing inside it but read the clock at each batch's end. The
window closes at the first batch end after ``--seconds`` (or after
``trace_batches`` batches in a traced run), with a sync: ``sweep_rate`` is
every lane-window of the window over all of its time.

``correct``: the reference follows ``check_lanes`` lanes drawn from the
seed from the empty cell through set-up and every batch of the window,
resyncs included, and every stats row of those lanes and windows is
compared.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from portbench.harness import check, common, workload
from portbench.reference import sim as ref

FIELDS = ref.FIELDS


class Source:
    """The made stream, one packed window at a time, until closed."""

    def __init__(self, trace):
        self.trace = trace
        self.closed = False

    def __iter__(self):
        from repro_torch.core.events import EventWindow
        for w in range(self.trace["kind"].shape[0]):
            if self.closed:
                return
            yield EventWindow(*[self.trace[f][w] for f in FIELDS])


def n_windows(job: common.Job) -> int:
    tf = job.traffic
    bw = tf["batch_windows"]
    if job.trace:
        timed = (tf.get("trace_batches", 2) + 1) * bw
    else:
        timed = math.ceil(tf["max_windows_per_s"] * job.seconds / bw + 1) * bw
    return tf["warm_windows"] + timed


def make_inputs(job: common.Job):
    tf = job.traffic
    sim_cfg = common.sim_config(job, tf["inject_slots"])
    trace = workload.make_trace(job.config["cell"], job.config["trace"],
                                n_windows(job), job.seed,
                                sim_cfg.events_per_window,
                                sim_cfg.real_task_slots)
    return sim_cfg, trace, workload.grid_specs(tf["lanes"])


def run(job: common.Job, broken=None) -> common.Outcome:
    """``broken(fleet)`` plants a fault in the program (the tests')."""
    from repro_torch.scenarios.runner import ScenarioFleet
    from repro_torch.scenarios.spec import ScenarioSpec
    tf = job.traffic
    bw, warm = tf["batch_windows"], tf["warm_windows"]
    t = time.perf_counter()
    sim_cfg, trace, specs = make_inputs(job)
    notes = [f"stream of {trace['kind'].shape[0]} windows made in "
             f"{time.perf_counter() - t:.2f} s"]
    pseed = workload.program_seed(job.seed)
    src = Source(trace)
    fleet = ScenarioFleet(sim_cfg, iter(src),
                          [ScenarioSpec(**s) for s in specs],
                          batch_windows=bw, seed=pseed, device=job.device)
    if broken is not None:
        broken(fleet)
    fleet.run(max_windows=warm)
    common.sync(job.device)
    setup_s = common.elapsed(job.t_start)

    batches = {"n": 0}
    limit = tf.get("trace_batches", 2)

    def close(drv):
        batches["n"] += 1
        done = (batches["n"] >= limit if job.trace
                else common.elapsed(t0) >= job.seconds)
        if done:
            raise common.WindowClosed

    holder = {}
    w0 = fleet.windows_done
    with common.window_profile(job, holder), common.window_span(job):
        t0 = time.perf_counter()
        try:
            fleet.run(on_batch=close)
            notes.append("the stream ran dry before the window closed")
        except common.WindowClosed:
            pass
        common.sync(job.device)
        t_win = common.elapsed(t0)
    windows = fleet.windows_done - w0
    B = len(specs)
    peak = (torch.cuda.max_memory_allocated(job.device)
            if torch.device(job.device).type == "cuda" else 0)
    src.closed = True
    for _ in fleet.prefetcher:          # let the fill thread finish
        pass
    frame = fleet.stats_frame()
    del fleet
    gc.collect()
    if torch.device(job.device).type == "cuda":
        torch.cuda.empty_cache()

    verdict = check.Verdict()
    lanes = workload.sample_lanes(job.seed, B, tf["check_lanes"])
    hi = frame["n_running"].shape[0]
    prog = {k: v[:hi, lanes] for k, v in frame.items()}
    t = time.perf_counter()
    rows = follow(job, sim_cfg, trace, specs, lanes, hi, pseed)
    notes.append(f"reference: {len(lanes)} lanes over {hi} windows in "
                 f"{time.perf_counter() - t:.2f} s; window {windows} windows "
                 f"in {t_win:.3f} s; set-up {setup_s:.2f} s")
    verdict.add_pair("rows", *check.gap(prog, rows, prog.keys()))
    return common.Outcome(
        values={"sweep_rate": windows * B / t_win, "setup_s": setup_s,
                "peak_mem_gib": peak / 2 ** 30},
        attempted=windows * B, failed=0, verdict=verdict,
        memory_peak_bytes=peak, window=holder.get("window"),
        layer_inputs={"kind": "sweep", "windows": windows,
                      "work": common.fleet_work(sim_cfg, specs)},
        notes=notes)


def follow(job, sim_cfg, trace, specs, lanes, hi, pseed,
           float_dtype=torch.float32):
    """The reference's stats rows of ``lanes`` over windows [0, hi)."""
    has_storm = any(s.get("evict_storm_frac", 0.0) > 0 for s in specs)
    fl = ref.Fleet(common.ref_cell(sim_cfg), [specs[i] for i in lanes],
                   job.device, has_storm=has_storm, float_dtype=float_dtype)
    rows = {}

    def keep(w, row):
        for k, v in row.items():
            rows.setdefault(k, []).append(v)

    with torch.no_grad():
        ref.replay(fl, trace, 0, hi, pseed, job.traffic["batch_windows"],
                   on_window=keep)
    return {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}
