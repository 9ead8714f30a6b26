"""The serve cells: a ``WhatIfServer`` over a stack of the cell's stream,
asked by a closed loop of planner clients.

Set-up makes the stream, pre-compiles it into a stack inside the checkout
(``build/portbench``), starts the server (its warm launch), runs the trunk
of the traffic's lane grid over the stack's first ``trunk_windows``
windows with a fork point every ``fork_every`` windows, and serves one
query of each scheduler from the latest fork point, so the query path's
window chunk is cached on the device and its shapes are warm. Then
``clients`` planner clients join, ``stagger_s`` apart, each in a closed
loop: it asks one what-if, waits for its answer and asks the next. Every
query starts at the latest fork point, runs ``query_windows`` windows with
the server's seed, and takes the next grid spec of one sequence drawn from
the seed (``workload.query_sequence``: cycles of one spec a scheduler).

The window opens at the first whole cycle of answers once every client
has joined and ``open_after`` answers have come, and closes at the first
whole cycle after ``--seconds`` (after ``trace_cycles`` cycles in a traced
run): ``answer_rate`` is every answer returned in it over all of its time.
The harness does nothing in it but wait.

``correct``: ``check_lanes`` of the window's answers are drawn from the
seed; the reference follows their specs from the empty cell to the fork
point, where the fork store's lanes are compared with its state, and on
through the query's windows, where each drawn answer's stats rows and
report row are compared (:func:`judge`, which the control shares).
"""
from __future__ import annotations

import gc
import os
import threading
import time

import numpy as np
import torch

from portbench.harness import check, common, manifest, workload
from portbench.reference import sim as ref

FIELDS = ref.FIELDS
STACK_DIR = os.path.join(manifest.ROOT, "build", "portbench")
WAIT_S = 600.0


def latest_fork(tf: dict) -> int:
    """The fork point every query starts at: the trunk's last."""
    return tf["trunk_windows"] - tf["trunk_windows"] % tf["fork_every"]


def make_trace(job: common.Job, sim_cfg):
    return workload.make_trace(job.config["cell"], job.config["trace"],
                               latest_fork(job.traffic)
                               + job.traffic["query_windows"], job.seed,
                               sim_cfg.events_per_window,
                               sim_cfg.real_task_slots)


class Clients:
    """Planner clients in a closed loop against ``server``: client c joins
    ``stagger_s`` after client c - 1 and then asks, waits and asks again.
    The n-th query asked takes spec ``seq[n]``; ``answers`` holds (n, host
    time, result) in the order the answers came."""

    def __init__(self, server, query, seq, n: int, stagger_s: float):
        self.server, self.query, self.seq = server, query, seq
        self.stagger_s = stagger_s
        self.cond = threading.Condition()
        self.answers = []
        self.asked = 0
        self.waiting = {}
        self.stopped = False
        self.joined = threading.Event()
        self.threads = [threading.Thread(target=self._client, args=(c,),
                                         daemon=True, name=f"planner-{c}")
                        for c in range(n)]
        self.starter = threading.Thread(target=self._join, daemon=True)

    def _join(self):
        for i, th in enumerate(self.threads):
            if i:
                time.sleep(self.stagger_s)
            th.start()
        self.joined.set()

    def _client(self, c: int):
        while True:
            with self.cond:
                if self.stopped:
                    return
                n = self.asked
                self.asked += 1
                ticket = self.server.submit(self.query(self.seq[n]))
                self.waiting[c] = ticket
            result = ticket.wait()
            with self.cond:
                self.waiting.pop(c, None)
                self.answers.append((n, time.perf_counter(), result))
                self.cond.notify_all()

    def start(self):
        self.starter.start()

    def wait_count(self, k: int, timeout: float) -> bool:
        with self.cond:
            return self.cond.wait_for(lambda: len(self.answers) >= k,
                                      timeout)

    def wait_close(self, first: int, step: int, t_open: float,
                   seconds: float, timeout: float):
        """The first count ``first + m * step`` (m >= 1) whose last answer
        came ``seconds`` or more after ``t_open``; None on timeout."""
        found = {}

        def closed():
            k = first + step
            while k <= len(self.answers):
                if self.answers[k - 1][1] - t_open >= seconds:
                    found["k"] = k
                    return True
                k += step
            return False
        with self.cond:
            self.cond.wait_for(closed, timeout)
        return found.get("k")

    def stop(self):
        """No client asks again; every query still waiting is cancelled
        (the batcher drops it at dispatch). Call ``server.stop`` next."""
        with self.cond:
            self.stopped = True
            waiting = list(self.waiting.values())
        for ticket in waiting:
            try:
                ticket.wait(0)
            except TimeoutError:
                pass

    def join(self):
        self.starter.join(WAIT_S)
        for th in self.threads:
            if th.is_alive():
                th.join(WAIT_S)


def run(job: common.Job, broken=None, stack_dir: str = STACK_DIR
        ) -> common.Outcome:
    from repro_torch.core.events import EventWindow
    from repro_torch.core.precompile import precompile_stream
    from repro_torch.scenarios.spec import ScenarioSpec
    from repro_torch.service.protocol import WhatIfQuery
    from repro_torch.service.server import WhatIfServer
    tf = job.traffic
    bw, qn, S = tf["batch_windows"], tf["query_windows"], latest_fork(tf)
    sim_cfg = common.sim_config(job, tf["inject_slots"])
    trace = make_trace(job, sim_cfg)
    W = S + qn
    specs = workload.grid_specs(tf["lanes"])
    pseed = workload.program_seed(job.seed)
    os.makedirs(stack_dir, exist_ok=True)
    path = os.path.join(stack_dir, "stack.npz")
    precompile_stream(sim_cfg, (EventWindow(*[trace[f][w] for f in FIELDS])
                                for w in range(W)), path, W)
    scheds = tuple(dict.fromkeys(s["scheduler"] for s in specs))
    cycle = len(scheds)
    server = WhatIfServer(sim_cfg, path, schedulers=scheds,
                          max_lanes=tf["max_lanes"], batch_windows=bw,
                          seed=pseed, device=job.device)
    if broken is not None:
        broken(server)

    def query(k):
        return WhatIfQuery(spec=ScenarioSpec(**specs[k]), n_windows=qn,
                           start_window=S, seed=pseed)

    seq = workload.query_sequence(job.seed, specs, tf["max_queries"])
    clients = Clients(server, query, seq, tf["clients"], tf["stagger_s"])
    notes = []
    server.start(warm=True)
    try:
        server.build_fork_points([ScenarioSpec(**s) for s in specs],
                                 every=tf["fork_every"], n_windows=S)
        warm = [next(k for k, s in enumerate(specs) if s["scheduler"] == name)
                for name in scheds]
        for t in [server.submit(query(k)) for k in warm]:
            t.wait(WAIT_S)
        clients.start()
        clients.joined.wait(WAIT_S)
        holder = {}
        # a traced run starts the profiler before the window opens
        with common.window_profile(job, holder):
            with clients.cond:
                here = len(clients.answers)
            first = (max(here, tf["open_after"] - 1) // cycle + 1) * cycle
            clients.wait_count(first, WAIT_S)
            t_open = clients.answers[first - 1][1]
            setup_s = t_open - job.t_start
            before = server.metrics.snapshot()
            with common.window_span(job):
                if job.trace:
                    last = first + tf["trace_cycles"] * cycle
                    if not clients.wait_count(last, WAIT_S):
                        last = None
                else:
                    last = clients.wait_close(first, cycle, t_open,
                                              job.seconds, WAIT_S)
            after = server.metrics.snapshot()
        clients.stop()
        if last is None:
            notes.append("the window did not close")
            last = len(clients.answers)
        t_win = clients.answers[last - 1][1] - t_open
        window = clients.answers[first:last]
        peak = (torch.cuda.max_memory_allocated(job.device)
                if torch.device(job.device).type == "cuda" else 0)
        ok = [(seq[n], r) for n, _, r in window if r is not None and r.ok()]
        picks = workload.rng_for(job.seed, 12).choice(
            len(ok), min(tf["check_lanes"], len(ok)), replace=False)
        checked = [ok[i] for i in sorted(picks)]
        lanes = sorted({k for k, _ in checked})
        fork_state, _ = server.forks.get(S)
        fork_lanes = {f: getattr(fork_state, f)[lanes].cpu().numpy()
                      for f in ref.State._fields}
    finally:
        clients.stop()
        server.stop()
        clients.join()
        os.remove(path)
    del server, fork_state
    gc.collect()
    if torch.device(job.device).type == "cuda":
        torch.cuda.empty_cache()

    verdict = check.Verdict()
    t = time.perf_counter()
    ref_fork, ref_rows = follow(job, sim_cfg, trace, specs, lanes, S, pseed)
    batches = sorted({(r.batch_lanes, round(r.exec_s, 3)) for _, r in ok})
    notes += [f"batches (live lanes, exec s): {batches}",
              f"reference: {len(lanes)} lanes over {W} windows in "
              f"{time.perf_counter() - t:.2f} s; window answers {first}-"
              f"{last} ({len(window)}) in {t_win:.3f} s; set-up "
              f"{setup_s:.2f} s"]
    judge(verdict, fork_lanes, ref_fork,
          [(k, r.frame, r.row) for k, r in checked], ref_rows, lanes)
    verdict.fail("answers_missing", len(window) - len(ok), 0)
    if not checked:
        verdict.fail("answers_checked", 0, -1)
    live = after["lanes"] - before["lanes"]
    padded = after["padded_lanes"] - before["padded_lanes"]
    return common.Outcome(
        values={"answer_rate": len(ok) / t_win, "setup_s": setup_s,
                "peak_mem_gib": peak / 2 ** 30},
        attempted=len(window), failed=len(window) - len(ok),
        verdict=verdict, memory_peak_bytes=peak, window=holder.get("window"),
        layer_inputs={"kind": "serve",
                      "windows": (after["batches"] - before["batches"]) * qn,
                      "latencies": [r.total_s for _, r in ok], "lanes": live,
                      "padded": padded,
                      "work": common.fleet_work(sim_cfg, specs)},
        notes=notes)


def judge(verdict: check.Verdict, fork_got, fork_want, answers, want_rows,
          lanes) -> None:
    """Add the fork point's and the answers' numbers to ``verdict``.

    ``fork_got``/``fork_want``: each state field of ``lanes`` at the fork
    point; ``answers``: (spec index, stats frame, report row) of each
    answer judged; ``want_rows``: the reference's stats rows over the
    query's windows, a lane axis in ``lanes``' order."""
    verdict.add_pair("fork", *check.gap(fork_got, fork_want,
                                        ref.State._fields))
    at = {k: j for j, k in enumerate(lanes)}
    mism, worst = 0, 0.0
    for k, frame, row in answers:
        lane_rows = {key: v[:, at[k]] for key, v in want_rows.items()}
        m, g = check.gap(frame, lane_rows, lane_rows.keys())
        want = ref.report_row(lane_rows)
        m2, g2 = check.gap({key: np.asarray(row[key]) for key in want},
                           {key: np.asarray(v) for key, v in want.items()},
                           want.keys())
        mism, worst = mism + m + m2, max(worst, g, g2)
    verdict.add_pair("answers", mism, worst)


def follow(job, sim_cfg, trace, specs, lanes, S, pseed,
           float_dtype=torch.float32):
    """The reference's state of ``lanes`` at the fork point S (numpy, a
    lane axis in front) and its stats rows over the query's windows."""
    tf = job.traffic
    fl = ref.Fleet(common.ref_cell(sim_cfg), [specs[i] for i in lanes],
                   job.device, has_storm=True, float_dtype=float_dtype)
    rows = {}

    def keep(w, row):
        for k, v in row.items():
            rows.setdefault(k, []).append(v)

    with torch.no_grad():
        since = ref.replay(fl, trace, 0, S, pseed, tf["batch_windows"])
        state = {f: getattr(fl.state, f).cpu().numpy().copy()
                 for f in ref.State._fields}
        ref.replay(fl, trace, S, S + tf["query_windows"], pseed,
                   tf["batch_windows"], since_resync=since, on_window=keep)
    return state, {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}
