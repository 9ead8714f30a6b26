"""CloudSim-like baseline: a single-threaded, object-per-entity discrete-event
simulator — the comparison target of the paper's §VII (Fig. 7).

Faithful to CloudSim's architecture (the properties the paper calls out):
* completely memory-driven (whole workload materialised up front),
* single-threaded central event loop over a future-event queue,
* one VM per host, task ('cloudlet') objects placed by a simple broker,
* requested-resources-only accounting (no usage traces, no constraints,
  no node churn — Table II rows where CloudSim says 'No'/'Limited'),
* a pluggable placement policy (CloudSim's ``VmAllocationPolicy``) — the
  extensibility baseline that ``repro_torch.sched``'s registry is
  benchmarked against: here a policy is an O(N)-per-task host scan picked
  by name from ``PLACEMENT_POLICIES``; there a registered proposal
  batched over (P, N).

The paper's Fig. 7 drives this and the AGOCS engine with the same (task,
node) counts at the paper's ~11:1 task:node ratio and compares wall-clock.
Absolute Java-vs-Python constants differ from the 2016 paper; the *scaling
shapes* are what such a comparison reproduces. Standard library and numpy
only: the port's own copy of the reference's baseline, held equal to it by
``tests/test_torch_constants.py``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Host:
    hid: int
    cpu: float
    mem: float
    used_cpu: float = 0.0
    used_mem: float = 0.0
    tasks: Optional[set] = None

    def __post_init__(self):
        self.tasks = set()

    def fits(self, c, m):
        return (self.used_cpu + c <= self.cpu + 1e-9 and
                self.used_mem + m <= self.mem + 1e-9)


@dataclasses.dataclass
class Cloudlet:
    tid: int
    submit: float
    duration: float
    cpu: float
    mem: float
    host: Optional[int] = None
    finished: bool = False


def _leftover(h: Host, c: "Cloudlet") -> float:
    """Free cpu+mem the host would have left after placing the cloudlet."""
    return (h.cpu - h.used_cpu - c.cpu) + (h.mem - h.used_mem - c.mem)


def _first_fit(hosts: List[Host], c: "Cloudlet") -> Optional[Host]:
    """First fitting host in id order (CloudSim's 'simple' default)."""
    for h in hosts:                           # first-fit scan (O(N) / task)
        if h.fits(c.cpu, c.mem):
            return h
    return None


def _best_fit(hosts: List[Host], c: "Cloudlet") -> Optional[Host]:
    """Tightest fitting host (least leftover after placement)."""
    fitting = [h for h in hosts if h.fits(c.cpu, c.mem)]
    return min(fitting, key=lambda h: _leftover(h, c), default=None)


def _worst_fit(hosts: List[Host], c: "Cloudlet") -> Optional[Host]:
    """Emptiest fitting host (spread / load-balancing allocation)."""
    fitting = [h for h in hosts if h.fits(c.cpu, c.mem)]
    return max(fitting, key=lambda h: _leftover(h, c), default=None)


# the object-oriented mirror of repro_torch.sched's registry: CloudSim
# extends by subclassing VmAllocationPolicy, we pick a scan by name
PLACEMENT_POLICIES = {
    "first_fit": _first_fit,
    "best_fit": _best_fit,
    "worst_fit": _worst_fit,
}


class CloudSimLike:
    """Single-threaded DES: SUBMIT -> place (policy) -> FINISH -> release."""

    SUBMIT, FINISH = 0, 1

    def __init__(self, n_hosts: int, seed: int = 0,
                 policy: str = "first_fit"):
        if policy not in PLACEMENT_POLICIES:
            raise KeyError(f"unknown placement policy {policy!r}; "
                           f"have {list(PLACEMENT_POLICIES)}")
        self._policy = PLACEMENT_POLICIES[policy]
        rng = np.random.default_rng(seed)
        caps = np.array([[0.5, 0.5], [1.0, 1.0], [1.0, 0.5]])
        pick = caps[rng.integers(0, len(caps), n_hosts)]
        self.hosts = [Host(i, float(c), float(m)) for i, (c, m) in enumerate(pick)]
        self.queue: List[Tuple[float, int, int, int]] = []   # (t, kind, seq, tid)
        self.cloudlets: Dict[int, Cloudlet] = {}
        self.pending: List[int] = []
        self.clock = 0.0
        self._seq = 0
        self.placed = 0
        self.dropped = 0

    def submit(self, c: Cloudlet):
        self.cloudlets[c.tid] = c
        heapq.heappush(self.queue, (c.submit, self.SUBMIT, self._next(), c.tid))

    def _next(self):
        self._seq += 1
        return self._seq

    def _place(self, c: Cloudlet) -> bool:
        h = self._policy(self.hosts, c)
        if h is None:
            return False
        h.used_cpu += c.cpu
        h.used_mem += c.mem
        h.tasks.add(c.tid)
        c.host = h.hid
        self.placed += 1
        heapq.heappush(self.queue, (self.clock + c.duration,
                                    self.FINISH, self._next(), c.tid))
        return True

    def run(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        while self.queue:
            t, kind, _, tid = heapq.heappop(self.queue)
            self.clock = t
            c = self.cloudlets[tid]
            if kind == self.SUBMIT:
                if not self._place(c):
                    self.pending.append(tid)
            else:
                h = self.hosts[c.host]
                h.used_cpu -= c.cpu
                h.used_mem -= c.mem
                h.tasks.discard(tid)
                c.finished = True
                # retry pending queue (list scan — the ArrayList behaviour the
                # paper notes as CloudSim's bottleneck)
                still = []
                for p in self.pending:
                    if not self._place(self.cloudlets[p]):
                        still.append(p)
                self.pending = still
        wall = time.perf_counter() - t0
        self.dropped = len(self.pending)
        return {"wall_s": wall, "placed": self.placed,
                "finished": sum(c.finished for c in self.cloudlets.values()),
                "dropped": self.dropped}


def synth_workload(n_tasks: int, horizon: float = 3600.0, seed: int = 0
                   ) -> List[Cloudlet]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_tasks):
        out.append(Cloudlet(
            tid=i,
            submit=float(rng.uniform(0, horizon)),
            duration=float(np.clip(rng.lognormal(4.5, 1.0), 5, horizon)),
            cpu=float(np.clip(rng.lognormal(-3.2, .8), .001, .5)),
            mem=float(np.clip(rng.lognormal(-3.5, .9), .001, .5))))
    return out


def run_benchmark(n_hosts: int, n_tasks: int, seed: int = 0,
                  policy: str = "first_fit") -> Dict[str, float]:
    sim = CloudSimLike(n_hosts, seed, policy=policy)
    for c in synth_workload(n_tasks, seed=seed):
        sim.submit(c)
    return sim.run()
