"""Alibaba OpenB pod-trace parser — the second trace family.

OpenB (the open benchmark shipped with Alibaba's Kubernetes scheduler
simulator; redistributed e.g. via Kaggle as "alibaba-full") describes one
GPU cluster as two CSV tables:

``openb_node_list*.csv``  — ``sn,cpu_milli,memory_mib,gpu,model``
``openb_pod_list*.csv``   — ``name,cpu_milli,memory_mib,num_gpu,gpu_milli,
                             gpu_spec,qos,pod_phase,creation_time,
                             deletion_time,scheduled_time``

Field mapping / normalisation (the ROADMAP sketch):

* resources normalise to cell fractions like GCD's obfuscated units:
  cpu_milli / ``cpu_cap_milli`` (default 32 cores), memory_mib /
  ``mem_cap_mib`` (default 256 GiB), and GPUs / ``gpu_cap`` as the third
  resource column (GCD uses disk there; one engine, two meanings).
* pod ``qos`` maps to GCD-style priorities (BE < Burstable < LS <
  Guaranteed); ``gpu_spec`` ("V100M16|V100M32" acceptable-model lists)
  becomes an attribute EQ constraint against the node ``model`` attribute
  (first listed model — the engine's constraint ops are scalar).
* ``creation_time``/``deletion_time`` are relative **seconds**; pods whose
  phase never terminated (no deletion) simply stay alive. ``scheduled_time``
  is the *original* scheduler's decision and is deliberately dropped — this
  simulator re-schedules. OpenB carries no usage samples, so
  ``UPDATE_TASK_USED`` never fires and used-fraction stats stay zero.

The node table is tiny (one row per node, declared at t=0); the pod table is
streamed in creation order with a pending-deletion heap, so host memory
stays O(live pods), never O(trace) — same constant-memory contract as the
GCD parser.
"""
from __future__ import annotations

import heapq
from typing import Iterator, List, Optional

from repro_torch.config import SimConfig
from repro_torch.core.events import (EventKind, HostEvent, OP_EQ,
                               REMOVE_REASON_EVICT)
from repro_torch.parsers.base import (AttrVocab, TraceParser, field_float as _f,
                                field_int as _i, iter_csv_table,
                                register_parser)

# qos class -> GCD-style priority (0..11); unknown classes sit mid-range
_QOS_PRIO = {"BE": 0, "BestEffort": 0, "Burstable": 5, "LS": 8,
             "Guaranteed": 9}
_QOS_DEFAULT_PRIO = 2

# the node attribute column the gpu_spec constraint matches against
GPU_MODEL_ATTR = "gpu_model"


@register_parser("openb")
class AlibabaOpenBParser(TraceParser):
    """Alibaba OpenB pod trace directory (node list + pod list CSVs)."""

    def __init__(self, cfg: SimConfig, trace_dir: str, *,
                 cpu_cap_milli: int = 32_000, mem_cap_mib: int = 262_144,
                 gpu_cap: int = 8):
        super().__init__(cfg, trace_dir)
        self.cpu_cap = float(cpu_cap_milli)
        self.mem_cap = float(mem_cap_mib)
        self.gpu_cap = float(gpu_cap)

    # OpenB times are relative seconds from the trace start
    @staticmethod
    def default_start_us(cfg: SimConfig) -> int:
        return 0

    def _node_events(self) -> Iterator[HostEvent]:
        for row in iter_csv_table(self.dir, "openb_node_list", pattern="{table}*.csv*"):
            if not row or row[0] in ("sn", ""):      # header / blank
                continue
            self.stats.rows += 1
            slot = self.nodes.acquire(row[0])
            if slot is None:
                continue
            cap = (_f(row, 1) / self.cpu_cap, _f(row, 2) / self.mem_cap,
                   _i(row, 3) / self.gpu_cap)
            yield HostEvent(0, EventKind.ADD_NODE, slot, a=cap)
            model = row[4] if len(row) > 4 else ""
            if model:
                yield HostEvent(0, EventKind.ADD_NODE_ATTR, slot,
                                attr_idx=self.attrs.slot(GPU_MODEL_ATTR),
                                attr_val=AttrVocab.value(model))

    def _pod_add(self, row: List[str]) -> Optional[HostEvent]:
        name = row[0]
        slot = self.tasks.acquire(name)
        if slot is None:
            return None
        gpu = _i(row, 3) or (_i(row, 4) / 1000.0)    # whole GPUs, else milli
        req = (_f(row, 1) / self.cpu_cap, _f(row, 2) / self.mem_cap,
               gpu / self.gpu_cap)
        qos = row[6] if len(row) > 6 else ""
        prio = _QOS_PRIO.get(qos, _QOS_DEFAULT_PRIO)
        cons = None
        spec = row[5] if len(row) > 5 else ""
        if spec:
            model = spec.split("|")[0]
            cons = [(self.attrs.slot(GPU_MODEL_ATTR), OP_EQ,
                     AttrVocab.value(model))]
        t = _i(row, 8) * 1_000_000
        return HostEvent(t, EventKind.ADD_TASK, slot, a=req, prio=prio,
                         job=0, constraints=cons)

    def events(self) -> Iterator[HostEvent]:
        yield from self._node_events()
        # pod rows stream in creation order; terminations wait in a heap
        # keyed by deletion time and drain before each later creation
        pending: List = []          # (t_del_us, seq, name, phase)
        seq = 0
        for row in iter_csv_table(self.dir, "openb_pod_list", pattern="{table}*.csv*"):
            if not row or row[0] in ("name", ""):    # header / blank
                continue
            self.stats.rows += 1
            if len(row) < 9:
                self.stats.bad_rows += 1
                continue
            t_add = _i(row, 8) * 1_000_000
            while pending and pending[0][0] <= t_add:
                rm = self._pod_remove(*heapq.heappop(pending))
                if rm is not None:
                    yield rm
            ev = self._pod_add(row)
            if ev is None:
                continue
            yield ev
            t_del = _i(row, 9, default=-1) if len(row) > 9 and row[9] != "" \
                else -1
            if t_del >= 0 and t_del * 1_000_000 >= t_add:
                phase = row[7] if len(row) > 7 else ""
                heapq.heappush(pending,
                               (t_del * 1_000_000, seq, row[0], phase))
                seq += 1
        while pending:
            rm = self._pod_remove(*heapq.heappop(pending))
            if rm is not None:
                yield rm

    def _pod_remove(self, t_us: int, seq: int, name: str,
                    phase: str) -> Optional[HostEvent]:
        slot = self.tasks.release(name)
        if slot is None:            # duplicate terminal: idempotent, counted
            self.stats.dup_terminal += 1
            return None
        reason = float(REMOVE_REASON_EVICT) if phase == "Failed" else 0.0
        return HostEvent(t_us, EventKind.REMOVE_TASK, slot,
                         a=(reason, 0.0, 0.0))


# ---------------------------------------------------------------------------
# Synthetic OpenB-schema generator (fixtures + offline development; the real
# trace is not redistributable here, mirroring core/tracegen.py for GCD)
# ---------------------------------------------------------------------------

def generate_openb_trace(out_dir: str, *, n_nodes: int = 16,
                         n_pods: int = 120, horizon_s: int = 600,
                         seed: int = 0) -> dict:
    """Write an OpenB-schema node+pod list pair; returns a summary dict."""
    import os
    import numpy as np
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    models = ["V100M16", "V100M32", "T4", "P100", ""]
    node_rows = []
    for n in range(n_nodes):
        model = models[int(rng.integers(0, len(models)))]
        gpus = 0 if model == "" else int(rng.choice([2, 4, 8]))
        node_rows.append((f"openb-node-{n:04d}",
                          int(rng.choice([16_000, 32_000, 64_000])),
                          int(rng.choice([65_536, 131_072, 262_144])),
                          gpus, model))
    with open(os.path.join(out_dir, "openb_node_list.csv"), "w") as f:
        f.write("sn,cpu_milli,memory_mib,gpu,model\n")
        for r in node_rows:
            f.write(",".join(str(v) for v in r) + "\n")

    qos_choices = ["BE", "LS", "Burstable", "Guaranteed"]
    pod_rows = []
    for p in range(n_pods):
        t_add = int(rng.integers(0, max(horizon_s - 60, 1)))
        dur = int(rng.lognormal(3.5, 1.0))
        t_del = t_add + max(dur, 1)
        phase = "Failed" if rng.random() < 0.1 else "Succeeded"
        if t_del >= horizon_s:
            t_del, phase = "", "Running"
        wants_gpu = rng.random() < 0.4
        num_gpu = int(rng.choice([1, 2])) if wants_gpu else 0
        spec = ""
        if wants_gpu and rng.random() < 0.5:
            spec = "|".join(sorted(set(
                rng.choice(models[:4], size=rng.integers(1, 3)))))
        pod_rows.append((f"openb-pod-{p:04d}",
                         int(rng.choice([1_000, 2_000, 4_000, 8_000])),
                         int(rng.choice([4_096, 8_192, 16_384, 32_768])),
                         num_gpu, num_gpu * 1000, spec,
                         qos_choices[int(rng.integers(0, 4))], phase,
                         t_add, t_del, t_add))
    pod_rows.sort(key=lambda r: r[8])
    with open(os.path.join(out_dir, "openb_pod_list.csv"), "w") as f:
        f.write("name,cpu_milli,memory_mib,num_gpu,gpu_milli,gpu_spec,"
                "qos,pod_phase,creation_time,deletion_time,scheduled_time\n")
        for r in pod_rows:
            f.write(",".join(str(v) for v in r) + "\n")
    return {"n_nodes": n_nodes, "n_pods": n_pods, "horizon_s": horizon_s}
