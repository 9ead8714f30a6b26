"""What both kinds of cell share: the run's description, the simulator
configuration a cell runs under, the profiler around the window, the
device's numbers and the reference's sizes."""
from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import Any, Dict, List, Optional

import torch

from portbench.harness import roofline
from portbench.harness.profile import Window
from portbench.reference import sim as ref

WINDOW_SPAN = "bench.window"


class WindowClosed(Exception):
    """Raised from the program's per-batch hook to end the window."""


@dataclasses.dataclass
class Job:
    """One run of one cell."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float            # the process's start, for setup_s


@dataclasses.dataclass
class Outcome:
    """What a cell's driver hands back to ``run.py``."""
    values: Dict[str, float]               # end-to-end metric -> value
    attempted: int
    failed: int
    verdict: Any                           # check.Verdict
    memory_peak_bytes: int
    window: Optional[Window] = None        # the traced window
    layer_inputs: Optional[dict] = None    # what per-layer readers read
    notes: List[str] = dataclasses.field(default_factory=list)


def sim_config(job: Job, inject_slots: int):
    from repro_torch.config import SimConfig
    return SimConfig(**job.config["cell"], inject_slots=inject_slots)


def ref_cell(sim_cfg) -> ref.Cell:
    return ref.Cell(**{f.name: getattr(sim_cfg, f.name)
                       for f in dataclasses.fields(ref.Cell)})


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def window_profile(job: Job, holder: dict):
    """Profile while the run is traced; ``holder['window']`` gets the
    reduced trace of the :func:`window_span` inside, once the profiler has
    stopped."""
    if not job.trace:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(job.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    holder["window"] = Window(prof, WINDOW_SPAN)


def window_span(job: Job):
    """The measured window's span inside :func:`window_profile`."""
    if not job.trace:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(WINDOW_SPAN)


def fleet_work(sim_cfg, specs: List[dict]) -> Dict[str, tuple]:
    """A's and D's work per launch at the fleet's shapes."""
    fams = [ref.SCHEDULERS[s["scheduler"]] for s in specs]
    B = len(specs)
    return {
        "A": roofline.match_work(B, sim_cfg.sched_batch, sim_cfg.max_nodes,
                                 sim_cfg.n_resources, sim_cfg.max_constraints,
                                 sim_cfg.n_attr_slots),
        "D": roofline.commit_work(sim_cfg.sched_batch, sim_cfg.max_nodes,
                                  sim_cfg.n_resources, [f[0] for f in fams],
                                  [f[2] for f in fams]),
    }


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def elapsed(t0: float) -> float:
    return time.perf_counter() - t0
