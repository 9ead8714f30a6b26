"""Fault tolerance: checkpoint/restart, simulator-driven fault injection,
straggler detection.

A copy of ``repro.distributed.fault`` in PyTorch. The AGOCS simulator
replays a real cluster's failure behaviour (node removals, evictions), and
``FaultPlan.from_sim_trace`` converts those into training-step faults that
``FaultTolerantRunner`` injects against an actual training loop — so the
recovery path is exercised by realistic failure distributions rather than
hand-picked steps.

Guarantees tested in tests/test_torch_fault.py:
* a crash at any step resumes from the last checkpoint and reproduces the
  exact loss trajectory of an uninterrupted run on the CPU (deterministic
  data pipeline, parameters drawn from a generator seeded ``tc.seed``);
* stragglers (steps slower than `straggler_factor` x running median) are
  detected and logged.

The runner takes ``device=`` (default: the card; "cpu" when asked for).
With ``shardings=`` (the ``(params, opt_state)`` tree of ``NamedSharding``s
from ``distributed.placement``) a restore places every leaf on that mesh,
whatever mesh wrote the checkpoint (elastic rescale); run the runner under
``distributed.sharding.axis_rules`` of that mesh.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.train import optim
from repro_torch.train.data import SyntheticLM
from repro_torch.train.step import make_train_step


class SimulatedFailure(RuntimeError):
    """Injected node failure (the training process 'dies' at this step)."""


@dataclasses.dataclass
class FaultPlan:
    crashes: Dict[int, str] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_sim_trace(cls, machine_removal_windows: List[int],
                       total_steps: int, windows_per_step: float = 1.0
                       ) -> "FaultPlan":
        """Map simulator node-removal windows onto training steps."""
        crashes = {}
        for w in machine_removal_windows:
            step = int(w / max(windows_per_step, 1e-9))
            if 0 < step < total_steps:
                crashes[step] = f"node_removal@window_{w}"
        return cls(crashes=crashes)


@dataclasses.dataclass
class StragglerEvent:
    step: int
    wall_s: float
    median_s: float


class FaultTolerantRunner:
    """Checkpointed training loop with injected-fault recovery."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 data: Optional[SyntheticLM] = None,
                 batch: int = 4, seq_len: int = 64,
                 fault_plan: Optional[FaultPlan] = None,
                 straggler_factor: float = 3.0,
                 shardings: Optional[Any] = None, device=None):
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.data = data or SyntheticLM(cfg, batch, seq_len, seed=tc.seed)
        self.fault_plan = fault_plan or FaultPlan()
        self.straggler_factor = straggler_factor
        self.stragglers: List[StragglerEvent] = []
        self.recoveries: List[int] = []
        self.losses: List[float] = []
        self.mgr = CheckpointManager(tc.checkpoint_dir,
                                     keep=tc.keep_checkpoints,
                                     async_save=tc.async_checkpoint)
        self._step_fn = make_train_step(cfg, tc)
        self.shardings = shardings
        self._preempted = False

    # --- lifecycle ---

    def init_or_restore(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = model_mod.init_params(self.cfg, gen, self.device)
        opt_state = optim.init_opt_state(
            params, with_ef=self.tc.grad_compression == "int8_ef")
        start = 0
        # the last save published (on every rank of a process group: a
        # barrier), so every rank restores the same step
        self.mgr.wait()
        latest = self.mgr.latest_step()
        if latest is not None:
            (params, opt_state), meta = self.mgr.restore(
                (params, opt_state), latest, shardings=self.shardings)
            start = int(meta["step"])
        elif self.shardings is not None:
            # a fresh tree takes the same layout (the reference's jit lays
            # it out itself)
            from repro_torch.distributed.placement import place_tree
            params, opt_state = place_tree((params, opt_state),
                                           self.shardings)
        return params, opt_state, start

    def install_preemption_handler(self):
        """SIGTERM -> checkpoint at the next step boundary, then exit clean —
        the pod maintenance-preemption protocol."""
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    # --- main loop ---

    def run(self, total_steps: int, inject: bool = True) -> Dict[str, Any]:
        params, opt_state, start = self.init_or_restore()
        step = start
        step_times: List[float] = []
        while step < total_steps:
            try:
                while step < total_steps:
                    if inject and step in self.fault_plan.crashes and \
                            step not in self.recoveries:
                        self.recoveries.append(step)
                        raise SimulatedFailure(self.fault_plan.crashes[step])
                    t0 = time.perf_counter()
                    batch = {k: torch.from_numpy(v).to(self.device)
                             for k, v in self.data.global_batch(step).items()}
                    params, opt_state, metrics = self._step_fn(
                        params, opt_state, batch, None)
                    loss = float(metrics["loss"])
                    self.losses.append(loss)
                    dt = time.perf_counter() - t0
                    step_times.append(dt)
                    med = float(np.median(step_times))
                    if len(step_times) > 4 and dt > self.straggler_factor * med:
                        self.stragglers.append(StragglerEvent(step, dt, med))
                    step += 1
                    if step % self.tc.checkpoint_every == 0 or \
                            step == total_steps or self._preempted:
                        self.mgr.save(step, (params, opt_state),
                                      meta={"step": step, "loss": loss})
                    if self._preempted:
                        self.mgr.wait()
                        return self._report(step, preempted=True)
            except SimulatedFailure:
                # the 'new process' restores from the last durable checkpoint
                params, opt_state, step = self.init_or_restore()
                self.losses = self.losses[:step]
        self.mgr.wait()
        return self._report(step)

    def _report(self, step: int, preempted: bool = False) -> Dict[str, Any]:
        return {
            "final_step": step,
            "losses": list(self.losses),
            "recoveries": list(self.recoveries),
            "stragglers": [dataclasses.asdict(s) for s in self.stragglers],
            "preempted": preempted,
        }
