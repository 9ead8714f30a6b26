"""Deterministic fault injection + the policies it proves out.

``faults`` is the chaos harness: a seeded :class:`FaultPlan` that opted-in
call sites (chunk load, engine launch, fork-point restore, batcher loop,
precompile write) consult through :func:`maybe_fault` / :func:`maybe_corrupt`
— a single module-global ``None`` check when no plan is armed, so production
paths pay nothing. ``policy`` is the hardening the harness tests: seeded
exponential-backoff retry schedules and a CLOSED/OPEN/HALF_OPEN circuit
breaker.

    from repro_torch.resilience import FaultPlan, armed
    plan = (FaultPlan(seed=0)
            .on("engine_launch", "transient", times=2)
            .on("chunk_load", "latency", times=3, delay_s=0.01))
    with armed(plan):
        ...   # the server retries through the injected failures

The port's sites so far are the pre-compiled stack's (``precompile_write``,
``chunk_read``) and the snapshot restore (``snapshot_restore``); the what-if
service's sites come with its port.
These are the simulator's chaos hooks: the training runner keeps its own
``distributed.fault.FaultPlan``, as the reference does.
"""
from repro_torch.resilience.faults import (FaultPlan, FaultSpec,
                                           PersistentFault, TransientFault,
                                           armed, arm, disarm, maybe_corrupt,
                                           maybe_fault)
from repro_torch.resilience.policy import (BreakerPolicy, CircuitBreaker,
                                           RetryPolicy)

__all__ = [
    "BreakerPolicy", "CircuitBreaker", "FaultPlan", "FaultSpec",
    "PersistentFault", "RetryPolicy", "TransientFault", "arm", "armed",
    "disarm", "maybe_corrupt", "maybe_fault",
]
