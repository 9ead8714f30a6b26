"""The port's chaos hooks and crash-safe ingestion, the checks of the
reference's ``tests/test_resilience.py`` without its what-if service parts
(which come with the service's port): the fault harness (validation,
no-op when unarmed, seeded schedules, the CLI syntax), the retry and
breaker policies, and the crash-safe stack and snapshot contracts
(an interrupted precompile leaves nothing at the target path; corruption
surfaces as typed errors naming the culprit). The fault schedules and the
seeded corruption are also held equal to the reference's."""
import os
import time

import numpy as np
import pytest

from repro_torch.config import REDUCED_SIM
from repro_torch.core.events import empty_window
from repro_torch.core.precompile import (StackCorruptionError,
                                         load_window_range,
                                         precompile_stream,
                                         stack_member_crcs, verify_stack)
from repro_torch.core.snapshot import (SnapshotCorruptionError,
                                       load_snapshot, save_snapshot)
from repro_torch.core.state import SimState, init_state
from repro_torch.resilience import (BreakerPolicy, CircuitBreaker,
                                    FaultPlan, FaultSpec, PersistentFault,
                                    RetryPolicy, TransientFault, armed,
                                    disarm, maybe_corrupt, maybe_fault)

CFG = REDUCED_SIM


@pytest.fixture(autouse=True)
def _always_disarm():
    """A failing test must never leave its plan armed for the next one."""
    yield
    disarm()


# --- the fault harness -------------------------------------------------------

def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec("s", "bogus")
    with pytest.raises(ValueError):
        FaultSpec("s", "transient", times=0)
    with pytest.raises(ValueError):
        FaultSpec("s", "transient", after=-1)
    with pytest.raises(ValueError):
        FaultSpec("s", "latency", delay_s=-0.1)


def test_unarmed_is_a_noop():
    maybe_fault("anything")                    # must not raise
    data = b"untouched"
    assert maybe_corrupt("anything", data) is data   # zero-copy passthrough


def test_transient_persistent_latency_schedules():
    plan = (FaultPlan()
            .on("t", "transient", times=2)
            .on("p", "persistent", after=1)
            .on("l", "latency", times=1, delay_s=0.05))
    with armed(plan):
        for _ in range(2):
            with pytest.raises(TransientFault):
                maybe_fault("t")
        maybe_fault("t")                       # exhausted: passes through
        maybe_fault("p")                       # after=1: first call clean
        for _ in range(3):
            with pytest.raises(PersistentFault):
                maybe_fault("p")               # then forever
        t0 = time.perf_counter()
        maybe_fault("l")
        assert time.perf_counter() - t0 >= 0.05
        maybe_fault("l")                       # latency exhausted
    assert plan.calls("t") == 3 and plan.calls("p") == 4
    assert plan.fired_at("t") == [("transient", 0), ("transient", 1)]
    assert plan.fired_at("p") == [("persistent", 1), ("persistent", 2),
                                  ("persistent", 3)]
    assert plan.fired_at("l") == [("latency", 0)]


def test_corruption_is_seeded_and_single_byte():
    data = bytes(range(256)) * 4
    outs = []
    for _ in range(2):                         # same seed -> same chaos
        plan = FaultPlan(seed=11).on("c", "corrupt")
        with armed(plan):
            outs.append(maybe_corrupt("c", data))
            assert maybe_corrupt("c", data) == data    # times=1 exhausted
    assert outs[0] == outs[1] != data
    diff = [i for i, (a, b) in enumerate(zip(data, outs[0])) if a != b]
    assert len(diff) == 1 and outs[0][diff[0]] == data[diff[0]] ^ 0xFF


def test_plan_parse_cli_syntax():
    plan = FaultPlan.parse("engine_launch:transient:2, chunk_load:latency:3:0.02")
    with armed(plan):
        with pytest.raises(TransientFault):
            maybe_fault("engine_launch")
        with pytest.raises(TransientFault):
            maybe_fault("engine_launch")
        maybe_fault("engine_launch")
        maybe_fault("chunk_load")
    assert plan.fired_at("chunk_load") == [("latency", 0)]
    for bad in ("justasite", "s:nope", "s:transient:1:0.1:extra"):
        with pytest.raises(ValueError):
            FaultPlan.parse(bad)


# --- retry + breaker policies ------------------------------------------------

def test_policy_validation():
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(jitter_frac=1.5)
    with pytest.raises(ValueError):
        RetryPolicy(base_delay_s=0.5, max_delay_s=0.1)
    with pytest.raises(ValueError):
        BreakerPolicy(failure_threshold=0)
    with pytest.raises(ValueError):
        BreakerPolicy(reset_timeout_s=0.0)


def test_retry_backoff_is_seeded_and_capped():
    p = RetryPolicy(max_retries=4, base_delay_s=0.1, max_delay_s=0.3,
                    jitter_frac=0.5, seed=7)
    d1, d2 = list(p.delays()), list(p.delays())
    assert d1 == d2 and len(d1) == 4           # deterministic per policy
    caps = [min(0.3, 0.1 * 2 ** k) for k in range(4)]
    for d, cap in zip(d1, caps):
        assert 0.5 * cap <= d <= cap           # jitter shrinks, never grows
    assert list(RetryPolicy(max_retries=0).delays()) == []


def test_circuit_breaker_state_machine():
    now = [0.0]
    events = []
    cb = CircuitBreaker(BreakerPolicy(failure_threshold=2, reset_timeout_s=5.0),
                        on_transition=events.append, clock=lambda: now[0])
    assert cb.allow() and cb.state == "closed"
    cb.on_failure()
    assert cb.state == "closed" and cb.allow()
    cb.on_failure()                            # 2 consecutive: open
    assert cb.state == "open" and events == ["open"]
    assert not cb.allow() and cb.retry_after_s() == pytest.approx(5.0)
    cb.on_success()                            # a success closes from anywhere
    assert cb.state == "closed"
    cb.on_failure(); cb.on_failure()           # re-open
    now[0] = 5.0
    assert cb.allow()                          # the half-open probe
    assert cb.state == "half_open" and events[-1] == "probe"
    assert not cb.allow()                      # ... and only one probe
    cb.on_failure()                            # probe failed: re-open, re-arm
    assert cb.state == "open" and not cb.allow()
    now[0] = 10.0
    assert cb.allow() and cb.state == "half_open"
    cb.on_success()
    assert cb.state == "closed" and events[-1] == "close" and cb.allow()


# --- crash-safe ingestion -----------------------------------------------------

def _empty_stream(n):
    for _ in range(n):
        yield empty_window(CFG)


def test_interrupted_precompile_leaves_no_file(tmp_path):
    target = str(tmp_path / "stack.npz")
    with armed(FaultPlan().on("precompile_write", "transient", times=1)):
        with pytest.raises(TransientFault):
            precompile_stream(CFG, _empty_stream(12), target, 12,
                              shard_windows=4)
    # the acceptance contract: nothing at the target path, no tmp litter
    assert not os.path.exists(target)
    assert os.listdir(tmp_path) == []
    # an unfaulted rerun lands atomically, with checksums embedded
    precompile_stream(CFG, _empty_stream(12), target, 12, shard_windows=4)
    verify_stack(target)
    crcs = stack_member_crcs(target)
    assert crcs and all(k.startswith("w/") for k in crcs)


def test_chunk_read_corruption_detected(tmp_path):
    target = str(tmp_path / "stack.npz")
    precompile_stream(CFG, _empty_stream(12), target, 12, shard_windows=4)
    with armed(FaultPlan(seed=3).on("chunk_read", "corrupt", times=1)):
        with pytest.raises(StackCorruptionError, match="chunk 0"):
            verify_stack(target)
    verify_stack(target)                       # pristine once disarmed
    with armed(FaultPlan(seed=3).on("chunk_read", "corrupt", times=1)):
        with pytest.raises(StackCorruptionError):
            load_window_range(target, 0, 4, verify=True)


def test_snapshot_checksum_on_save_verify_on_restore(tmp_path):
    p = str(tmp_path / "snap.npz")
    state = init_state(CFG, "cpu")
    save_snapshot(p, state, CFG, windows_done=3, extra={"k": 1})
    snap = load_snapshot(p, device="cpu")                    # verify=True is the default
    assert snap.windows_done == 3 and snap.extra == {"k": 1}
    with armed(FaultPlan().on("snapshot_restore", "transient", times=1)):
        with pytest.raises(TransientFault):
            load_snapshot(p, device="cpu")
    # rot one byte of one field, keeping the recorded meta
    with np.load(p, allow_pickle=False) as z:
        meta = str(z["__meta__"])
        arrays = {k: np.asarray(z[k]).copy() for k in z.files
                  if k != "__meta__"}
    field = next(f for f in SimState._fields if arrays[f"state/{f}"].size)
    arrays[f"state/{field}"].view(np.uint8).flat[0] ^= 0xFF
    with open(p, "wb") as f:
        np.savez(f, __meta__=meta, **arrays)
    with pytest.raises(SnapshotCorruptionError, match=field):
        load_snapshot(p, device="cpu")
    load_snapshot(p, verify=False, device="cpu")             # explicit opt-out still loads


# --- against the reference's harness ------------------------------------------

def test_schedules_and_corruption_equal_the_references():
    """The same plan fires the same faults at the same invocations, and
    flips the same byte, in both packages."""
    import repro.resilience as ref
    spec = "t:transient:2, p:persistent, c:corrupt:2, l:latency:1:0.001"
    data = bytes(range(256)) * 2
    logs = []
    for mod in (ref, __import__("repro_torch.resilience",
                                fromlist=["FaultPlan"])):
        plan = mod.FaultPlan.parse(spec, seed=5)
        out = []
        with mod.armed(plan):
            for site in ("t", "t", "t", "p", "l", "l"):
                try:
                    mod.maybe_fault(site)
                    out.append((site, "ok"))
                except RuntimeError as e:
                    out.append((site, type(e).__name__))
            out += [mod.maybe_corrupt("c", data) for _ in range(3)]
        logs.append((out, [tuple(f) for f in plan.fired]))
        mod.disarm()
    assert logs[0] == logs[1]
