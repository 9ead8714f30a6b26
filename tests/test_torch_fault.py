"""The port's fault-tolerant runner and checkpoint manager: copies of
tests/test_fault.py's six cases and tests/test_snapshot_ckpt.py's
checkpoint cases, at the same small sizes, on the CPU (crash recovery
bitwise equal), plus the training CLI and a checkpoint that carries across
between the two packages."""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as RefCheckpointManager
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.fault import FaultPlan, FaultTolerantRunner
from repro_torch.launch import train as train_cli
from repro_torch.train.data import SyntheticLM

torch.set_num_threads(1)

CFG = dataclasses.replace(reduced(get_config("granite-8b")),
                          remat_policy="none")


def _tc(d, **kw):
    base = dict(total_steps=8, warmup_steps=2, checkpoint_every=3,
                checkpoint_dir=d, async_checkpoint=False)
    base.update(kw)
    return TrainConfig(**base)


def _runner(tc, **kw):
    return FaultTolerantRunner(CFG, tc, batch=2, seq_len=32, device="cpu",
                               **kw)


def test_crash_recovery_bitwise_equal():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref = _runner(_tc(d1)).run(7, inject=False)
        got = _runner(_tc(d2), fault_plan=FaultPlan(crashes={4: "x"})).run(7)
        assert got["recoveries"] == [4]
        assert np.array_equal(ref["losses"], got["losses"])


def test_crash_recovery_bitwise_equal_with_async_checkpoints():
    """The step updates parameters and moments in place: the snapshot taken
    at save time must not follow them while the writer thread runs."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref = _runner(_tc(d1, async_checkpoint=True)).run(7, inject=False)
        got = _runner(_tc(d2, async_checkpoint=True),
                      fault_plan=FaultPlan(crashes={4: "x"})).run(7)
        assert got["recoveries"] == [4]
        assert np.array_equal(ref["losses"], got["losses"])


def test_ckpt_snapshot_is_a_copy():
    """What ``save`` hands its writer does not change with the tensors."""
    from repro_torch.checkpoint import ckpt
    tree = _tree(1)
    want = tree["w"].clone()
    arrays = ckpt._flatten(tree)
    tree["w"].add_(1.0)
    assert np.array_equal(arrays["['w']"], want.numpy())


def test_crash_before_first_checkpoint_restarts_from_zero():
    with tempfile.TemporaryDirectory() as d:
        rep = _runner(_tc(d, checkpoint_every=100),
                      fault_plan=FaultPlan(crashes={2: "early"})).run(5)
        assert rep["final_step"] == 5
        assert len(rep["losses"]) == 5


def test_fault_plan_from_sim_trace():
    plan = FaultPlan.from_sim_trace([10, 25, 300], total_steps=100,
                                    windows_per_step=2.0)
    assert plan.crashes.keys() == {5, 12}


def test_multiple_crashes_still_complete():
    with tempfile.TemporaryDirectory() as d:
        rep = _runner(_tc(d, checkpoint_every=2),
                      fault_plan=FaultPlan(crashes={3: "a", 5: "b"})).run(7)
        assert rep["final_step"] == 7
        assert rep["recoveries"] == [3, 5]


def test_data_pipeline_restart_and_elastic_determinism():
    d = SyntheticLM(CFG, batch=8, seq_len=16, seed=3)
    a = d.global_batch(5)
    b = d.global_batch(5)
    assert np.array_equal(a["tokens"], b["tokens"])       # restart determinism
    # elastic: 2 hosts' shards tile the 1-host global batch exactly
    h0 = d.host_batch(5, host_id=0, n_hosts=2)
    h1 = d.host_batch(5, host_id=1, n_hosts=2)
    assert np.array_equal(np.concatenate([h0["tokens"], h1["tokens"]]),
                          a["tokens"])


def test_straggler_detection_hook():
    with tempfile.TemporaryDirectory() as d:
        rep = _runner(_tc(d), straggler_factor=1e-9).run(6, inject=False)
        assert len(rep["stragglers"]) > 0
        assert rep["stragglers"][0]["step"] >= 4  # needs >4 steps of history


def test_runner_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FaultTolerantRunner(CFG, _tc(d))


# --- checkpoints ---------------------------------------------------------------

def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"w": torch.from_numpy(r.standard_normal((8, 4))
                                  .astype(np.float32)),
            "nest": {"b": torch.arange(5.0) + seed,
                     "s": torch.tensor(3, dtype=torch.int32)}}


def test_ckpt_roundtrip_and_keep_k():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2, async_save=False)
        for step in (1, 2, 3, 4):
            mgr.save(step, _tree(step))
        assert mgr.all_steps() == [3, 4]          # keep-K GC
        restored, meta = mgr.restore(_tree(0))
        assert meta["step"] == 4
        want = _tree(4)
        assert torch.equal(restored["w"], want["w"])
        assert torch.equal(restored["nest"]["b"], want["nest"]["b"])
        assert restored["nest"]["s"].dtype == torch.int32


def test_ckpt_async_then_restore():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3, async_save=True)
        mgr.save(7, _tree(7))
        mgr.wait()
        restored, meta = mgr.restore(_tree(0))
        assert meta["step"] == 7
        assert torch.equal(restored["w"], _tree(7)["w"])


def test_ckpt_atomicity_no_torn_reads():
    """A tmp dir from a 'crashed' writer is never visible as a checkpoint."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3, async_save=False)
        mgr.save(1, _tree(1))
        os.makedirs(os.path.join(d, ".tmp_step_000000002_999"), exist_ok=True)
        assert mgr.all_steps() == [1]
        restored, meta = mgr.restore(_tree(0))
        assert meta["step"] == 1


def test_ckpt_restore_with_shardings_waits_for_the_mesh_slice():
    """(Named when restoring onto a mesh raised.) A restore with
    shardings on a world of 1 places each leaf as a DTensor laid out by
    its sharding, bitwise the saved leaf; a ``None`` sharding leaves a
    plain tensor."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, keep=3, async_save=False)
            mgr.save(1, _tree(1))
            sh = {"w": NamedSharding(mesh, P("data", "model")),
                  "nest": {"b": NamedSharding(mesh, P(None)), "s": None}}
            restored, meta = mgr.restore(_tree(0), shardings=sh)
        want = _tree(1)
        assert meta["step"] == 1
        for leaf, w, s in ((restored["w"], want["w"], sh["w"]),
                           (restored["nest"]["b"], want["nest"]["b"],
                            sh["nest"]["b"])):
            assert tuple(leaf.placements) == s.placements
            assert torch.equal(leaf.to_local(), w)
        assert not hasattr(restored["nest"]["s"], "placements")
        assert torch.equal(restored["nest"]["s"], want["nest"]["s"])
    finally:
        dist.destroy_process_group()


def test_ckpt_carries_across_between_the_packages():
    """The same layout: the reference restores what the port wrote, and the
    port restores what the reference wrote, leaf for leaf."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        CheckpointManager(d1, async_save=False).save(5, _tree(5))
        jtmpl = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _tree(0))
        got, meta = RefCheckpointManager(d1).restore(jtmpl)
        assert meta["step"] == 5
        assert np.array_equal(np.asarray(got["w"]), _tree(5)["w"].numpy())
        RefCheckpointManager(d2, async_save=False).save(
            6, jax.tree.map(lambda t: jnp.asarray(t.numpy()), _tree(6)))
        back, _ = CheckpointManager(d2).restore(_tree(0))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_tree(6))):
            assert torch.equal(a, b)


# --- the CLI -----------------------------------------------------------------

def test_cli_runs_on_cpu(capsys, tmp_path):
    rep = train_cli.main(["--arch", "qwen3-4b", "--reduced", "--steps", "3",
                          "--device", "cpu", "--ckpt-dir",
                          str(tmp_path / "ck")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("qwen3-4b: 1L d=128 H=4/2 dff=256 vocab=512")
    assert lines[1].startswith("step     0 loss ")
    assert lines[2].startswith("final loss ") and "steps/s" in lines[2]
    assert lines[3] == ('{"final_step": 3, "recoveries": [], '
                        '"stragglers": [], "preempted": false}')
    assert rep["final_step"] == 3 and len(rep["losses"]) == 3
    assert all(np.isfinite(rep["losses"]))


def test_cli_needs_the_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen3-4b", "--reduced", "--steps", "3",
                        "--ckpt-dir", str(tmp_path / "ck")])
