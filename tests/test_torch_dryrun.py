"""The port's dry-run planners (``launch/{dryrun,plan_cost,roofline}.py``,
``core/fleet.lower_fleet``) on the CPU: fake worlds of 1 and 8 ranks,
DTensors over fake tensors (``--device cpu``).

What is held: at a world of 1 the planned flops equal ``FlopCounterMode``'s
count of the same step run for real (train, prefill, decode), exactly; on
an 8-rank (data 2 x model 4) mesh the scaled probes equal the full pass's
flops exactly (dense and MoE), each rank's share lies between the world-1
total / 8 and the total, and a training cell counts gradient reductions
(a (2, 2, 2) mesh gives the same equalities but costs minutes a cell of
DTensor's redistribution search on a CPU; the CLI test plans on
(2, 2, 2)); counts
ignore ``scan_unroll``; kernels F and G on fake CUDA tensors reach their
fake functions and are counted by their formulas; the artifact has the
reference's keys and model flops; the CLI's counterpart of
``tests/test_system.py::test_mini_dryrun_multipod_mesh`` passes; the fake
world is gone after a plan and a plan inside a live group raises; the
roofline tables are the reference's rows; ``lower_fleet``'s rank-0
replicas are bitwise the port's ``run_fleet`` and, on grid data, the
reference's."""
import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as ref_configs
from repro.config import REDUCED_SIM as REF_SIM
from repro.core import fleet as ref_fleet
from repro.core.events import HostEvent as RefHostEvent
from repro.core.events import pack_window as ref_pack_window
from repro.core.events import stack_windows as ref_stack_windows
from repro.launch import roofline as ref_roofline
from repro_torch.config import REDUCED_SIM as SIM
from repro_torch.config import ShapeConfig, TrainConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core import fleet
from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.state import state_to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.launch import dryrun, hardware, roofline
from repro_torch.launch.plan_cost import PlanCounter
from repro_torch.models import model, runtime_flags
from repro_torch.serve import engine
from repro_torch.train import optim
from repro_torch.train.step import make_train_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
CPU = torch.device("cpu")
SEQ = 32
SPLIT = (2, 4)         # 8 ranks: data 2, model 4


def _cfg(arch, repeats=1, **over):
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, n_layers=repeats * len(
        cfg.layer_pattern()), **over)


def _shape(kind, batch=4, micro=1):
    return ShapeConfig(f"t_{kind}", kind, SEQ, batch, num_microbatches=micro)


@functools.lru_cache(maxsize=None)
def _plan(arch, kind, dims, repeats=1, batch=4, micro=1, chunked=False):
    """The artifact of a reduced cell planned on a fresh fake world."""
    n = int(np.prod(dims))
    with dryrun.fake_world(n):
        mesh = dryrun.plan_mesh(dims, "cpu")
        return dryrun.plan_cell(_cfg(arch, repeats, chunked_ce=chunked),
                                _shape(kind, batch, micro), mesh,
                                "x".join(map(str, dims)), "cpu")


def _real_flops(arch, kind, chunked=False):
    """FlopCounterMode's count of the same reduced step run for real on
    the CPU, without a mesh."""
    cfg, shape = _cfg(arch, chunked_ce=chunked), _shape(kind)
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (shape.global_batch, SEQ)).astype(np.int32))
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            make_train_step(cfg, TrainConfig())(
                params, optim.init_opt_state(params),
                {"tokens": toks, "labels": toks})
        elif kind == "prefill":
            with torch.no_grad():
                engine.make_prefill_step(cfg, SEQ)(params, toks)
        else:
            cache = model.init_cache(cfg, shape.global_batch, SEQ,
                                     torch.bfloat16, CPU)
            with torch.no_grad():
                engine.make_decode_step(cfg)(params, toks[:, :1], cache,
                                             SEQ - 1)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kind,chunked", [
    ("qwen3-4b", "train", False), ("qwen3-4b", "train", True),
    ("qwen3-4b", "prefill", False), ("qwen3-4b", "decode", False),
    ("qwen2-moe-a2.7b", "train", False), ("mamba2-780m", "train", False)])
def test_world_of_one_flops_equal_flop_counter(arch, kind, chunked):
    art = _plan(arch, kind, (1, 1), chunked=chunked)
    want = _real_flops(arch, kind, chunked)
    assert want > 0
    assert art["full_program_cost_once"]["flops"] == want
    assert art["hlo_flops_per_dev"] == want
    assert art["n_chips"] == 1 and art["collectives"] == {}


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-moe-a2.7b"])
def test_probes_add_up_to_the_full_pass_on_a_split_mesh(arch):
    art = _plan(arch, "train", SPLIT, repeats=2, batch=8, micro=2)
    assert art["probe"]["scale"] == {"layer": 4, "head": 2, "opt": 1}
    assert art["hlo_flops_per_dev"] == \
        art["full_program_cost_once"]["flops"] > 0


def test_each_rank_computes_a_share():
    split = _plan("qwen3-4b", "train", SPLIT, repeats=2, batch=8, micro=2)
    whole = _plan("qwen3-4b", "train", (1, 1), repeats=2, batch=8, micro=2)
    per = split["hlo_flops_per_dev"]
    assert per * 8 >= whole["hlo_flops_per_dev"] >= per
    colls = split["collectives"]
    assert (colls.get("all-reduce", {}).get("count", 0)
            + colls.get("reduce-scatter", {}).get("count", 0)) > 0
    assert whole["collectives"] == {}
    assert split["roofline"]["collective_s"] > 0
    assert whole["roofline"]["collective_s"] == 0


def test_counts_ignore_unroll():
    base = _plan("mamba2-780m", "train", (1, 1))
    with runtime_flags.scan_unroll(ssd=4):
        with dryrun.fake_world(1):
            mesh = dryrun.plan_mesh((1, 1), "cpu")
            again = dryrun.plan_cell(_cfg("mamba2-780m"), _shape("train"),
                                     mesh, "1x1", "cpu")
    for k in ("full_program_cost_once", "probe", "memory",
              "live_bytes_per_dev"):
        if k == "probe":
            for f in ("flops", "flops_f32", "bytes", "collectives"):
                assert again[k][f] == base[k][f], f
        else:
            assert again[k] == base[k], k


def test_fake_cuda_kernels_reach_their_fake_functions_and_formulas(
        monkeypatch):
    """F and G on fake CUDA tensors: outputs of the right shapes from the
    fake functions, flops by their formulas, no launch, no data pointer,
    no build (a launch would raise here)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_launch(*a, **kw):
        raise AssertionError("a fake tensor reached a launch")
    monkeypatch.setattr(_build, "launch", no_launch)
    monkeypatch.setattr(_build, "library", no_launch)
    n_f, n_g = (fa_ops.flash_attention_cuda.launches,
                ce_ops.fused_ce_cuda.launches)
    B, S, H, D = 2, 64, 4, 128
    T, d, Vp = 48, 64, 256
    with FakeTensorMode():
        q = torch.empty((B, S, H, D), dtype=torch.bfloat16, device="cuda")
        x = torch.empty((T, d), dtype=torch.bfloat16, device="cuda")
        w = torch.empty((Vp, d), dtype=torch.bfloat16, device="cuda")
        lab = torch.empty((T,), dtype=torch.int32, device="cuda")
        with PlanCounter() as c_f:
            out = fa_ops.flash_attention(q, q, q, causal=True)
        with PlanCounter() as c_g:
            nll, lse = ce_ops.fused_ce_with_lse(x, w, lab, 200)
        with FlopCounterMode(display=False) as fc:
            ce_ops.FusedCEMean.apply(x, w, lab, 200, 4)
    assert out.shape == (B, S, H, D) and out.device.type == "cuda"
    assert nll.shape == lse.shape == (T,) and nll.dtype == torch.float32
    assert c_f.flops == fa_ops.attention_flops((B, S, H, D), None, None,
                                               True)
    assert c_f.flops == 4 * B * H * D * S * (S + 1) // 2
    assert c_g.flops == ce_ops.ce_flops((T, d), (Vp, d)) == 2 * T * d * Vp
    assert fc.get_total_flops() == 2 * T * d * Vp
    assert c_f.flops_f32 == c_g.flops_f32 == 0      # bf16 operands
    assert (fa_ops.flash_attention_cuda.launches,
            ce_ops.fused_ce_cuda.launches) == (n_f, n_g)


def _reference_artifact_keys():
    """The keys of the ``result`` dict the reference's ``run_cell``
    writes, read from its source (importing it would set XLA's device
    count)."""
    path = os.path.join(SRC, "repro", "launch", "dryrun.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and node.targets[0].id == "result"
                and isinstance(node.value, ast.Dict)
                and len(node.value.keys) > 5):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in the reference's run_cell")


def test_cli_multipod_mesh_and_artifact(tmp_path):
    """The counterpart of ``test_mini_dryrun_multipod_mesh``: the CLI on
    a fake world of 8 with a 2x2x2 pod mesh, on the CPU. (The reference's
    own run of that test fails in its mamba2 gather.)"""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-780m", "--shape", "long_500k", "--mesh", "2,2,2",
         "--device", "cpu", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    art = json.loads((tmp_path / "mamba2-780m__long_500k.json").read_text())
    assert art["status"] == "ok"
    assert art["fits_hbm"] is True
    assert art["n_chips"] == 8
    assert {"compute_s", "memory_s", "collective_s"} <= set(art["roofline"])
    assert art["hlo_flops_per_dev"] > 0
    # on (2, 2, 2) too the scaled probes are the full pass's flops
    assert art["hlo_flops_per_dev"] == art["full_program_cost_once"]["flops"]
    assert set(art) == _reference_artifact_keys()
    ref_cfg = ref_configs.get_config("mamba2-780m")
    assert art["model_flops_per_dev"] == \
        2 * ref_cfg.active_param_count() * 1 / 8
    assert art["live_bytes_per_dev"] == sum(
        art["memory"][k] for k in ("argument_size_in_bytes",
                                   "output_size_in_bytes",
                                   "temp_size_in_bytes")) - \
        art["memory"]["alias_size_in_bytes"]


def test_model_flops_follow_the_reference_formula():
    for arch in ("qwen3-4b", "qwen2-moe-a2.7b"):
        cfg = get_config(arch)
        n = ref_configs.get_config(arch).active_param_count()
        assert cfg.active_param_count() == n
        from repro_torch.config import SHAPES
        sh = SHAPES["train_4k"]
        assert dryrun.model_flops_per_dev(cfg, sh, 256) == \
            6 * n * sh.global_batch * sh.seq_len / 256
        sh = SHAPES["decode_32k"]
        assert dryrun.model_flops_per_dev(cfg, sh, 256) == \
            2 * n * sh.global_batch / 256


def test_without_a_card_the_cli_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                     "--mesh", "1,1"])
    assert not dist.is_initialized()


def test_the_fake_world_ends_and_a_live_group_is_kept(tmp_path):
    _plan("qwen3-4b", "decode", (1, 1))
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with dryrun.fake_world(2):
            assert dist.get_world_size() == 2
            1 / 0
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        with pytest.raises(ValueError, match="gloo"):
            with dryrun.fake_world(8):
                pass
        assert dist.is_initialized() and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


# --- the tables ---------------------------------------------------------------

def _art(arch, shape, dom, **kw):
    terms = {"compute_s": 0.01, "memory_s": 0.02, "collective_s": 0.005}
    terms[dom] = 0.5
    art = {"arch": arch, "shape": shape, "mesh": "16x16", "status": "ok",
           "compile_s": 12.3, "live_bytes_per_dev": 3 * 2 ** 30,
           "fits_hbm": True, "roofline": terms,
           "collectives": {"all-gather": {"count": 7, "bytes": 9e8},
                           "all-reduce": {"count": 3, "bytes": 2e8}},
           "probe": {"bytes": 10.0, "scale": {"head": 2},
                     "probes": {"head": {"bytes": 3.0}}},
           "useful_flops_ratio": 0.8, "roofline_fraction": 0.25,
           "dominant": dom}
    art.update(kw)
    return art


ARTS = [
    _art("qwen3-4b", "train_4k", "collective_s"),
    _art("qwen3-4b", "decode_32k", "memory_s", roofline_fraction=0.01),
    _art("mamba2-780m", "prefill_32k", "memory_s",
         probe={"bytes": 10.0, "scale": {"head": 1},
                "probes": {"head": {"bytes": 1.0}}}),
    _art("qwen2-moe-a2.7b", "train_4k", "compute_s", fits_hbm=False,
         collectives={"reduce-scatter": {"count": 5, "bytes": 1e9}}),
    _art("granite-8b", "train_4k", "collective_s",
         collectives={"all-to-all": {"count": 2, "bytes": 4e9}}),
    {"arch": "qwen3-4b", "shape": "long_500k", "mesh": "16x16",
     "status": "skipped", "reason": "design"},
    {"arch": "granite-8b", "shape": "prefill_32k", "mesh": "16x16",
     "status": "error", "error": "RuntimeError: out of memory"},
]


def test_roofline_tables_are_the_reference_rows(tmp_path):
    for i, a in enumerate(ARTS):
        (tmp_path / f"{i}.json").write_text(json.dumps(a))
    arts = roofline.load(str(tmp_path))
    assert arts == ref_roofline.load(str(tmp_path))
    mine, ref = (roofline.dryrun_table(arts).splitlines(),
                 ref_roofline.dryrun_table(arts).splitlines())
    assert "fits 80G" in mine[0] and mine[1:] == ref[1:]
    mine, ref = (roofline.roofline_table(arts).splitlines(),
                 ref_roofline.roofline_table(arts).splitlines())
    assert len(mine) == len(ref)
    assert mine[:2] == ref[:2]
    for a, b in zip(mine[2:], ref[2:]):
        if "compute-bound" in b:     # the card's tensor cores, not an MXU
            assert "tensor-core" in a and "MXU" in b
            assert a.rsplit("|", 2)[0] == b.rsplit("|", 2)[0]
        else:
            assert a == b
    assert roofline.pick_hillclimb(arts) == ref_roofline.pick_hillclimb(arts)


# --- the fleet plan -------------------------------------------------------------

def _grid(r, lo, hi, q=128):
    return float(r.integers(lo, hi)) / q


def _events(n_nodes=8, n_tasks=24, seed=0):
    r = np.random.default_rng(seed)
    evs0 = [(0, EventKind.ADD_NODE, i, dict(a=(1.0, 1.0, 1.0)))
            for i in range(n_nodes)]
    evs1 = [(1, EventKind.ADD_TASK, t,
             dict(a=(_grid(r, 6, 38), _grid(r, 6, 38), 0.0),
                  prio=int(r.integers(0, 12))))
            for t in range(n_tasks)]
    return evs0, evs1


def test_lower_fleet_runs_rank_zero_replicas_as_run_fleet():
    evs0, evs1 = _events()
    ws = [pack_window(SIM, [HostEvent(t, k, s, **kw) for t, k, s, kw in e],
                      i) for i, e in enumerate((evs0, evs1))]
    windows = window_to_torch(stack_windows(ws), CPU)
    with dryrun.fake_world(8):
        mesh = dryrun.plan_mesh((2, 2, 2), "cpu")
        plan = fleet.lower_fleet(SIM, mesh, "greedy", n_replicas=8,
                                 n_windows=2, windows=windows)
    assert not dist.is_initialized()
    cost = plan.cost_analysis()
    assert cost is not None and cost["bytes accessed"] > 0
    assert set(cost) == {"flops", "bytes accessed"}
    mem = plan.memory_analysis()
    assert mem.argument_size_in_bytes > 0 and mem.output_size_in_bytes > 0
    assert set(plan.kernel_launches) == {k for k, _, _ in
                                         fleet.FLEET_KERNELS}
    assert plan.replicas == [0, 1]

    states, stats = fleet.run_fleet(windows, SIM, "greedy", n_replicas=8)
    for f in states._fields:
        assert torch.equal(getattr(plan.states, f), getattr(states, f)[:2])
    assert set(plan.stats) == set(stats)
    for k in stats:
        assert torch.equal(plan.stats[k], stats[k][:2]), k

    rws = [ref_pack_window(REF_SIM, [RefHostEvent(t, int(k), s, **kw)
                                     for t, k, s, kw in e], i)
           for i, e in enumerate((evs0, evs1))]
    ref_states, ref_stats = ref_fleet.run_fleet(
        jax.tree.map(jnp.asarray, ref_stack_windows(rws)), REF_SIM,
        "greedy", n_replicas=8)
    got = state_to_numpy(plan.states)
    for f, v in ref_states._asdict().items():
        np.testing.assert_array_equal(got[f], np.asarray(v)[:2], err_msg=f)
    for k, v in ref_stats.items():
        want = np.asarray(v)[:2]
        if k.endswith("_balance_var"):   # the fleet's variance bar
            np.testing.assert_allclose(plan.stats[k].numpy(), want,
                                       rtol=5e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(plan.stats[k].numpy(), want,
                                          err_msg=k)


def test_lower_fleet_defaults_to_the_data_degree_and_empty_windows():
    with dryrun.fake_world(8):
        mesh = dryrun.plan_mesh((2, 2, 2), "cpu")
        rep, seeds, state_spec = fleet.fleet_shardings(SIM, mesh)
        plan = fleet.lower_fleet(SIM, mesh, n_windows=1, device="cpu")
        assert tuple(seeds.spec) == (("pod", "data"),)
        assert tuple(rep.spec) == ()
        assert tuple(state_spec(2).spec) == (("pod", "data"), None, None)
    assert plan.replicas == [0]           # 4 replicas over pod x data
    assert plan.states.task_state.shape[0] == 1


def test_hardware_is_the_h100():
    assert hardware.PEAK_FLOPS_BF16 == 989e12
    assert hardware.HBM_BW == 3.35e12
    assert hardware.link_bw(8) == hardware.NVLINK_BW
    assert hardware.link_bw(256) == hardware.IB_BW
