"""The LM on a mesh of one rank (gloo, in process): sharding over size-1
axes changes no arithmetic, so every result is bitwise the unsharded
port's, and placing a tree copies no leaf. This is the layout the card
runs (a world of 1 over NCCL, ``chip_smoke.py`` phase 13).

Covered for reduced qwen3-4b, qwen2-moe-a2.7b (both ``moe_impl``s),
mamba2-780m and jamba: forward logits and aux, two training steps
(losses, metrics, parameters and AdamW moments), prefill (logits and
cache) and decode logits under the serving rules, greedy tokens; the
MoE layer under both implementations; qwen3-4b tied to the JAX
reference's forward; ``compressed_psum`` against a numpy oracle and the
reference's ``shard_map`` version; ``FaultTolerantRunner(shardings=)``
through an injected crash. The world is destroyed in a ``finally``.
"""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.config import ShapeConfig, TrainConfig
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import compression, placement
from repro_torch.distributed.fault import FaultPlan, FaultTolerantRunner
from repro_torch.distributed.sharding import (NamedSharding, P, axis_rules,
                                              import_shard_map, make_rules,
                                              make_sharding)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as lm
from repro_torch.models import moe
from repro_torch.serve.engine import ServingEngine
from repro_torch.train import optim
from repro_torch.train.data import SyntheticLM
from repro_torch.train.step import make_train_step
from repro_torch.train.tree import leaves, map_tree

torch.set_num_threads(1)

ARCHS = [("qwen3-4b", "gspmd"), ("qwen2-moe-a2.7b", "gspmd"),
         ("qwen2-moe-a2.7b", "shard_map"), ("mamba2-780m", "gspmd"),
         ("jamba-1.5-large-398b", "gspmd")]


@pytest.fixture(scope="module")
def mesh():
    m = make_host_mesh(1, 1, device="cpu")
    try:
        yield m
    finally:
        dist.destroy_process_group()


def _cfg(arch, impl, **kw):
    return dataclasses.replace(reduced(get_config(arch)), moe_impl=impl,
                               capacity_factor=16.0, **kw)


def _params(cfg, seed=0):
    return lm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _batch(cfg, step=0):
    return {k: torch.from_numpy(v) for k, v in
            SyntheticLM(cfg, 4, 16, seed=0).global_batch(step).items()}


def _placed(cfg, mesh, mode, params):
    rules = make_rules(mesh, mode, cfg)
    return rules, placement.place_tree(
        params, placement.param_shardings(cfg, mesh, rules))


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _equal_trees(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(_full(x), y)


@pytest.mark.parametrize("arch,impl", ARCHS)
def test_forward_is_bitwise_and_placing_copies_nothing(mesh, arch, impl):
    cfg = _cfg(arch, impl, remat_policy="none")
    params = _params(cfg)
    toks = _batch(cfg)["tokens"]
    want, want_aux = lm.forward(params, cfg, toks)
    rules, dp = _placed(cfg, mesh, "train", params)
    assert all(a.to_local().data_ptr() == b.data_ptr()
               for a, b in zip(leaves(dp), leaves(params)))
    with axis_rules(mesh, rules):
        got, aux = lm.forward(dp, cfg, toks)
    assert torch.equal(_full(got), want)
    assert torch.equal(_full(aux), want_aux)


def _close(got, want, bar=1e-5):
    got = _full(got)
    return float((got - want).abs().max()) <= bar * max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("arch,impl", ARCHS)
def test_train_steps_are_bitwise(mesh, arch, impl, chunked):
    """Two AdamW steps (full remat, the configs' policy) on placed
    parameters and moments against the unsharded step. Under
    ``moe_impl="shard_map"`` the forward and the first loss are bitwise,
    but the MoE input's gradient adds the region's and the shared
    experts' parts in another order than ``_apply_gspmd``'s graph does
    (ROADMAP Queue 3): the rest is held within 1e-5 of max(1, the largest
    unsharded value)."""
    cfg = _cfg(arch, impl, chunked_ce=chunked)
    tc = TrainConfig()
    ref_p = _params(cfg)
    ref_o = optim.init_opt_state(ref_p)
    rules = make_rules(mesh, "train", cfg)
    psh = placement.param_shardings(cfg, mesh, rules)
    dp, do = placement.place_tree(
        (map_tree(torch.clone, ref_p), optim.init_opt_state(ref_p)),
        (psh, placement.opt_shardings(psh, mesh)))
    step_ref, step = make_train_step(cfg, tc), make_train_step(cfg, tc)
    bsh = placement.batch_shardings(cfg, mesh, rules)
    for i in range(2):
        b = _batch(cfg, i)
        ref_p, ref_o, want = step_ref(ref_p, ref_o, b)
        with axis_rules(mesh, rules):
            db = placement.place_tree(b, {k: bsh[k] for k in b})
            dp, do, got = step(dp, do, db)
        for k in want:
            if impl == "shard_map" and (i, k) not in ((0, "loss"),
                                                      (0, "ce")):
                assert _close(got[k], want[k]), (i, k)
            else:
                assert torch.equal(_full(got[k]), want[k]), (i, k)
    if impl == "shard_map":
        for a, b in zip(leaves((dp, do.mu, do.nu)),
                        leaves((ref_p, ref_o.mu, ref_o.nu))):
            assert _close(a, b)
    else:
        _equal_trees(dp, ref_p)
        _equal_trees((do.mu, do.nu), (ref_o.mu, ref_o.nu))
    assert int(do.step.full_tensor()) == int(ref_o.step) == 2


@pytest.mark.parametrize("arch,impl", ARCHS)
def test_prefill_decode_and_generate_are_bitwise(mesh, arch, impl):
    cfg = _cfg(arch, impl)
    params = _params(cfg)
    toks = _batch(cfg)["tokens"][:, :8]
    max_seq = 14
    with torch.no_grad():
        want, cache = lm.prefill(params, cfg, toks, max_seq)
        wsteps = []
        for i in range(3):
            lg, cache = lm.decode_step(params, cfg, toks[:, i:i + 1], cache,
                                       8 + i)
            wsteps.append(lg)
    shape = ShapeConfig("t", "decode", max_seq, toks.shape[0])
    for mode in (placement.choose_serve_mode(shape, mesh), "serve_seq"):
        rules, sp = _placed(cfg, mesh, mode, params)
        with axis_rules(mesh, rules), torch.no_grad():
            got, dcache = lm.prefill(sp, cfg, toks, max_seq)
            assert torch.equal(got.full_tensor(), want)
            steps = []
            for i in range(3):
                lg, dcache = lm.decode_step(sp, cfg, toks[:, i:i + 1],
                                            dcache, 8 + i)
                steps.append(lg.full_tensor())
        for a, b in zip(steps, wsteps):
            assert torch.equal(a, b), mode
        _equal_trees(dcache, cache)
    want = ServingEngine(cfg, params, max_seq).generate(toks, 4)
    rules, sp = _placed(cfg, mesh, "serve", params)
    with axis_rules(mesh, rules):
        got = ServingEngine(cfg, sp, max_seq).generate(toks, 4)
    assert torch.equal(got.full_tensor(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_both_impls_are_the_unsharded_layer(mesh, dtype):
    cfg = _cfg("qwen2-moe-a2.7b", "gspmd", dtype=dtype)
    blk = {n: w[0] for n, w in _params(cfg)["blocks"][0]["mlp"].items()}
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(
        getattr(torch, dtype))
    want, want_aux = moe.apply(blk, cfg, x)
    axes = lm.param_logical_axes(cfg)["blocks"][0]["mlp"]
    for impl in ("gspmd", "shard_map"):
        c = dataclasses.replace(cfg, moe_impl=impl)
        rules = make_rules(mesh, "train", c)
        db = {n: placement.place(w, make_sharding(axes[n][1:], mesh, rules))
              for n, w in blk.items()}
        with axis_rules(mesh, rules):
            got, aux = moe.apply(db, c, x)
        assert torch.equal(_full(got), want), impl
        assert torch.equal(_full(aux), want_aux), impl


def test_mesh_forward_matches_the_reference(mesh):
    """Reduced qwen3-4b on the mesh against the JAX reference's forward
    on the same parameters (the existing bar between the packages)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.models import model as ref_model
    ref_cfg = ref_configs.reduced(ref_configs.get_config("qwen3-4b"))
    ref_params = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = _cfg("qwen3-4b", "gspmd")
    params = lm.params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params))
    toks = _batch(cfg)["tokens"]
    want, _ = ref_model.forward(ref_params, ref_cfg, jnp.asarray(toks.numpy()))
    want = np.asarray(want)
    rules, dp = _placed(cfg, mesh, "train", params)
    with axis_rules(mesh, rules):
        got = lm.forward(dp, cfg, toks)[0].full_tensor().numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def _oracle(x):
    x = np.asarray(x, np.float32)
    scale = np.float32(np.abs(x).max()) / np.float32(127.0) + \
        np.float32(1e-12)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int32)
    return q.astype(np.float32) * scale


def test_compressed_psum_is_the_oracle_and_the_reference(mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from repro.distributed import compression as ref_compression
    from repro.distributed.sharding import import_shard_map as ref_shim
    from torch.distributed.tensor import Replicate
    local_map, kw = import_shard_map()
    dmesh = NamedSharding(mesh, P()).device_mesh
    shard_map, check_kw = ref_shim()
    jm = jax.make_mesh((1,), ("d",))
    for x in (np.linspace(-1, 1, 16, dtype=np.float32),
              np.random.default_rng(0).standard_normal(1000).astype(
                  np.float32) * 3):
        got = local_map(lambda v: compression.compressed_psum(v, "data",
                                                              mesh),
                        out_placements=[Replicate()],
                        in_placements=([Replicate()],), device_mesh=dmesh,
                        **kw)(torch.from_numpy(x))
        assert np.array_equal(got.numpy(), _oracle(x))
        ref = shard_map(lambda v: ref_compression.compressed_psum(v, "d"),
                        mesh=jm, in_specs=JP(), out_specs=JP(),
                        **check_kw)(jnp.asarray(x))
        assert np.array_equal(got.numpy(), np.asarray(ref))
    with axis_rules(mesh, {}):           # the active mesh by default
        y = compression.compressed_psum(torch.ones(3), "model")
    assert np.array_equal(y.numpy(), _oracle(np.ones(3)))


def test_runner_restores_onto_the_mesh_through_a_crash(mesh):
    cfg = _cfg("qwen3-4b", "gspmd", remat_policy="none")
    rules = make_rules(mesh, "train", cfg)
    psh = placement.param_shardings(cfg, mesh, rules)
    sh = (psh, placement.opt_shardings(psh, mesh))
    losses = []
    for shardings, plan in ((None, FaultPlan()), (sh, FaultPlan({3: "x"}))):
        with tempfile.TemporaryDirectory() as d:
            tc = TrainConfig(checkpoint_dir=d, checkpoint_every=2,
                             async_checkpoint=False, total_steps=6,
                             warmup_steps=1, learning_rate=3e-4)
            with axis_rules(mesh if shardings else None, rules):
                runner = FaultTolerantRunner(cfg, tc, batch=2, seq_len=16,
                                             fault_plan=plan,
                                             shardings=shardings,
                                             device="cpu")
                rep = runner.run(6)
                if shardings is not None:
                    params, opt, step = runner.init_or_restore()
                    assert step == 6
                    assert all(hasattr(t, "placements")
                               for t in leaves((params, opt)))
        losses.append(rep["losses"])
    assert rep["recoveries"] == [3] and len(losses[1]) == 6
    assert np.abs(np.subtract(*losses)).max() <= 1e-5


def test_recomputation_in_another_thread_keeps_the_rules(mesh):
    """On the card autograd runs the backward, and with it the
    recomputation of checkpointed blocks, in its own thread, which
    inherits DTensor's implicit replication (a thread-local flag) but not
    this package's thread-local rules: the recomputation must run under
    the forward's rules (here the backward runs in a new thread, the flag
    set there as autograd would carry it), and leaving nested activations
    keeps the flag on for the outer one."""
    import threading
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = _cfg("qwen3-4b", "gspmd", remat_policy="full")
    params = _params(cfg)
    b = _batch(cfg)
    ref = map_tree(lambda p: p.clone().requires_grad_(), params)
    loss, _ = lm.loss_fn(ref, cfg, b)
    loss.backward()
    rules, dp = _placed(cfg, mesh, "train", params)
    for p in leaves(dp):
        p.requires_grad_()
    errors = []

    def backward():
        try:
            with implicit_replication():
                got.backward()
        except Exception as e:       # reported below, in the test's thread
            errors.append(e)
    with axis_rules(mesh, rules):
        got, _ = lm.loss_fn(dp, cfg, b)
        with axis_rules(mesh, rules):
            pass
        assert DTensor._op_dispatcher._allow_implicit_replication
        t = threading.Thread(target=backward)
        t.start()
        t.join()
    assert not errors, errors
    assert torch.equal(_full(got), loss)
    for a, b_ in zip(leaves(dp), leaves(ref)):
        assert torch.equal(_full(a.grad), b_.grad)
