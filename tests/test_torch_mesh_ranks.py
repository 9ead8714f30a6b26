"""The LM on a mesh over four gloo ranks: logical-axis sharding through
DTensor (``distributed.sharding``, ``distributed.placement``), the MoE's
expert-parallel dispatch, ``compressed_psum`` and checkpoint restore onto a
mesh, held to the port's unsharded path (and, for qwen3-4b, to the JAX
reference's single-device values).

One world of four ranks (``torch.multiprocessing.spawn``, a ``file://``
store under ``tmp_path``) runs every case once, in a module-scoped
fixture; rank 0 writes the measured differences to a JSON file and the
tests read it. Meshes (2, 2), (1, 4) and the pod mesh (2, 1, 2), each a
``DeviceMesh`` of the same world. The bars:

* forward logits and the loss within 1e-5 of max(1, the largest unsharded
  value); gradients per leaf within 1e-3 of max(1, the leaf's largest
  unsharded value), the reference's bar for its expert-parallel test;
  f32 greedy tokens and the MoE's expert choices equal;
* ``_apply_shard_map`` against ``_apply_gspmd`` on (2, 2) (qwen3-moe, 8
  experts over 2) and on (1, 4) (6 experts padded to 8, with shared
  experts): outputs within 1e-4, gradients within 1e-3 of max(1, m);
* ``compressed_psum`` over 2 and 4 ranks bitwise a numpy oracle;
* a checkpoint written unsharded and one written on (4, 1) restored onto
  (1, 4) and (2, 1, 2): every local block bitwise its slice;
* two training steps (``make_train_step``) on (2, 2) and (2, 1, 2), where
  parameters, gradients and moments are split: the loss, the global
  gradient norm and the updated parameters within 1e-5 of max(1, the
  largest unsharded value), both moments within 1e-3;
* greedy decode at B=1, where ``choose_serve_mode`` picks 'serve_seq'
  (the cache's sequence dim split over the ranks): f32 tokens equal; the
  expert-parallel MoE raises there on every rank, as the reference's
  ``shard_map`` does (it splits the batch over the data axes);
* ``FaultTolerantRunner(shardings=)`` with its default asynchronous save:
  a crash on (2, 2) restored there, then the run resumed on (1, 4), the
  losses within 1e-5 of an uninterrupted unsharded run;
* a dim split over ('pod', 'data') holds its blocks pod-major, the
  reference's order.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, reduced

torch.set_num_threads(1)

WORLD = 4
MESHES = [(2, 2), (1, 4), (2, 1, 2)]
ARCHS = [("qwen3-4b", "gspmd"), ("qwen2-moe-a2.7b", "gspmd"),
         ("qwen2-moe-a2.7b", "shard_map"), ("mamba2-780m", "gspmd"),
         ("jamba-1.5-large-398b", "gspmd")]
B, S, PROMPT, GEN = 4, 16, 8, 4
FWD_BAR, GRAD_BAR = 1e-5, 1e-3
HANG_S = 400


def _cfg(arch, impl):
    """The reduced config. Under ``shard_map`` the router's aux loss is
    each data shard's, averaged (the reference's EP path), not the global
    batch's, so the loss compared there is the cross-entropy alone."""
    cfg = dataclasses.replace(reduced(get_config(arch)), moe_impl=impl,
                              capacity_factor=16.0, remat_policy="none")
    if impl == "shard_map":
        cfg = dataclasses.replace(cfg, router_aux_coef=0.0)
    return cfg


def _mesh(shape):
    from repro_torch.launch.mesh import make_host_mesh
    if len(shape) == 3:
        return make_host_mesh(data=shape[1], model=shape[2], pod=shape[0],
                              device="cpu")
    return make_host_mesh(*shape, device="cpu")


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rel(got, want):
    got, want = _full(got).detach().float(), want.detach().float()
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def _inputs(cfg):
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


def _expert_choices(fn):
    """Run ``fn`` while recording every ``moe.route``'s expert choices (as
    full tensors; under the EP path each rank's local rows)."""
    from repro_torch.models import moe
    seen, route = [], moe.route

    def rec(x2d, w, cfg):
        out = route(x2d, w, cfg)
        seen.append(_full(out[1]).clone())
        return out
    moe.route = rec
    try:
        fn()
    finally:
        moe.route = route
    return seen


def _unsharded(cfg, params, batch):
    from repro_torch.models import model as lm
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train.tree import leaves, map_tree
    tree = map_tree(lambda p: p.clone().requires_grad_(), params)
    ps = leaves(tree)
    idx = _expert_choices(lambda: lm.forward(tree, cfg, batch["tokens"]))
    logits, _ = lm.forward(tree, cfg, batch["tokens"])
    loss, _ = lm.loss_fn(tree, cfg, batch)
    loss.backward()
    toks = ServingEngine(cfg, params, PROMPT + GEN + 1).generate(
        batch["tokens"][:, :PROMPT], GEN)
    return dict(logits=logits.detach(), loss=loss.detach(),
                grads=[p.grad for p in ps], tokens=toks, idx=idx)


def _lm_case(mesh, cfg, params, batch, want):
    """The mesh's numbers for one architecture against ``want``."""
    from repro_torch.distributed import placement
    from repro_torch.distributed.sharding import axis_rules, make_rules
    from repro_torch.models import model as lm
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train.tree import leaves
    rules = make_rules(mesh, "train", cfg)
    psh = placement.param_shardings(cfg, mesh, rules)
    bsh = placement.batch_shardings(cfg, mesh, rules)
    out = {}
    with axis_rules(mesh, rules):
        dp = placement.place_tree(params, psh)
        for p in leaves(dp):
            p.requires_grad_()
        db = placement.place_tree(batch, {k: bsh[k] for k in batch})
        idx = _expert_choices(lambda: lm.forward(dp, cfg, db["tokens"]))
        logits, _ = lm.forward(dp, cfg, db["tokens"])
        loss, _ = lm.loss_fn(dp, cfg, db)
        loss.backward()
        out["logits"] = _rel(logits, want["logits"])
        out["loss"] = _rel(loss, want["loss"])
        out["grads"] = max(_rel(p.grad, g) for p, g in
                           zip(leaves(dp), want["grads"]))
    if cfg.moe_impl == "shard_map":
        # each rank routed its own rows: compare them with the unsharded
        # rows of its batch block, and count the ranks that agree
        lo, n = _batch_block(mesh)
        ok = all(torch.equal(got, w.reshape(B, S, -1)[lo:lo + n].reshape(
            -1, w.shape[-1])) for got, w in zip(idx, want["idx"]))
    else:
        ok = all(torch.equal(got, w) for got, w in zip(idx, want["idx"]))
    flag = torch.tensor([int(ok and len(idx) == len(want["idx"]))])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    out["expert_idx_equal"] = bool(flag.item())
    mode = placement.choose_serve_mode(
        ShapeConfig("mesh", "decode", PROMPT + GEN + 1, B), mesh)
    srules = make_rules(mesh, mode, cfg)
    with axis_rules(mesh, srules):
        sp = placement.place_tree(params, placement.param_shardings(
            cfg, mesh, srules))
        t = placement.place_tree(
            {"t": batch["tokens"][:, :PROMPT]},
            {"t": placement.batch_shardings(cfg, mesh, srules)["tokens"]}
        )["t"]
        got = _full(ServingEngine(cfg, sp, PROMPT + GEN + 1).generate(t, GEN))
    out["tokens_equal"] = bool(torch.equal(got, want["tokens"]))
    out["serve_mode"] = mode
    return out


TRAIN_CASES = [((2, 2), "qwen3-4b", True), ((2, 2), "qwen2-moe-a2.7b", False),
               ((2, 1, 2), "qwen3-4b", True),
               ((2, 1, 2), "qwen2-moe-a2.7b", False)]
TRAIN_STEPS = 2


def _train_cfg(arch, chunked):
    return dataclasses.replace(_cfg(arch, "gspmd"), chunked_ce=chunked)


def _tc(**kw):
    from repro_torch.config import TrainConfig
    return TrainConfig(warmup_steps=1, learning_rate=3e-4, **kw)


def _train_steps(cfg, params, mesh=None):
    """(per-step metrics, params, mu, nu) after ``TRAIN_STEPS`` steps of
    ``make_train_step``; on ``mesh`` under its 'train' rules, with the
    parameters and moments placed by ``param_shardings``/``opt_shardings``
    and each step's batch by ``batch_shardings``."""
    from repro_torch.distributed import placement
    from repro_torch.distributed.sharding import axis_rules, make_rules
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import map_tree
    p = map_tree(torch.clone, params)
    o = optim.init_opt_state(p)
    rules = make_rules(mesh, "train", cfg) if mesh is not None else None
    if mesh is not None:
        psh = placement.param_shardings(cfg, mesh, rules)
        p, o = placement.place_tree((p, o),
                                    (psh, placement.opt_shardings(psh, mesh)))
        bsh = placement.batch_shardings(cfg, mesh, rules)
    step = make_train_step(cfg, _tc())
    metrics = []
    with axis_rules(mesh, rules):
        for i in range(TRAIN_STEPS):
            g = torch.Generator().manual_seed(10 + i)
            toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
            b = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
            if mesh is not None:
                b = placement.place_tree(b, {k: bsh[k] for k in b})
            p, o, m = step(p, o, b)
            metrics.append({k: _full(m[k]).detach().clone()
                            for k in ("loss", "grad_norm")})
    return metrics, p, o.mu, o.nu


def _train_case(mesh, cfg, params, want):
    """The mesh's training steps against the unsharded ones (``want``,
    from :func:`_train_steps`): the worst relative differences."""
    from repro_torch.train.tree import leaves
    got = _train_steps(cfg, params, mesh)
    out = {k: max(_rel(g[k], w[k]) for g, w in zip(got[0], want[0]))
           for k in ("loss", "grad_norm")}
    for name, i in (("params", 1), ("mu", 2), ("nu", 3)):
        out[name] = max(_rel(a, b) for a, b in
                        zip(leaves(got[i]), leaves(want[i])))
    split = [any(type(pl).__name__ == "Shard" for pl in t.placements)
             for t in leaves(got[1])]
    out["split_leaves"] = sum(split)
    return out


def _serve_seq_case(mesh, cfg, params, prompt, want):
    """Greedy f32 tokens at B=1 under the rules ``choose_serve_mode``
    picks (``'serve_seq'`` where the batch does not split over the data
    axes), against the unsharded tokens ``want``."""
    from repro_torch.distributed import placement
    from repro_torch.distributed.sharding import axis_rules, make_rules
    from repro_torch.models import model as lm
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train.tree import leaves
    mode = placement.choose_serve_mode(
        ShapeConfig("mesh", "decode", PROMPT + GEN + 1, 1), mesh)
    rules = make_rules(mesh, mode, cfg)
    with axis_rules(mesh, rules), torch.no_grad():
        sp = placement.place_tree(params, placement.param_shardings(
            cfg, mesh, rules))
        try:
            got = _full(ServingEngine(cfg, sp, PROMPT + GEN + 1).generate(
                prompt, GEN))
        except ValueError as e:
            return {"mode": mode, "raised": str(e)}
        _, cache = lm.prefill(sp, cfg, prompt, PROMPT + GEN + 1)
        split = any(any(type(pl).__name__ == "Shard" for pl in t.placements)
                    for t in leaves(cache) if hasattr(t, "placements"))
    return {"mode": mode, "tokens_equal": bool(torch.equal(got, want)),
            "cache_split": split}


def _runner_case(out_dir):
    """``FaultTolerantRunner(shardings=)`` with the default asynchronous
    save, every rank in one checkpoint directory (rank 0 writes): an
    uninterrupted unsharded run of 8 steps; a run on (2, 2) through a
    crash at step 3 (restored from step 2) to step 6; then a runner on
    (1, 4) resuming from that step-6 checkpoint to step 8. Returns the
    worst loss difference, the recoveries and the resumed start."""
    from repro_torch.distributed import placement
    from repro_torch.distributed.fault import FaultPlan, FaultTolerantRunner
    from repro_torch.distributed.sharding import axis_rules, make_rules
    cfg = _cfg("qwen3-4b", "gspmd")

    def run(d, total, mesh=None, plan=None):
        tc = _tc(checkpoint_dir=d, checkpoint_every=2, total_steps=8)
        rules = sh = None
        if mesh is not None:
            rules = make_rules(mesh, "train", cfg)
            psh = placement.param_shardings(cfg, mesh, rules)
            sh = (psh, placement.opt_shardings(psh, mesh))
        with axis_rules(mesh, rules):
            r = FaultTolerantRunner(cfg, tc, batch=B, seq_len=S,
                                    fault_plan=plan, shardings=sh,
                                    device="cpu")
            start = r.init_or_restore()[2]
            return r.run(total), start
    ref, _ = run(os.path.join(out_dir, "run_ref"), 8)
    d = os.path.join(out_dir, "run_mesh")
    crashed, _ = run(d, 6, _mesh((2, 2)), FaultPlan({3: "node"}))
    resumed, start = run(d, 8, _mesh((1, 4)))
    got = crashed["losses"] + resumed["losses"]
    err = float(np.abs(np.subtract(got, ref["losses"])).max()) \
        if len(got) == len(ref["losses"]) else float("inf")
    return {"loss_err": err, "recoveries": crashed["recoveries"],
            "resumed_at": start, "steps": len(got)}


def _batch_block(mesh):
    """(start, rows) of this rank's batch block under 'train' rules."""
    from repro_torch.distributed.sharding import NamedSharding, P, block_range
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    sh = NamedSharding(mesh, P(dp if len(dp) > 1 else dp[0], None))
    return block_range(sh.device_mesh, sh.placements, 0, B)


def _ep_case(mesh, arch, extra):
    """``_apply_shard_map`` (through ``moe.apply``) against
    ``_apply_gspmd`` on one MoE layer: (output difference, worst gradient
    difference relative to max(1, m))."""
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  axis_rules, make_rules,
                                                  place)
    from repro_torch.models import model as lm
    from repro_torch.models import moe
    cfg = dataclasses.replace(_cfg(arch, "gspmd"), **extra)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    blk = {n: w[0] for n, w in params["blocks"][0]["mlp"].items()}
    x = torch.randn((4, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    ref = {k: v.clone().requires_grad_() for k, v in blk.items()}
    y_ref, _ = moe._apply_gspmd(ref, cfg, x)
    (y_ref ** 2).sum().backward()
    specs = {"router": P("data", None), "wi": P("model", "data", None),
             "wo": P("model", None, "data")}
    rules = make_rules(mesh, "train", cfg)
    sm = dataclasses.replace(cfg, moe_impl="shard_map")
    with axis_rules(mesh, rules):
        ps = {k: place(v, NamedSharding(mesh, specs.get(k, P(None, None))))
              .requires_grad_() for k, v in blk.items()}
        xs = place(x, NamedSharding(mesh, P("data", None, None)))
        y, _ = moe.apply(ps, sm, xs)
        (y ** 2).sum().backward()
    out_err = float((_full(y) - y_ref).abs().max())
    grad_err = max(float((_full(ps[k].grad) - ref[k].grad).abs().max())
                   / max(1.0, float(ref[k].grad.abs().max())) for k in blk)
    return out_err, grad_err


def _psum_case(mesh, axis):
    """``compressed_psum`` of each rank's own vector over ``axis`` against
    the numpy oracle over the ranks of its group."""
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed import compression
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  import_shard_map)

    def vec(r):
        return torch.randn(257, generator=torch.Generator().manual_seed(
            100 + r)) * (r + 1)
    me = dist.get_rank()
    x = vec(me)
    local_map, kw = import_shard_map()
    dmesh = NamedSharding(mesh, P()).device_mesh
    got = local_map(lambda v: compression.compressed_psum(v, axis, mesh),
                    out_placements=[Replicate()],
                    in_placements=([Replicate()],), device_mesh=dmesh,
                    **kw)(x)
    group = dist.get_process_group_ranks(mesh.get_group(axis))
    xs = [vec(r).numpy() for r in group]
    scale = max(np.float32(np.abs(v).max()) / np.float32(127.0)
                + np.float32(1e-12) for v in xs)
    q = sum(np.clip(np.round(v / scale), -127, 127).astype(np.int32)
            for v in xs)
    want = q.astype(np.float32) * scale
    ok = np.array_equal(got.numpy(), want)
    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item()), len(group)


def _restore_case(out_dir):
    """A (2-leaf params, opt state) tree written unsharded, and one written
    from (4, 1) DTensors, restored onto (1, 4) and (2, 1, 2): each rank's
    blocks bitwise its slices of the saved arrays."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.distributed import placement
    from repro_torch.distributed.sharding import axis_rules, make_rules
    from repro_torch.models import model as lm
    from repro_torch.train import optim
    from repro_torch.train.tree import leaves
    cfg = _cfg("qwen3-4b", "gspmd")
    params = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tree = (params, optim.init_opt_state(params))
    for p in leaves(tree[1].mu):
        p.normal_(generator=torch.Generator().manual_seed(4))
    results = []
    d = os.path.join(out_dir, "ckpt")
    writer = _mesh((4, 1))
    wrules = make_rules(writer, "train", cfg)
    wsh = placement.param_shardings(cfg, writer, wrules)
    placed = placement.place_tree(tree, (wsh, placement.opt_shardings(
        wsh, writer)))
    for step, t in ((1, tree), (2, placed)):
        mgr = CheckpointManager(f"{d}_{step}", async_save=False)
        mgr.save(step, t)                     # every rank; rank 0 writes
        for shape in ((1, 4), (2, 1, 2)):
            mesh = _mesh(shape)
            rules = make_rules(mesh, "train", cfg)
            psh = placement.param_shardings(cfg, mesh, rules)
            sh = (psh, placement.opt_shardings(psh, mesh))
            with axis_rules(mesh, rules):
                back, _ = mgr.restore(tree, step, shardings=sh)
            ok = True
            for b, w, s in zip(leaves(back), leaves(tree), leaves(sh)):
                ok &= torch.equal(b.to_local(), s.local_block(w))
                ok &= tuple(b.placements) == s.placements
            flag = torch.tensor([int(ok)])
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            results.append((step, shape, bool(flag.item())))
        dist.barrier()
    return results


def _block_order_case():
    """A (4, 6) array split over ('pod', 'data') on the (2, 2, 1) pod mesh:
    the rank at (pod p, data q) holds rows block 2p + q, as JAX's
    NamedSharding lays out P(('pod', 'data'))."""
    from repro_torch.distributed.sharding import NamedSharding, P, place
    mesh = _mesh((2, 2, 1))
    x = torch.arange(24.).reshape(4, 6)
    t = place(x, NamedSharding(mesh, P(("pod", "data"), None)))
    p, q = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
    ok = torch.equal(t.to_local(), x[2 * p + q:2 * p + q + 1]) and \
        torch.equal(t.full_tensor(), x)
    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _rank_main(rank, world, store, out_dir):
    import faulthandler
    # a rank stuck in a collective ends the world, with its stack, before
    # the suite's limit
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.models import model as lm
        from repro_torch.models.model import params_to_numpy
        from repro_torch.serve.engine import ServingEngine
        res = {"lm": {}, "ep": {}, "psum": [], "restore": None}
        wants = {}
        for arch, impl in ARCHS:
            cfg = _cfg(arch, impl)
            params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
            batch = _inputs(cfg)
            wants[(arch, impl)] = (cfg, params, batch,
                                   _unsharded(cfg, params, batch))
            if rank == 0 and arch == "qwen3-4b":
                np.savez(os.path.join(out_dir, "qwen3_params.npz"),
                         **{k: v for k, v in _flat_numpy(
                             params_to_numpy(params)).items()})
        import time
        t0 = time.time()
        for shape in MESHES:
            mesh = _mesh(shape)
            for arch, impl in ARCHS:
                cfg, params, batch, want = wants[(arch, impl)]
                r = _lm_case(mesh, cfg, params, batch, want)
                res["lm"][f"{shape}|{arch}|{impl}"] = r
                if shape == (2, 2) and arch == "qwen3-4b":
                    lg = _mesh_logits(mesh, cfg, params, batch)
                    if rank == 0:
                        np.save(os.path.join(out_dir,
                                             "qwen3_mesh_logits.npy"), lg)
        res["seconds_lm"] = time.time() - t0
        res["train"], res["serve_seq"] = {}, {}
        for shape, arch, chunked in TRAIN_CASES:
            cfg = _train_cfg(arch, chunked)
            params = wants[(arch, "gspmd")][1]
            key = (arch, chunked)
            if key not in wants:
                wants[key] = _train_steps(cfg, params)
            res["train"][f"{shape}|{arch}"] = _train_case(
                _mesh(shape), cfg, params, wants[key])
        for arch, impl in ARCHS:
            cfg, params, batch, _ = wants[(arch, impl)]
            prompt = batch["tokens"][:1, :PROMPT]
            want = ServingEngine(cfg, params, PROMPT + GEN + 1).generate(
                prompt, GEN)
            for shape in ((2, 2), (2, 1, 2)):
                res["serve_seq"][f"{shape}|{arch}|{impl}"] = _serve_seq_case(
                    _mesh(shape), cfg, params, prompt, want)
        res["runner"] = _runner_case(out_dir)
        res["seconds_train_serve_runner"] = time.time() - t0
        res["ep"]["(2, 2)"] = _ep_case(_mesh((2, 2)), "qwen3-moe-235b-a22b",
                                       {})
        res["ep"]["(1, 4)"] = _ep_case(_mesh((1, 4)), "qwen2-moe-a2.7b",
                                       dict(n_experts=6, moe_top_k=2))
        res["psum"] = [_psum_case(_mesh((2, 2)), "data"),
                       _psum_case(_mesh((1, 4)), "model")]
        res["restore"] = _restore_case(out_dir)
        res["block_order"] = _block_order_case()
        res["seconds"] = time.time() - t0
        if rank == 0:
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(res, f, default=str)
    finally:
        dist.destroy_process_group()


def _mesh_logits(mesh, cfg, params, batch):
    from repro_torch.distributed import placement
    from repro_torch.distributed.sharding import axis_rules, make_rules
    from repro_torch.models import model as lm
    rules = make_rules(mesh, "train", cfg)
    with axis_rules(mesh, rules), torch.no_grad():
        dp = placement.place_tree(
            params, placement.param_shardings(cfg, mesh, rules))
        lg, _ = lm.forward(dp, cfg, batch["tokens"])
        return _full(lg).numpy()


def _flat_numpy(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in
                _flat_numpy(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, t in enumerate(tree) for k2, v2 in
                _flat_numpy(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh4")
    mp.spawn(_rank_main, args=(WORLD, str(out / "store"), str(out)),
             nprocs=WORLD, join=True)
    with open(out / "results.json") as f:
        return json.load(f), out


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch,impl", ARCHS, ids=lambda v: str(v))
def test_lm_on_a_mesh_matches_the_unsharded_port(four_ranks, shape, arch,
                                                 impl):
    r = four_ranks[0]["lm"][f"{tuple(shape)}|{arch}|{impl}"]
    assert r["logits"] <= FWD_BAR, r
    assert r["loss"] <= FWD_BAR, r
    assert r["grads"] <= GRAD_BAR, r
    assert r["tokens_equal"], r
    assert r["expert_idx_equal"], r


def test_mesh_logits_match_the_reference(four_ranks):
    """qwen3-4b reduced on (2, 2) against the JAX reference's
    single-device forward on the same parameters."""
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get, reduced as ref_reduced
    from repro.models import model as ref_model
    from repro_torch.models import model as lm
    out = four_ranks[1]
    cfg = _cfg("qwen3-4b", "gspmd")
    flat = dict(np.load(out / "qwen3_params.npz"))
    tmpl = lm.params_to_numpy(lm.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    tree = _rebuild_numpy(tmpl, flat, "")
    ref_cfg = dataclasses.replace(ref_reduced(ref_get("qwen3-4b")),
                                  capacity_factor=16.0, remat_policy="none")
    toks = _inputs(cfg)["tokens"].numpy()
    want, _ = ref_model.forward(tree, ref_cfg, jnp.asarray(toks))
    got = np.load(out / "qwen3_mesh_logits.npy")
    want = np.asarray(want)
    assert np.abs(got - want).max() <= FWD_BAR * max(1.0, np.abs(want).max())


def _rebuild_numpy(tmpl, flat, prefix):
    if isinstance(tmpl, dict):
        return {k: _rebuild_numpy(v, flat, f"{prefix}/{k}")
                for k, v in tmpl.items()}
    if isinstance(tmpl, (list, tuple)):
        return [_rebuild_numpy(v, flat, f"{prefix}/{i}")
                for i, v in enumerate(tmpl)]
    return flat[prefix]


@pytest.mark.parametrize("shape", ["(2, 2)", "(1, 4)"])
def test_expert_parallel_matches_gspmd(four_ranks, shape):
    out_err, grad_err = four_ranks[0]["ep"][shape]
    assert out_err < 1e-4, out_err
    assert grad_err < 1e-3, grad_err


def test_compressed_psum_over_two_and_four_ranks(four_ranks):
    res = four_ranks[0]["psum"]
    assert res == [[True, 2], [True, 4]], res


def test_restore_onto_another_mesh_keeps_each_block(four_ranks):
    res = four_ranks[0]["restore"]
    assert len(res) == 4 and all(ok for _, _, ok in res), res


def test_pod_data_blocks_are_pod_major(four_ranks):
    assert four_ranks[0]["block_order"] is True


@pytest.mark.parametrize("shape,arch,chunked", TRAIN_CASES, ids=str)
def test_train_steps_on_a_split_mesh_match_the_unsharded_steps(
        four_ranks, shape, arch, chunked):
    r = four_ranks[0]["train"][f"{tuple(shape)}|{arch}"]
    assert r["split_leaves"] > 0, r
    assert r["loss"] <= FWD_BAR and r["grad_norm"] <= FWD_BAR, r
    assert r["params"] <= FWD_BAR, r
    assert r["mu"] <= GRAD_BAR and r["nu"] <= GRAD_BAR, r


@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2)], ids=str)
@pytest.mark.parametrize("arch,impl", ARCHS, ids=lambda v: str(v))
def test_serve_seq_decode_matches_the_unsharded_tokens(four_ranks, shape,
                                                       arch, impl):
    r = four_ranks[0]["serve_seq"][f"{tuple(shape)}|{arch}|{impl}"]
    assert r["mode"] == "serve_seq", r
    if impl == "shard_map":
        assert "does not divide" in r["raised"], r
    else:
        assert r["tokens_equal"], r


def test_serve_seq_splits_the_attention_cache(four_ranks):
    seen = four_ranks[0]["serve_seq"]
    assert all(seen[f"{s}|qwen3-4b|gspmd"]["cache_split"]
               for s in ((2, 2), (2, 1, 2))), seen


def test_runner_restores_through_a_crash_and_onto_another_mesh(four_ranks):
    r = four_ranks[0]["runner"]
    assert r["recoveries"] == [3] and r["resumed_at"] == 6, r
    assert r["steps"] == 8 and r["loss_err"] <= 1e-5, r
