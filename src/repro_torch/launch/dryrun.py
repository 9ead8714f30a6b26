"""Multi-pod dry-run: plan every (architecture x input-shape) cell on the
production mesh, prove it fits, and extract roofline inputs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m \\
        --shape long_500k --mesh 2,2,2 --device cpu

A copy of ``repro.launch.dryrun`` without XLA. The reference lowers each
step onto 512 fake XLA devices and reads the compiled program's cost and
memory analyses. The port plans on a **fake world** instead: one process,
a fake process group of ``mesh.size`` ranks (:func:`fake_world`), and
DTensors whose local blocks are fake tensors (no data) on the caller's
device (the card unless ``--device cpu`` is passed). The step runs there
as this process's rank, rank 0, would run it, under the reference's rules
(``make_rules``, ``choose_serve_mode``), and
``launch.plan_cost.PlanCounter`` counts its local flops, bytes,
collectives and live memory. Parameters, optimizer state, batches and
caches are built as rank 0's local blocks, never as global tensors.

* The FULL step (train step, prefill or decode step) is the fits gate:
  its peak live bytes per device against ``hardware.HBM_BYTES``.
  ``compile_s`` holds the seconds of this fake pass (there is no compile).
* Per-iteration costs come from PROBES, as in the reference: the layer
  body (one pattern repeat at microbatch size, remat applied), the
  embed + head + loss, and the optimizer update. Totals: train =
  R*M*layer + M*head + opt; prefill/decode = R*layer + head;
  ``hlo_flops_per_dev`` holds them. The reference needs probes because
  XLA counts a while-loop body once; the port's loops are Python loops
  that dispatch every iteration, so the full pass counts every op too
  (``full_program_cost_once``) and the probes add up to it (``scan_unroll``
  changes nothing: ``models/runtime_flags.py``).
* Compute seconds count f32 products at ``PEAK_FLOPS_F32`` (the card runs
  them outside its tensor cores) and the rest at ``PEAK_FLOPS_BF16``.

Artifacts: one JSON per cell under ``$REPRO_TORCH_DRYRUN_DIR``, else
``experiments/dryrun_torch/<mesh>/``, with the reference's keys, so that
``launch/roofline.py`` reads either package's. ``--save-hlo`` writes the
op trace (``<arch>__<shape>.ops``) in place of the HLO.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.config import SHAPES, ShapeConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.distributed import placement
from repro_torch.distributed.sharding import (NamedSharding, axis_rules,
                                              axis_sizes, block_range,
                                              contiguous_stride, make_rules,
                                              make_sharding)
from repro_torch.launch import hardware
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.plan_cost import PlanCounter
from repro_torch.models import mamba, model
from repro_torch.models.layers import rms_norm, torch_dtype
from repro_torch.serve import engine as serve_engine
from repro_torch.train import optim
from repro_torch.train.step import make_train_step

ARTIFACT_DIR = os.environ.get(
    "REPRO_TORCH_DRYRUN_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "../../../experiments/dryrun_torch"))
AXES = ("pod", "data", "model")


def get_cfg(arch: str, overrides: Optional[Dict[str, Any]] = None):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake default process group of ``n_ranks`` ranks, this process
    rank 0: collectives are shape functions and move nothing. Destroyed on
    exit. Raises ValueError where a default group exists already: the
    planner does not replace a real world."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise ValueError(
            f"a default process group already exists (backend "
            f"{dist.get_backend()!r}, {dist.get_world_size()} ranks); the "
            f"planner starts a fake world of its own and will not replace "
            f"it: plan outside the group")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def plan_mesh(dims, device):
    """A ('pod',) 'data', 'model' DeviceMesh of ``dims`` in the fake world
    (its size must be the world's)."""
    from torch.distributed.device_mesh import init_device_mesh
    dims = tuple(int(d) for d in dims)
    return init_device_mesh(resolve_device(device).type, dims,
                            mesh_dim_names=AXES[-len(dims):])


def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


# ---------------------------------------------------------------------------
# Rank 0's local blocks
# ---------------------------------------------------------------------------

def _leaf(shape, dtype, sh: NamedSharding, device):
    """A DTensor of global ``shape`` laid out by ``sh``, made from this
    rank's local block alone (uninitialised; a fake tensor under the
    planner's fake mode)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    dmesh, pls = sh.device_mesh, sh.placements
    local = tuple(block_range(dmesh, pls, d, n)[1]
                  for d, n in enumerate(shape))
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=device), dmesh, pls,
        run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))


def _build(shapes, shardings, dtype, device):
    """:func:`_leaf` over a tree of shape tuples and the matching tree of
    shardings; ``dtype`` a dtype or a function of the shape."""
    if isinstance(shardings, dict):
        return {k: _build(shapes[k], shardings[k], dtype, device)
                for k in shardings}
    if isinstance(shardings, (list, tuple)):
        return type(shardings)(_build(s, sh, dtype, device)
                               for s, sh in zip(shapes, shardings))
    dt = dtype(shapes) if callable(dtype) else dtype
    return _leaf(shapes, dt, shardings, device)


def param_specs(cfg, mesh, rules, device):
    return _build(model._expected_shapes(cfg),
                  placement.param_shardings(cfg, mesh, rules),
                  torch_dtype(cfg.param_dtype), device)


def _tok_shape(cfg, B, S):
    return (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)


def _tok_sharding(cfg, mesh, rules):
    return make_sharding(("batch", "seq") + (("codebook",)
                                             if cfg.n_codebooks > 1 else ()),
                         mesh, rules)


def input_specs(cfg, shape: ShapeConfig, mesh, device) -> Dict[str, Any]:
    """The full step of one (arch, shape) cell: the callable, its arguments
    (rank 0's blocks), its rules and whether it trains. Call under the
    planner's fake mode."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        rules = make_rules(mesh, "train", cfg)
        tc = TrainConfig(num_microbatches=shape.num_microbatches)
        params = param_specs(cfg, mesh, rules, device)
        with axis_rules(mesh, rules):
            opt = optim.init_opt_state(params)
        bsh = placement.batch_shardings(cfg, mesh, rules)
        batch = {k: _leaf(_tok_shape(cfg, B, S), torch.int32, bsh[k], device)
                 for k in ("tokens", "labels")}
        if cfg.n_prefix:
            batch["vision_embeds"] = _leaf((B, cfg.n_prefix, cfg.d_model),
                                           torch.bfloat16,
                                           bsh["vision_embeds"], device)
        return dict(fn=make_train_step(cfg, tc), args=(params, opt, batch),
                    rules=rules, tc=tc, grad=True)

    if shape.kind == "prefill":
        rules = make_rules(mesh, "prefill", cfg)
        step = serve_engine.make_prefill_step(cfg, max_seq=S + cfg.n_prefix)
        bsh = placement.batch_shardings(cfg, mesh, rules)
        args = [param_specs(cfg, mesh, rules, device),
                _leaf(_tok_shape(cfg, B, S), torch.int32, bsh["tokens"],
                      device)]
        if cfg.n_prefix:
            args.append(_leaf((B, cfg.n_prefix, cfg.d_model), torch.bfloat16,
                              bsh["vision_embeds"], device))
        return dict(fn=step, args=tuple(args), rules=rules, tc=None,
                    grad=False)

    mode = placement.choose_serve_mode(shape, mesh)
    rules = make_rules(mesh, mode, cfg)
    params = param_specs(cfg, mesh, rules, device)
    with axis_rules(mesh, rules):
        cache = model.init_cache(cfg, B, S, torch.bfloat16, device)
    tokens = _leaf(_tok_shape(cfg, B, 1), torch.int32,
                   _tok_sharding(cfg, mesh, rules), device)
    # the reference's cache_len is a traced scalar; attention reads the
    # whole cache under a mask, so the count does not depend on it
    return dict(fn=serve_engine.make_decode_step(cfg),
                args=(params, tokens, cache, S - 1), rules=rules, tc=None,
                grad=False)


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------

def _scale_coll(stats, k):
    return {kk: {"count": v["count"] * k, "bytes": v["bytes"] * k}
            for kk, v in stats.items()}


def _add_coll(*all_stats):
    out: Dict[str, Dict[str, float]] = {}
    for stats in all_stats:
        for k, v in stats.items():
            s = out.setdefault(k, {"count": 0, "bytes": 0})
            s["count"] += v["count"]
            s["bytes"] += v["bytes"]
    return out


def roofline_terms(cost: Dict[str, Any], n_ranks: int) -> Dict[str, float]:
    """Seconds per step on one card: f32 products at the f32 rate, other
    flops at the bf16 tensor-core rate; bytes at HBM's; the collectives'
    wire bytes over NVLink or, past one node, InfiniBand."""
    wire = sum(hardware.COLLECTIVE_WIRE_FACTOR[k] * v["bytes"]
               for k, v in cost["collectives"].items())
    f32 = cost.get("flops_f32", 0.0)
    return {
        "compute_s": ((cost["flops"] - f32) / hardware.PEAK_FLOPS_BF16
                      + f32 / hardware.PEAK_FLOPS_F32),
        "memory_s": cost["bytes"] / hardware.HBM_BW,
        "collective_s": wire / hardware.link_bw(n_ranks),
        "collective_wire_bytes_per_dev": wire,
    }


def _counted(fn, args, mesh, rules, grad: bool, trace: bool = False):
    """``fn(*args)`` under ``rules`` and a :class:`PlanCounter` holding
    ``args``; returns (counter, outputs)."""
    counter = PlanCounter(trace=trace)
    counter.hold(args)
    with axis_rules(mesh, rules), torch.set_grad_enabled(grad), counter:
        out = fn(*args)
    return counter, out


def _local_grads(loss, leaves_):
    """d loss / d leaves, each laid out as its leaf (the reference's
    out_shardings: the probe pays the gradient's reduction as the step
    does)."""
    grads = torch.autograd.grad(loss, leaves_)
    return [g.redistribute(p.device_mesh, p.placements)
            if hasattr(g, "redistribute") else g
            for g, p in zip(grads, leaves_)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def probe_costs(cfg, shape: ShapeConfig, mesh, rules,
                tc: Optional[TrainConfig], device) -> Dict[str, Any]:
    """The layer, head (and, training, optimizer) probes, each counted
    once, and their totals scaled as in the reference. Call under the
    planner's fake mode."""
    B, S = shape.global_batch, shape.seq_len
    M = shape.num_microbatches if shape.kind == "train" else 1
    Bm = B // M
    d = cfg.d_model
    S_act = 1 if shape.kind == "decode" else S + (cfg.n_prefix or 0)
    act = torch_dtype(cfg.dtype)
    pdt = torch_dtype(cfg.param_dtype)

    def wdtype(shp):
        """bf16_weight_gather: the layer stack sees bf16 weights."""
        if (getattr(cfg, "bf16_weight_gather", False)
                and pdt == torch.float32 and len(shp) >= 2):
            return torch.bfloat16
        return pdt

    full = model._expected_shapes(cfg)
    axes = model.param_logical_axes(cfg)

    def blocks():
        return tuple(
            {g: {n: _leaf(full["blocks"][i][g][n][1:],
                          wdtype(full["blocks"][i][g][n][1:]),
                          make_sharding(ax[1:], mesh, rules), device)
                 for n, ax in grp.items()}
             for g, grp in pos.items()}
            for i, pos in enumerate(axes["blocks"]))

    def head_params(cast: bool):
        psh = placement.param_shardings(cfg, mesh, rules)
        return {k: _leaf(full[k], wdtype(full[k]) if cast else pdt, psh[k],
                         device) for k in full if k != "blocks"}

    x_sh = make_sharding(("batch", "seq", "act_embed"), mesh, rules)
    positions = torch.arange(S_act, dtype=torch.int32,
                             device=device).expand(Bm, S_act)
    probes: Dict[str, Any] = {}

    def run(fn, args, grad):
        return _counted(fn, args, mesh, rules, grad)[0].cost()

    def head_fwd(p, h):
        return model.logits_from_hidden(
            p, cfg, rms_norm(h, p["final_norm"], cfg.norm_eps))

    if shape.kind == "train":
        def layer_grad(br, xx):
            ls = _leaves(br) + [xx]
            for t in ls:
                t.requires_grad_()
            # made under the rules: the backward's recomputation runs in
            # autograd's device thread on the card, under these rules
            layer_fn = model._remat(
                lambda b, x: model.single_repeat(b, cfg, x, positions),
                cfg.remat_policy)
            y, aux = layer_fn(br, xx)
            return _local_grads((y.float() ** 2).sum() + aux, ls)

        probes["layer"] = run(layer_grad, (blocks(), _leaf(
            (Bm, S_act, d), act, x_sh, device)), True)

        toks = _tok_sharding(cfg, mesh, rules)
        hid = _leaf((Bm, S, d), act, x_sh, device)

        def head_grad(p, tk, lb, h):
            ls = _leaves(p)
            for t in ls:
                t.requires_grad_()
            return _local_grads(
                model.head_and_embed_loss(p, cfg, tk, lb, h), ls)

        probes["head"] = run(head_grad, (
            head_params(True), _leaf(_tok_shape(cfg, Bm, S), torch.int32,
                                     toks, device),
            _leaf(_tok_shape(cfg, Bm, S), torch.int32, toks, device), hid),
            True)

        params = param_specs(cfg, mesh, rules, device)
        grads = param_specs(cfg, mesh, rules, device)
        with axis_rules(mesh, rules):
            opt = optim.init_opt_state(params)
        probes["opt"] = run(lambda p, g, o: optim.adamw_update(p, g, o, tc),
                            (params, grads, opt), False)
        scale = {"layer": cfg.n_repeats * M, "head": M, "opt": 1}

    elif shape.kind == "prefill":
        probes["layer"] = run(
            lambda br, xx: model.single_repeat(br, cfg, xx, positions)[0],
            (blocks(), _leaf((Bm, S_act, d), act, x_sh, device)), False)
        probes["head"] = run(head_fwd, (head_params(False), _leaf(
            (Bm, 1, d), act, x_sh, device)), False)
        scale = {"layer": cfg.n_repeats, "head": 1}

    else:  # decode
        cache_ax = model.cache_logical_axes(cfg)
        cache_r = []
        for (mixer, _), pos_ax in zip(cfg.layer_pattern(), cache_ax):
            if mixer == "attn":
                shp = {n: ((B, S, cfg.n_kv_heads, cfg.resolved_head_dim),
                           torch.bfloat16) for n in ("k", "v")}
            else:
                shp = {n: (tuple(t.shape), t.dtype)
                       for n, t in mamba.init_state(cfg, B, "meta").items()}
            cache_r.append({n: _leaf(s, dt, make_sharding(pos_ax[n][1:],
                                                          mesh, rules),
                                     device)
                            for n, (s, dt) in shp.items()})
        x1 = _leaf((B, 1, d), act, x_sh, device)
        probes["layer"] = run(
            lambda br, xx, cr: model.single_repeat_decode(br, cfg, xx, cr,
                                                          S - 1),
            (blocks(), x1, tuple(cache_r)), False)
        probes["head"] = run(head_fwd, (head_params(False), x1), False)
        scale = {"layer": cfg.n_repeats, "head": 1}

    total = {k: sum(probes[p][k] * scale[p] for p in probes)
             for k in ("flops", "flops_f32", "bytes")}
    total["collectives"] = _add_coll(*[
        _scale_coll(probes[p]["collectives"], scale[p]) for p in probes])
    return {"probes": probes, "scale": scale, **total}


# ---------------------------------------------------------------------------
# Per-cell dry run
# ---------------------------------------------------------------------------

def model_flops_per_dev(cfg, shape: ShapeConfig, n_chips: int) -> float:
    """The reference's useful flops: 6 (train) or 2 x active parameters x
    tokens, per device."""
    if shape.kind == "decode":
        return 2 * cfg.active_param_count() * shape.global_batch / n_chips
    tokens = shape.global_batch * shape.seq_len
    k = 6 if shape.kind == "train" else 2
    return k * cfg.active_param_count() * tokens / n_chips


def plan_cell(cfg, shape: ShapeConfig, mesh, mesh_name: str, device,
              skip_probes: bool = False, trace: bool = False
              ) -> Dict[str, Any]:
    """The artifact of one cell (the reference's keys), planned in the
    current fake world on ``mesh``; with ``trace``, the full pass's op
    trace under ``"ops"`` too."""
    dev = resolve_device(device)
    n_chips = 1
    for s in axis_sizes(mesh).values():
        n_chips *= s
    with _fake():
        t0 = time.time()
        spec = input_specs(cfg, shape, mesh, dev)
        t_lower = time.time() - t0
        counter, out = _counted(spec["fn"], spec["args"], mesh,
                                spec["rules"], spec["grad"], trace=trace)
        t_compile = time.time() - t0 - t_lower
        mem = counter.memory_analysis(out)
        full = counter.cost()
        ops = counter.trace
        del counter, out, spec["args"]
        t1 = time.time()
        if skip_probes:
            probe = {**full, "probes": {}, "scale": {}}
        else:
            probe = probe_costs(cfg, shape, mesh, spec["rules"], spec["tc"],
                                dev)
        t_probe = time.time() - t1

    mem_dict = dataclasses.asdict(mem)
    live = mem.peak_bytes
    terms = roofline_terms(probe, n_chips)
    mf = model_flops_per_dev(cfg, shape, n_chips)
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    mf_time = mf / hardware.PEAK_FLOPS_BF16
    result = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "status": "ok",
        "n_chips": n_chips,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "probe_s": round(t_probe, 2),
        "memory": mem_dict,
        "live_bytes_per_dev": live,
        "fits_hbm": bool(live <= hardware.HBM_BYTES),
        "full_program_cost_once": {"flops": full["flops"],
                                   "bytes accessed": full["bytes"]},
        "full_program_collectives_once": full["collectives"],
        "probe": probe,
        "collectives": probe["collectives"],
        "roofline": terms,
        "model_flops_per_dev": mf,
        "hlo_flops_per_dev": probe["flops"],
        "useful_flops_ratio": (mf / probe["flops"]) if probe["flops"] else None,
        "roofline_fraction": (mf_time / bound) if bound else None,
        "dominant": max(("compute_s", "memory_s", "collective_s"),
                        key=lambda k: terms[k]),
    }
    if trace:
        result["ops"] = ops
    return result


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             out_dir: str, device=None, save_hlo: bool = False,
             skip_probes: bool = False,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Plan one cell in the current fake world and write its artifact."""
    cfg = get_cfg(arch, overrides)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "skipped",
                  "reason": "pure full-attention arch; 512K dense-attention "
                            "decode excluded by design (DESIGN.md §4)"}
        _write(out_dir, arch, shape_name, result)
        return result
    result = plan_cell(cfg, shape, mesh, mesh_name, device,
                       skip_probes=skip_probes, trace=save_hlo)
    ops = result.pop("ops", None)
    if save_hlo:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape_name}.ops"),
                  "w") as f:
            f.write("\n".join(ops) + "\n")
    _write(out_dir, arch, shape_name, result)
    return result


def _write(out_dir: str, arch: str, shape_name: str, result: Dict[str, Any]):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}.json"), "w") as f:
        json.dump(result, f, indent=2)


def _parse_set(items):
    out: Dict[str, Any] = {}
    for kv in items:
        k, _, v = kv.partition("=")
        if v in ("True", "False"):
            out[k] = v == "True"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="override mesh as 'data,model' or 'pod,data,model'")
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each full pass's op trace (<cell>.ops)")
    ap.add_argument("--skip-probes", action="store_true",
                    help="full pass only (multi-pod pass)")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override, e.g. --set chunked_ce=True")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors: the card by default, "
                         "'cpu' to plan on the CPU")
    args = ap.parse_args(argv)
    # DTensor warns at every multi-step redistribution it plans
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    overrides = _parse_set(args.set)
    dev = resolve_device(args.device)

    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split(","))
        mesh_name = "x".join(map(str, dims))
    else:
        dims = (2, 16, 16) if args.multi_pod else (16, 16)
        mesh_name = "2x16x16" if args.multi_pod else "16x16"
    n_ranks = 1
    for s in dims:
        n_ranks *= s

    out_dir = args.out or os.path.join(ARTIFACT_DIR, mesh_name)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [(a, s) for a in archs for s in shapes]

    failures = 0
    with fake_world(n_ranks):
        mesh = (plan_mesh(dims, dev) if args.mesh
                else make_production_mesh(multi_pod=args.multi_pod,
                                          device=dev))
        for arch, shape_name in cells:
            try:
                r = run_cell(arch, shape_name, mesh, mesh_name, out_dir, dev,
                             save_hlo=args.save_hlo,
                             skip_probes=args.skip_probes,
                             overrides=overrides)
                if r["status"] == "ok":
                    t = r["roofline"]
                    rf = r.get("roofline_fraction")
                    print(f"[ok]   {arch:24s} {shape_name:12s} "
                          f"{mesh_name:8s} "
                          f"compile={r['compile_s']:6.1f}s "
                          f"live={r['live_bytes_per_dev']/2**30:6.2f}GiB "
                          f"fits={int(r['fits_hbm'])} "
                          f"c={t['compute_s']*1e3:9.2f}ms "
                          f"m={t['memory_s']*1e3:9.2f}ms "
                          f"coll={t['collective_s']*1e3:9.2f}ms "
                          f"dom={r['dominant'][:-2]:10s} "
                          f"roofline={rf if rf is None else round(rf, 3)}",
                          flush=True)
                else:
                    print(f"[skip] {arch:24s} {shape_name:12s} "
                          f"{r['reason']}", flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                failures += 1
                print(f"[FAIL] {arch:24s} {shape_name:12s} "
                      f"{type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
                _write(out_dir, arch, shape_name,
                       {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "status": "error",
                        "error": f"{type(e).__name__}: {e}"})
    print(f"dryrun complete: {len(cells) - failures}/{len(cells)} cells ok",
          flush=True)
    return failures


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
