"""Mixture-of-Experts with sort-based dispatch (no (T, E, C) one-hot tensors).

A copy of ``repro.models.moe`` in PyTorch:

  router logits -> top-k -> flatten (T*k assignments) -> stable sort by expert
  -> position-within-expert -> drop beyond capacity -> scatter into per-expert
  buffers (E, C, d) -> batched expert matmuls -> gather back, weighted combine.

Shared experts (qwen2-moe) are a fused always-on SwiGLU with hidden
n_shared * shared_d_ff.

:func:`apply` dispatches as the reference does: under an active mesh with
a 'model' axis and ``cfg.moe_impl == "shard_map"`` to the explicit
expert-parallel path (:func:`_apply_shard_map`, in ``local_map``), else to
:func:`_apply_gspmd` (DTensor places it from the reference's constraints;
without a mesh it is the single-device path).

Three places where a plain translation would not give the reference's
numbers, and what this copy does instead:
  * top-k: ``jax.lax.top_k`` puts the lower index first among equal
    values; ``torch.topk`` promises nothing about ties, so the k largest are
    the first k of a stable descending sort;
  * the combine: the reference's scatter-add sums each token's k
    contributions in sorted-slot order (ascending expert id) from 0.0; here
    each token's slots are gathered in that order and added left to right,
    with no float atomics, so a run on the card is deterministic;
  * the router's product stays f32 (its top-k depends on it): keep TF32
    off for ``torch.matmul`` on the card, PyTorch's default.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models.layers import ParamDef, swiglu


def param_defs(cfg) -> Dict[str, ParamDef]:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        "router": ParamDef((d, e), ("embed", None), scale=0.02),
        "wi": ParamDef((e, d, 2 * ff), ("expert", "embed", "expert_ff")),
        "wo": ParamDef((e, ff, d), ("expert", "expert_ff", "embed")),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * cfg.shared_d_ff
        defs["shared_wi"] = ParamDef((d, 2 * sff), ("embed", "ff"))
        defs["shared_wo"] = ParamDef((sff, d), ("ff", "embed"))
        defs["shared_gate"] = ParamDef((d, 1), ("embed", None), scale=0.02)
    return defs


def capacity(n_tokens: int, cfg) -> int:
    per_expert = (n_tokens * cfg.moe_top_k) / cfg.n_experts
    cap = int(per_expert * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)   # round up to 8, floor 8


def route(x2d: torch.Tensor, router_w: torch.Tensor, cfg
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (weights (T,k), expert_idx (T,k) int32, aux_loss scalar)."""
    T = x2d.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, expert_idx = vals[:, :k], idx[:, :k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balancing loss: E * sum_e f_e * p_e. The fraction is
    # one constant added T*k times, as the reference adds it (equal addends
    # give the same sum in any order, so the card's atomics do too); on
    # whole tensors under a mesh (index_add_ has no DTensor strategy in
    # torch 2.11)
    dispatch_frac = sharding.on_whole(
        lambda f: torch.zeros((e,), dtype=torch.float32,
                              device=f.device).index_add_(
            0, f, torch.full_like(f, 1.0 / (T * k), dtype=torch.float32)),
        expert_idx.reshape(-1))
    prob_frac = probs.mean(dim=0)
    aux = e * (dispatch_frac * prob_frac).sum()
    return weights, expert_idx.to(torch.int32), aux


def _shared_experts(params, cfg, x2d: torch.Tensor) -> torch.Tensor:
    """(T, d) -> (T, d): the always-on SwiGLU, gated by a sigmoid of an f32
    product."""
    sh = swiglu(x2d @ params["shared_wi"].to(x2d.dtype))
    sh = sh @ params["shared_wo"].to(x2d.dtype)
    gate = torch.sigmoid(x2d.float() @ params["shared_gate"].float())
    return sh * gate.to(x2d.dtype)


def dispatch(expert_idx: torch.Tensor, n_tokens: int, cfg
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sort-based dispatch plan of (T, K) expert choices, each a
    (T*K,) tensor in sorted-slot order: ``sort_idx`` (the flat assignment
    in each slot: a stable sort by expert), ``slot`` (its row of the
    (E*C + 1, d) buffer; E*C, the scratch row, where dropped) and ``keep``
    (within its expert's capacity C)."""
    E, C = cfg.n_experts, capacity(n_tokens, cfg)
    flat_e = expert_idx.reshape(-1).long()                 # (T*K,)
    sort_idx = torch.argsort(flat_e, stable=True)          # (T*K,)
    sorted_e = flat_e[sort_idx]
    # (bincount would read the largest id back to the host first)
    counts = flat_e.new_zeros((E,)).index_add_(0, flat_e,
                                               torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts              # exclusive prefix
    pos_in_e = (torch.arange(flat_e.numel(), device=flat_e.device)
                - starts[sorted_e])
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return sort_idx, slot, keep


def apply(params, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss). Dispatches to the explicit
    expert-parallel implementation when configured and applicable."""
    if cfg.moe_impl == "shard_map":
        mesh, rules = sharding._current()
        if mesh is not None and "model" in sharding.axis_names(mesh):
            # Non-divisible expert counts (qwen2-moe: 60 over 16 shards) pad
            # to the next multiple inside _apply_shard_map; the router never
            # selects padded experts. Shared experts are a plain dense MLP,
            # so they run on the DTensor path and add outside the region.
            y, aux = _apply_shard_map(params, cfg, x, mesh, rules)
            if cfg.n_shared_experts:
                B, S, d = x.shape
                y = y + _shared_experts(params, cfg, x.reshape(B * S, d)
                                        ).reshape(B, S, d)
            return y, aux
    return _apply_gspmd(params, cfg, x)


def _ordered_combine(y_slots: torch.Tensor, sort_idx: torch.Tensor,
                     T: int, K: int) -> torch.Tensor:
    """(T, d) f32: each token's K slots in sorted-slot order (ascending
    expert id), summed left to right from 0.0 as the reference's
    scatter-add sums them; no float atomics."""
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(T * K, device=sort_idx.device)
    order = inv.reshape(T, K).sort(dim=1).values
    y = y_slots.new_zeros((T, y_slots.shape[1]), dtype=torch.float32)
    for j in range(K):
        y = y + y_slots[order[:, j]]
    return y


def _apply_gspmd(params, cfg, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss). Under a mesh every tensor
    is a DTensor; the dispatch plan, the scatter into the buffers and the
    gathers of the combine run on replicated operands."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.moe_top_k
    x2d = logical_constraint(x.reshape(T, d), "tokens", None)

    weights, expert_idx, aux = route(x2d, params["router"], cfg)
    C = capacity(T, cfg)

    # the plan, the scatter into the buffer and the gathers of the combine
    # run on whole tensors (sharding.on_whole): DTensor would apply global
    # slot indices to a split operand's local block, and torch 2.11 has
    # no DTensor strategy for the plan's index_add_
    sort_idx, slot, keep = sharding.on_whole(
        lambda e: dispatch(e, T, cfg), expert_idx, n_out=3)

    def scatter(x2, sort_idx, slot, keep):
        rows = x2[sort_idx // K].masked_fill(~keep[:, None], 0)
        return x2.new_zeros((E * C + 1, d)).index_put((slot,), rows)
    buf = sharding.on_whole(scatter, x2d, sort_idx, slot, keep)
    buf = logical_constraint(buf[:E * C].reshape(E, C, d),
                             "expert", None, None)

    # ---- expert compute (batched over E) ----
    h = torch.bmm(buf, params["wi"].to(x.dtype))
    h = logical_constraint(h, "expert", None, "expert_ff")
    h = swiglu(h)
    out_buf = torch.bmm(h, params["wo"].to(x.dtype))
    out_buf = logical_constraint(out_buf, "expert", None, None)

    # ---- combine ----
    # replicated before the gather and the combine, as the reference
    # replicates it
    def combine(out_buf, weights, sort_idx, slot, keep):
        flat_out = torch.cat([out_buf.reshape(E * C, d),
                              out_buf.new_zeros((1, d))])
        w_sorted = weights.reshape(-1)[sort_idx]
        y_slots = (flat_out[slot] * (w_sorted * keep)[:, None].to(x.dtype)
                   ).float()
        return _ordered_combine(y_slots, sort_idx, T, K)
    y = sharding.on_whole(combine, out_buf, weights, sort_idx, slot, keep)
    y = logical_constraint(y.to(x.dtype), "tokens", None)

    if cfg.n_shared_experts:
        y = y + _shared_experts(params, cfg, x2d)

    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Explicit expert-parallel dispatch (the reference's shard_map path).
#
# Activations are replicated over 'model', so every model shard already
# holds all tokens of its data shard: each shard dispatches *only to its
# local experts*, and the partial outputs combine with one all_reduce of
# (T_loc, d) over 'model' a layer. FSDP's weight all-gathers over the data
# axes are the redistribution into the region (after the cast to the
# activation dtype, which halves their bytes in bf16).
# ---------------------------------------------------------------------------


def _local_dispatch(x2d, weights, expert_idx, keep_mask, wi, wo, e_lo: int,
                    E_loc: int, C: int, dtype) -> torch.Tensor:
    """Dense sort-based dispatch restricted to experts [e_lo, e_lo + E_loc);
    (T, d) f32 partial outputs. With every expert local it is
    :func:`_apply_gspmd`'s dispatch and combine, bit for bit."""
    T, d = x2d.shape
    K = expert_idx.shape[-1]
    flat_e = expert_idx.reshape(-1).long()
    mine = (flat_e >= e_lo) & (flat_e < e_lo + E_loc) & keep_mask.reshape(-1)
    local_e = torch.where(mine, flat_e - e_lo,
                          torch.full_like(flat_e, E_loc))  # E_loc = dropped
    sort_idx = torch.argsort(local_e, stable=True)
    sorted_e = local_e[sort_idx]
    token_of = sort_idx // K
    w_sorted = weights.reshape(-1)[sort_idx]

    counts = local_e.new_zeros((E_loc + 1,)).index_add_(
        0, local_e, torch.ones_like(local_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = (torch.arange(T * K, device=flat_e.device)
                - starts[sorted_e])
    keep = (sorted_e < E_loc) & (pos_in_e < C)
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E_loc * C))

    rows = x2d[token_of].masked_fill(~keep[:, None], 0).to(dtype)
    buf = x2d.new_zeros((E_loc * C + 1, d), dtype=dtype).index_put(
        (slot,), rows)
    buf = buf[:E_loc * C].reshape(E_loc, C, d)

    h = swiglu(torch.bmm(buf, wi.to(dtype)))
    out_buf = torch.bmm(h, wo.to(dtype))

    flat_out = torch.cat([out_buf.reshape(E_loc * C, d),
                          out_buf.new_zeros((1, d))])
    y_slots = (flat_out[slot] * (w_sorted * keep)[:, None].to(dtype)
               ).float()
    return _ordered_combine(y_slots, sort_idx, T, K)


def _apply_shard_map(params, cfg, x, mesh, rules
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel path in ``local_map``: x's tokens split over the
    data axes and whole over 'model'; the router, and wi and wo cast to the
    activation dtype, gathered over the data axes (wi and wo stay split
    by expert over 'model'); each rank dispatches to its E_pad/tp experts;
    the partial outputs leave the region as partial sums over 'model' and
    the aux losses as shares of their mean over the data axes, which the
    redistribution to replicated sums (all_reduce)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    sizes = sharding.axis_sizes(mesh)
    dmesh = sharding.dtensor_mesh(mesh)
    names = dmesh.mesh_dim_names          # the axes of size > 1
    tp_deg = sizes["model"]
    n_dp = 1
    for a in ("pod", "data"):
        n_dp *= sizes.get(a, 1)
    E = cfg.n_experts
    E_pad = -(-E // tp_deg) * tp_deg          # pad experts up (60 -> 64 @ 16)
    E_loc = E_pad // tp_deg
    B, S, d = x.shape
    if B % n_dp:
        # the reference's shard_map refuses it too: x's batch is split
        # over the data axes whatever the rules say
        raise ValueError(f"moe_impl='shard_map' splits the batch over the "
                         f"data axes: B={B} does not divide over {n_dp} "
                         f"ranks (the 'serve_seq' layout); use "
                         f"moe_impl='gspmd'")
    C = capacity((B // n_dp) * S, cfg)
    dtype = x.dtype

    def on(pl):
        """``pl`` on the data axes, ``Replicate`` on 'model'."""
        return tuple(Replicate() if n == "model" or sizes[n] == 1 else pl
                     for n in names)

    def expert_split(t):
        return tuple(Shard(0) if n == "model" and tp_deg > 1 else t
                     for t, n in zip(t, names))

    def partial_on_model(pls):
        return tuple(Partial() if n == "model" and tp_deg > 1 else p
                     for p, n in zip(pls, names))

    x_pl = on(Shard(0))
    whole = on(Replicate())
    w_pl = expert_split(whole)
    y_pl = partial_on_model(x_pl)
    # the gradients: a rank's x and router see only its experts' paths
    # (partial over 'model'); router, wi and wo only its tokens (partial
    # over the data axes)
    x_grad = partial_on_model(x_pl)
    router_grad = partial_on_model(on(Partial()))
    w_grad = expert_split(on(Partial()))
    # aux is each rank's share, aux / (ranks), summed: the mean over the
    # data axes of the same value on every model rank, and its gradient
    # reaches the router once
    n_share = n_dp * tp_deg
    aux_pl = tuple(Partial() for _ in names) if n_share > 1 else whole

    # wi and wo cast before the gather (the router stays f32, as route()
    # reads it); padded experts are routed to by nobody (the router has E
    # outputs), their capacity rows stay zero
    router = params["router"]
    wi, wo = params["wi"].to(dtype), params["wo"].to(dtype)
    if E_pad != E:
        wi = _pad_experts(wi, E_pad, dmesh)
        wo = _pad_experts(wo, E_pad, dmesh)

    def inner(x_loc, router_l, wi_l, wo_l):
        Bl, Sl, _ = x_loc.shape
        x2d = x_loc.reshape(Bl * Sl, d)
        weights, expert_idx, aux = route(x2d, router_l, cfg)
        e_lo = mesh.get_local_rank("model") * E_loc
        keep_mask = torch.ones(expert_idx.shape, dtype=torch.bool,
                               device=x_loc.device)
        y = _local_dispatch(x2d, weights, expert_idx, keep_mask, wi_l, wo_l,
                            e_lo, E_loc, C, dtype)
        return y.reshape(Bl, Sl, d), (aux / n_share if n_share > 1 else aux)

    local_map, kw = sharding.import_shard_map()
    y, aux = local_map(inner, out_placements=(y_pl, aux_pl),
                       in_placements=(x_pl, whole, w_pl, w_pl),
                       in_grad_placements=(x_grad, router_grad, w_grad,
                                           w_grad),
                       device_mesh=dmesh, **kw)(
        _as_dtensor(x, dmesh), _as_dtensor(router, dmesh),
        _as_dtensor(wi, dmesh), _as_dtensor(wo, dmesh))
    y = y.redistribute(dmesh, x_pl)
    aux = aux.redistribute(dmesh, tuple(Replicate() for _ in names))
    return y.to(dtype), aux


def _as_dtensor(t, dmesh):
    """A plain tensor (the global value on every rank) as a replicated
    DTensor on ``dmesh``; a DTensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, dmesh,
                              tuple(Replicate() for _ in dmesh.shape),
                              run_check=False)


def _pad_experts(w, E_pad: int, dmesh):
    """(E, ...) -> (E_pad, ...) with zero experts appended (replicated over
    'model' first: the padded stack splits by expert)."""
    from torch.distributed.tensor import Replicate, Shard
    w = _as_dtensor(w, dmesh)
    pls = tuple(Replicate() if isinstance(p, Shard) and p.dim == 0 else p
                for p in w.placements)
    w = w.redistribute(dmesh, pls)
    pad = torch.zeros((E_pad - w.shape[0],) + tuple(w.shape[1:]),
                      dtype=w.dtype, device=w.device)
    return torch.cat([w, pad], dim=0)
