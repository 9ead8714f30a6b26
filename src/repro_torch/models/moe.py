"""Mixture-of-Experts with sort-based dispatch (no (T, E, C) one-hot tensors).

A copy of ``repro.models.moe`` in PyTorch, its single-device path:

  router logits -> top-k -> flatten (T*k assignments) -> stable sort by expert
  -> position-within-expert -> drop beyond capacity -> scatter into per-expert
  buffers (E, C, d) -> batched expert matmuls -> gather back, weighted combine.

Shared experts (qwen2-moe) are a fused always-on SwiGLU with hidden
n_shared * shared_d_ff.

The port has no mesh, so the reference's ``logical_constraint`` calls have
no counterpart and :func:`apply` takes the single-device path whatever
``cfg.moe_impl`` says, as the reference does when no mesh is active.

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
    # give the same sum in any order, so the card's atomics do too)
    flat = expert_idx.reshape(-1)
    dispatch_frac = torch.zeros((e,), dtype=torch.float32,
                                device=x2d.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / (T * k), dtype=torch.float32,
                            device=x2d.device))
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
    counts = torch.zeros((E,), dtype=torch.long,
                         device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts              # exclusive prefix
    pos_in_e = (torch.arange(flat_e.numel(), device=flat_e.device)
                - starts[sorted_e])
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return sort_idx, slot, keep


def apply(params, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss): the reference's
    single-device path (``_apply_gspmd``; its shard_map dispatch needs a
    mesh)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.moe_top_k
    x2d = x.reshape(T, d)

    weights, expert_idx, aux = route(x2d, params["router"], cfg)

    sort_idx, slot, keep = dispatch(expert_idx, T, cfg)
    token_of = sort_idx // K                               # source token per slot
    w_sorted = weights.reshape(-1)[sort_idx]
    C = capacity(T, cfg)

    rows = x2d[token_of].masked_fill(~keep[:, None], 0)
    buf = x.new_zeros((E * C + 1, d)).index_put((slot,), rows)
    buf = buf[:E * C].reshape(E, C, d)

    # ---- expert compute (batched over E) ----
    h = swiglu(torch.bmm(buf, params["wi"].to(x.dtype)))
    out_buf = torch.bmm(h, params["wo"].to(x.dtype))

    # ---- combine ----
    flat_out = torch.cat([out_buf.reshape(E * C, d), x.new_zeros((1, d))])
    y_slots = (flat_out[slot] * (w_sorted * keep)[:, None].to(x.dtype)
               ).float()
    # each token's K slots in sorted-slot order (ascending expert id), summed
    # left to right from 0.0 as the reference's scatter-add sums them
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(T * K, device=x.device)
    order = inv.reshape(T, K).sort(dim=1).values
    y = x2d.new_zeros((T, d), dtype=torch.float32)
    for j in range(K):
        y = y + y_slots[order[:, j]]
    y = y.to(x.dtype)

    if cfg.n_shared_experts:
        y = y + _shared_experts(params, cfg, x2d)

    return y.reshape(B, S, d), aux
