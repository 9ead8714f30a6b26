"""GQA attention with RoPE, optional per-head q/k RMSNorm, KV-cache decode.

A copy of ``repro.models.attention`` in PyTorch. Weights are stored with
flat head dims — wq: (d_model, H*Dh) — as in the reference.

Three execution paths, selected as the reference selects them:
  * ``cfg.attention_impl == "pallas"``: kernel F
    (``kernels/flash_attention``; on a CUDA tensor the hand-written kernel,
    on a CPU tensor its plain version);
  * full causal attention (einsum), or query-chunked above
    ``chunk_threshold`` tokens (score matrix O(chunk * S));
  * single-token decode against a pre-allocated KV cache, written in place.

Products that the reference takes with ``preferred_element_type=float32``
on narrower operands are taken here on f32 copies of those operands: the
products of bf16 values are exact in f32, so the sums are the same up to
their order. Masks are applied with ``masked_fill`` and a Python scalar: a
scalar tensor made on the card would be a blocking host-to-device copy,
which stalls the host once a layer.

Under an active mesh (``distributed.sharding.axis_rules``) the tensors are
DTensors, constrained where the reference constrains them. Attention over
the prompt (kernel F, which takes local tensors, or the einsum paths) runs
inside ``local_map``: batch over the data axes, heads over 'model' where
the rules shard heads, else whole. The cache writes go through
``sharding.write_slice``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import ParamDef, apply_rope, rms_norm

NEG_INF = -1e30


def param_defs(cfg) -> Dict[str, ParamDef]:
    d = cfg.d_model
    defs = {
        "wq": ParamDef((d, cfg.q_dim), ("embed", "q_dim")),
        "wk": ParamDef((d, cfg.kv_dim), ("embed", "kv_dim")),
        "wv": ParamDef((d, cfg.kv_dim), ("embed", "kv_dim")),
        "wo": ParamDef((cfg.q_dim, d), ("q_dim", "embed")),
    }
    if cfg.qk_norm:
        hd = cfg.resolved_head_dim
        defs["q_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
        defs["k_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
    return defs


def _project_qkv(params, cfg, x, positions):
    B, S = x.shape[0], x.shape[1]
    hd = cfg.resolved_head_dim
    q = sharding.split_dim(x @ params["wq"].to(x.dtype), 2,
                           (B, S, cfg.n_heads, hd))
    k = sharding.split_dim(x @ params["wk"].to(x.dtype), 2,
                           (B, S, cfg.n_kv_heads, hd))
    v = sharding.split_dim(x @ params["wv"].to(x.dtype), 2,
                           (B, S, cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = logical_constraint(q, "batch", "seq", "heads", "head_dim")
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KH, D) -> (B, S, H, D): head h reads kv head h // rep, each
    kv head repeated contiguously."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return k.repeat_interleave(rep, dim=2)


def _causal_attend(q, k, v, scale, q_offset=0):
    """Full attention. q: (B,Sq,H,D); k,v: (B,Skv,H,D); f32 accumulation."""
    Sq, Skv = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    mask = qpos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def _chunked_causal_attend(q, k, v, scale, chunk: int):
    """Query-chunked causal attention: peak memory O(chunk * Skv). Each
    query row depends on its own q only, so the last chunk may be short
    (the reference pads it and slices the padding away)."""
    return torch.cat([_causal_attend(q[:, off:off + chunk], k, v, scale,
                                     q_offset=off)
                      for off in range(0, q.shape[1], chunk)], dim=1)


def _per_head(fn, q, k, v):
    """``fn(q, k, v)``: attention, independent for each (batch row, head).
    DTensors go through ``local_map``, each rank's (B/dp, S, H or H/tp, D)
    block (batch over the data axes, heads over 'model' where the rules
    split heads): kernel F takes local tensors, and the einsum paths avoid
    DTensor's plans for the (batch x heads) products."""
    if not sharding.is_dtensor(q):
        return fn(q, k, v)
    mesh, rules = sharding._current()
    sh = sharding.make_sharding(("batch", "seq", "heads", "head_dim"),
                                mesh, rules)
    pls = sh.placements
    local_map, kw = sharding.import_shard_map()
    return local_map(fn, out_placements=list(pls),
                     in_placements=(pls, pls, pls),
                     device_mesh=sh.device_mesh, **kw)(q, k, v)


def _attend(params, cfg, q, k, v, chunk_threshold: int = 8192):
    """The second half of :func:`apply`: attention over projected q, k, v
    (KV heads not yet expanded) and the output projection."""
    B, S = q.shape[0], q.shape[1]
    k = _expand_kv(k, cfg.n_heads)
    v = _expand_kv(v, cfg.n_heads)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    if cfg.attention_impl == "pallas":
        out = _per_head(lambda a, b, c: fa_ops.flash_attention(
            a, b, c, causal=True, scale=scale), q, k, v)
    elif S > chunk_threshold:
        out = _per_head(lambda a, b, c: _chunked_causal_attend(
            a, b, c, scale, chunk=1024), q, k, v)
    else:
        out = _per_head(lambda a, b, c: _causal_attend(a, b, c, scale),
                        q, k, v)
    out = logical_constraint(out, "batch", "seq", "heads", "head_dim")
    out = out.reshape(B, S, cfg.q_dim)
    return out @ params["wo"].to(out.dtype)


def apply(params, cfg, x: torch.Tensor, positions: torch.Tensor,
          chunk_threshold: int = 8192) -> torch.Tensor:
    """Training / prefill forward (causal). x: (B, S, d)."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    return _attend(params, cfg, q, k, v, chunk_threshold)


# --- decode ------------------------------------------------------------------


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.n_kv_heads, hd)
    ax = cache_axes(cfg)["k"]
    return {"k": sharding.zeros(shape, ax, dtype, device),
            "v": sharding.zeros(shape, ax, dtype, device)}


def cache_axes(cfg) -> Dict[str, Tuple[Optional[str], ...]]:
    ax = ("batch", "seq_kv", "act_kv", "head_dim")
    return {"k": ax, "v": ax}


def decode(params, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor],
           cache_len: Union[int, torch.Tensor]):
    """One-token decode. x: (B, 1, d); cache_len: tokens already in the
    cache. Writes the new k/v into ``cache`` in place (the reference returns
    an updated copy) and returns (out (B,1,d), cache)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = int(cache_len)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    k_cache, v_cache = cache["k"], cache["v"]
    sharding.write_slice(k_cache, 1, pos, k.to(k_cache.dtype))
    sharding.write_slice(v_cache, 1, pos, v.to(v_cache.dtype))
    k_cache = logical_constraint(k_cache, "batch", "seq_kv", "act_kv",
                                 "head_dim")
    v_cache = logical_constraint(v_cache, "batch", "seq_kv", "act_kv",
                                 "head_dim")

    # scores against the unexpanded cache: query head h = g * rep + r reads
    # kv head g = h // rep, the pairs _expand_kv would make, with no
    # (B, max_seq, H, hd) copy; q is cast to the cache dtype first
    G, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qg = sharding.split_dim(q.to(k_cache.dtype).float().reshape(
        B, cfg.n_heads, hd), 1, (B, G, rep, hd))
    scale = 1.0 / math.sqrt(hd)
    valid = torch.arange(k_cache.shape[1], device=x.device) <= pos
    out = _decode_attend(qg, k_cache, v_cache, valid, scale).to(x.dtype)
    out = out.reshape(B, 1, cfg.q_dim)
    return out @ params["wo"].to(x.dtype), cache


def _decode_core(qg, k_cache, v_cache, valid, scale):
    scores = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache.float()) * scale
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bgrk,bkgd->bgrd", probs.to(v_cache.dtype).float(),
                        v_cache.float())


def _decode_attend(qg, k_cache, v_cache, valid, scale):
    """:func:`_decode_core`, independent for each (batch row, kv head).
    Where the cache's sequence is whole on every rank, DTensors go through
    ``local_map`` in (batch, kv head) blocks: DTensor's einsum flattens
    (batch x kv heads), which torch 2.11 refuses with the heads split. A
    split sequence ('seq_kv') stays with DTensor's strategies: the softmax
    spans the ranks."""
    if not sharding.is_dtensor(k_cache):
        return _decode_core(qg, k_cache, v_cache, valid, scale)
    from torch.distributed.tensor import Shard
    mesh, rules = sharding._current()
    c_pl = sharding.make_sharding(("batch", "seq_kv", "act_kv", "head_dim"),
                                  mesh, rules)
    if any(isinstance(p, Shard) and p.dim == 1 for p in c_pl.placements):
        return _decode_core(qg, k_cache, v_cache, valid, scale)
    q_pl = sharding.make_sharding(("batch", "act_kv", None, None), mesh,
                                  rules).placements
    pls = c_pl.placements
    local_map, kw = sharding.import_shard_map()
    return local_map(
        lambda q, k, v: _decode_core(q, k, v, valid, scale),
        out_placements=list(q_pl), in_placements=(q_pl, pls, pls),
        device_mesh=c_pl.device_mesh, **kw)(qg, k_cache, v_cache)
