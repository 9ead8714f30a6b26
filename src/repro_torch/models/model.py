"""Layer-pattern compiler: builds any of the 10 architectures from a
repeating ``(mixer, mlp)`` pattern (attention or Mamba-2 SSD mixers;
dense, MoE or no MLPs), looped over its repeats.

A copy of ``repro.models.model`` in PyTorch. Parameters keep the
reference's tree, as plain nested dicts of tensors: ``embed`` (K, Vp, d),
``blocks`` a list over pattern positions of ``{group: {name: (R, ...)}}``
stacked over the R repeats, ``final_norm`` and, untied, ``lm_head``. The
loop over repeats is a Python loop in place of ``lax.scan``.
``params_from_numpy`` / ``params_to_numpy`` carry the reference's
parameters across, key for key and bit for bit.

The training subset: :func:`loss_fn` with the full-logit
:func:`cross_entropy` or, under ``cfg.chunked_ce``,
:func:`cross_entropy_chunked` (kernel G on a CUDA tensor), and the
per-repeat remat of :func:`hidden_states`. A training step may hand these
functions a tree whose stacked leaves are lists of per-index tensors
(``train/step.py``): ``w[r]`` reads either.
``opt_state_from_numpy`` / ``opt_state_to_numpy`` carry the reference's
optimizer state across.

The cache is a tuple over pattern positions: ``{"k", "v"}`` (R, B, max_seq,
KH, hd) at an attention position, ``{"ssm", "conv"}`` (R, B, H, P, N) and
(R, B, K-1, CH) f32 at a Mamba position; batch is axis 1 in all four.
:func:`decode_step` writes both kinds in place.

Under an active mesh (``distributed.sharding.axis_rules``) parameters,
batches and caches are DTensors placed by ``distributed.placement``, and
activations are constrained where the reference constrains them
(:func:`param_logical_axes`, :func:`cache_logical_axes`). The embedding's
row gather and kernel G take local tensors and run inside ``local_map``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.kernels.fused_ce.ops import FusedCEMean
from repro_torch.models import attention, mamba, moe
from repro_torch.models.layers import (ParamDef, axes_from_defs,
                                       init_from_defs, mlp_apply,
                                       mlp_param_defs, rms_norm, torch_dtype)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _block_defs(cfg: ModelConfig, mixer: str, mlp: str
                ) -> Dict[str, Dict[str, ParamDef]]:
    d = cfg.d_model
    out: Dict[str, Dict[str, ParamDef]] = {
        "norm_mixer": {"w": ParamDef((d,), ("embed",), init="ones")},
    }
    out["mixer"] = (attention.param_defs(cfg) if mixer == "attn"
                    else mamba.param_defs(cfg))
    if mlp != "none":
        out["norm_mlp"] = {"w": ParamDef((d,), ("embed",), init="ones")}
        out["mlp"] = (mlp_param_defs(cfg) if mlp == "dense"
                      else moe.param_defs(cfg))
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Parameters drawn from ``generator`` (on its device) and placed on
    ``device`` (default: the generator's): the reference's distributions
    (embed and lm_head normal x 0.02, weights normal / sqrt(fan_in), norms
    ones), in ``cfg.param_dtype``. The numbers differ from the reference's
    ``jax.random`` draws; tests carry weights across with
    :func:`params_from_numpy`."""
    dtype = torch_dtype(cfg.param_dtype)
    device = generator.device if device is None else torch.device(device)
    R, vp = cfg.n_repeats, cfg.padded_vocab

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return x.mul_(std).to(device=device, dtype=dtype)

    params: Params = {
        "embed": normal((cfg.n_codebooks, vp, cfg.d_model), 0.02)}
    blocks = []
    for mixer, mlp in cfg.layer_pattern():
        groups = _block_defs(cfg, mixer, mlp)
        blocks.append({g: init_from_defs(generator, defs, dtype, repeats=R,
                                         device=device)
                       for g, defs in sorted(groups.items())})
    params["blocks"] = blocks
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                      device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.n_codebooks * vp), 0.02)
    return params


def param_logical_axes(cfg: ModelConfig) -> Params:
    axes: Params = {"embed": ("codebook", "vocab", "embed"),
                    "final_norm": ("embed",)}
    axes["blocks"] = [
        {g: {n: ("stack",) + ax for n, ax in axes_from_defs(defs).items()}
         for g, defs in _block_defs(cfg, mixer, mlp).items()}
        for mixer, mlp in cfg.layer_pattern()]
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def _expected_shapes(cfg: ModelConfig) -> Params:
    R, vp = cfg.n_repeats, cfg.padded_vocab
    tree: Params = {"embed": (cfg.n_codebooks, vp, cfg.d_model),
                    "final_norm": (cfg.d_model,)}
    tree["blocks"] = [
        {g: {n: (R,) + tuple(d.shape) for n, d in defs.items()}
         for g, defs in _block_defs(cfg, mixer, mlp).items()}
        for mixer, mlp in cfg.layer_pattern()]
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.d_model, cfg.n_codebooks * vp)
    return tree


def params_from_numpy(cfg: ModelConfig, tree: Params, device=None) -> Params:
    """The reference's parameter pytree as numpy arrays -> the port's
    parameters on ``device``, key for key, values and dtypes unchanged.
    Raises on a missing or extra key or a wrong shape."""
    device = torch.device("cpu" if device is None else device)

    def conv(want, got, path):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                raise ValueError(f"{path}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
            return {k: conv(want[k], got[k], f"{path}/{k}") for k in want}
        if isinstance(want, list):
            if len(got) != len(want):
                raise ValueError(f"{path}: {len(got)} positions, "
                                 f"expected {len(want)}")
            return [conv(w, g, f"{path}[{i}]")
                    for i, (w, g) in enumerate(zip(want, got))]
        arr = np.asarray(got)
        if arr.shape != tuple(want):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(want)}")
        return torch.from_numpy(np.array(arr)).to(device)

    return conv(_expected_shapes(cfg), tree, "params")


def params_to_numpy(params: Params) -> Params:
    """The inverse of :func:`params_from_numpy`: the same tree of numpy
    arrays (on the host)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()


def opt_state_from_numpy(cfg: ModelConfig, state, device=None):
    """The reference's ``OptState`` with numpy leaves -> the port's
    :class:`~repro_torch.train.optim.OptState` on ``device``: step, and mu,
    nu (and ef, where present) checked against the parameter tree."""
    from repro_torch.train.optim import OptState
    device = torch.device("cpu" if device is None else device)
    conv = (lambda t: None if t is None
            else params_from_numpy(cfg, t, device))
    return OptState(step=torch.as_tensor(np.asarray(state.step),
                                         dtype=torch.int32).to(device),
                    mu=conv(state.mu), nu=conv(state.nu), ef=conv(state.ef))


def opt_state_to_numpy(state):
    """The inverse of :func:`opt_state_from_numpy`: (step, mu, nu, ef) as
    numpy trees (ef None where absent), in ``OptState``'s field order."""
    return type(state)(*[None if t is None else params_to_numpy(t)
                         for t in state])


#: the leaves that the reference casts to the activation dtype wherever it
#: reads them, by block kind (``conv_b`` too: every use casts it)
CAST_AT_USE = {
    "attn": ("wq", "wk", "wv", "wo"),
    "mamba": ("in_proj", "out_proj", "conv_w", "conv_b"),
    "dense": ("wi", "wo"),
    "moe": ("shared_wi", "shared_wo"),
}


def activation_weights(params: Params, cfg: ModelConfig) -> Params:
    """``params`` with every leaf that the reference casts to the
    activation dtype at each use (:data:`CAST_AT_USE`: the attention and
    dense-MLP projections, the SSD mixer's ``in_proj``, ``out_proj``,
    ``conv_w`` and ``conv_b``, the shared experts' ``shared_wi`` and
    ``shared_wo``) cast once to ``cfg.dtype``. Everything else stays as it
    is: the MoE ``router`` and ``shared_gate`` and the SSD's ``A_log``,
    ``D`` and ``dt_bias`` (read in f32), the norms and the embedding, and
    the MoE expert stacks ``wi``/``wo`` (cast at use, but a second copy of
    them would not fit beside qwen2-moe's f32 parameters on an 80 GB card).
    The forward gives the same numbers from either tree; this one spares
    the copy each use makes for the cost of holding it."""
    dt = torch_dtype(cfg.dtype)
    out = dict(params)
    blocks = []
    for pos, (mixer, mlp) in zip(params["blocks"], cfg.layer_pattern()):
        kinds = {"mixer": mixer, "mlp": mlp}
        blocks.append({
            g: ({n: (w.to(dt) if n in CAST_AT_USE[kinds[g]] else w)
                 for n, w in grp.items()} if g in kinds else grp)
            for g, grp in pos.items()})
    out["blocks"] = blocks
    return out


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _layer(pos_params, r: int):
    """Repeat r of one pattern position: each leaf's leading axis sliced."""
    return {g: {n: w[r] for n, w in grp.items()}
            for g, grp in pos_params.items()}


def embed_tokens(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) or (B, S, K) -> (B, S, d) summed over codebooks.
    Rows are gathered, then cast (the reference casts the whole table
    first; the values are the same)."""
    if tokens.dim() == 2:
        tokens = tokens[..., None]
    tokens = tokens.long()
    dt = torch_dtype(cfg.dtype)
    x = _rows(params["embed"][0], tokens[..., 0]).to(dt)
    for k in range(1, cfg.n_codebooks):
        x = x + _rows(params["embed"][k], tokens[..., k]).to(dt)
    return logical_constraint(x, "batch", "seq", "act_embed")


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``. Under a mesh the gather (an advanced index, which
    DTensor has no strategy for on a sharded table) runs in ``local_map``
    on the whole table and this rank's tokens; the table's gradient is
    partial over the mesh dims that split the tokens."""
    mesh, rules = sharding._current()
    if mesh is None or not sharding.is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import Partial, Replicate, Shard
    idx = logical_constraint(idx, "batch", "seq")     # plain tokens placed
    tok_sh = sharding.make_sharding(("batch", "seq"), mesh, rules)
    tok = tok_sh.placements
    out = sharding.make_sharding(("batch", "seq", None), mesh,
                                 rules).placements
    whole = tuple(Replicate() for _ in tok)
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in tok)
    local_map, kw = sharding.import_shard_map()
    return local_map(lambda t, i: t[i], out_placements=list(out),
                     in_placements=(whole, tok), in_grad_placements=(grad, tok),
                     device_mesh=tok_sh.device_mesh, **kw)(table, idx)


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, K, Vp) in float32; padded columns -1e30."""
    vp = cfg.padded_vocab
    B, S, _ = x.shape
    if cfg.tie_embeddings:
        embed = params["embed"]
        if isinstance(embed, (list, tuple)):        # per-codebook leaves
            embed = torch.stack(list(embed))
        logits = torch.einsum("bsd,kvd->bskv", x.float(), embed.float())
    else:
        logits = (x.float() @ params["lm_head"].float()).reshape(
            B, S, cfg.n_codebooks, vp)
    logits = logical_constraint(logits, "batch", "seq", None, "vocab")
    if vp != cfg.vocab_size:
        if sharding.is_dtensor(logits):     # no in-place fill strategy
            pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
            return logits.masked_fill(pad, -1e30)
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _mlp_residual(cfg, pos_params, mlp: str, x, aux):
    """The block's second half: (x + mlp(norm(x)), aux plus the MoE's
    load-balancing loss), or (x, aux) without an MLP."""
    if mlp == "none":
        return x, aux
    h = rms_norm(x, pos_params["norm_mlp"]["w"], cfg.norm_eps)
    if mlp == "dense":
        return x + mlp_apply(pos_params["mlp"], cfg, h), aux
    out, a = moe.apply(pos_params["mlp"], cfg, h)
    return x + out, aux + a


def _apply_block(cfg, pos_params, mixer: str, mlp: str, x, positions, aux):
    h = rms_norm(x, pos_params["norm_mixer"]["w"], cfg.norm_eps)
    if mixer == "attn":
        x = x + attention.apply(pos_params["mixer"], cfg, h, positions)
    else:
        x = x + mamba.apply(pos_params["mixer"], cfg, h)
    x, aux = _mlp_residual(cfg, pos_params, mlp, x, aux)
    return logical_constraint(x, "batch", "seq", "act_embed"), aux


def _prefix(params, cfg, tokens, vision_embeds):
    x = embed_tokens(params, cfg, tokens)
    if cfg.n_prefix and vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


_SAVED_BY_MINIMAL = ("mm", "addmm")   # aten products without batch dims


def _save_matmul_outputs():
    """Selective-checkpoint contexts that keep the outputs of products
    without batch dims and recompute everything else: the counterpart of
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = {getattr(torch.ops.aten, n).default for n in _SAVED_BY_MINIMAL}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _remat(fn, policy: str):
    """``fn`` under the config's remat policy: 'none' as it is, 'minimal'
    saving the matmul outputs, 'full' saving nothing but its inputs. Remat
    changes no value; without autograd there is nothing to save."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import checkpoint
    kw = {"context_fn": _save_matmul_outputs} if policy == "minimal" else {}
    # the backward recomputes fn in autograd's thread on the card, under
    # the mesh rules of the forward
    fn = sharding.under_current_rules(fn)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def hidden_states(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  vision_embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """forward() up to (but not including) the logit projection. Each
    repeat of the pattern runs under ``cfg.remat_policy``, as the
    reference's scan body does."""
    x, positions = _prefix(params, cfg, tokens, vision_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pattern = cfg.layer_pattern()

    def body(xx, aux, block_r):
        for pos, (mixer, mlp) in enumerate(pattern):
            xx, aux = _apply_block(cfg, block_r[pos], mixer, mlp, xx,
                                   positions, aux)
        return xx, aux

    body = _remat(body, cfg.remat_policy)
    for r in range(cfg.n_repeats):
        x, aux = body(x, aux, [_layer(p, r) for p in params["blocks"]])
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            vision_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal forward over full sequences.

    Returns (logits (B, S_total, K, Vp) float32, moe_aux_loss scalar; 0
    without MoE layers).
    """
    x, aux = hidden_states(params, cfg, tokens, vision_embeds=vision_embeds)
    return logits_from_hidden(params, cfg, x), aux


# --- cost-probe entry points (dry-run): one pattern repeat ------------------

def single_repeat(params_r, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward through ONE pattern repeat. params_r: per-position dicts with
    the repeat dim already sliced away. Returns (x, MoE aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pos, (mixer, mlp) in enumerate(cfg.layer_pattern()):
        x, aux = _apply_block(cfg, params_r[pos], mixer, mlp, x, positions,
                              aux)
    return x, aux


def single_repeat_decode(params_r, cfg: ModelConfig, x: torch.Tensor,
                         cache_r, cache_len):
    """Decode through ONE pattern repeat. cache_r: per-position cache dicts
    with the repeat dim sliced away. Returns (x, the new per-position
    caches): an attention position's is its dict, written in place as
    :func:`decode_step` writes it, a Mamba position's the new state."""
    new_cache_r = []
    for pos, (mixer, mlp) in enumerate(cfg.layer_pattern()):
        p = params_r[pos]
        h = rms_norm(x, p["norm_mixer"]["w"], cfg.norm_eps)
        if mixer == "attn":
            out, new_c = attention.decode(p["mixer"], cfg, h, cache_r[pos],
                                          cache_len)
        else:
            out, new_c = mamba.decode(p["mixer"], cfg, h, cache_r[pos])
        new_cache_r.append(new_c)
        x, _ = _mlp_residual(cfg, p, mlp, x + out, 0.0)
    return x, tuple(new_cache_r)


def head_and_embed_loss(params, cfg: ModelConfig, tokens: torch.Tensor,
                        labels: torch.Tensor,
                        hidden: torch.Tensor) -> torch.Tensor:
    """Everything OUTSIDE the layer stack: embedding + final norm + logits +
    CE. ``hidden`` stands in for the stack output (residual stream). Honors
    cfg.chunked_ce, so the dry-run's head probe measures the configured
    path (kernel G on a CUDA tensor)."""
    x = embed_tokens(params, cfg, tokens)
    x = x + hidden.to(x.dtype)          # keep embed live in the grad graph
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.chunked_ce:
        B, S, d = x.shape
        lbl = labels if labels.dim() == 3 else labels[..., None]
        ce = 0.0
        for k in range(cfg.n_codebooks):
            w = _head_weight(params, cfg, k).to(x.dtype)
            ce = ce + cross_entropy_chunked(
                x.reshape(B * S, d), w, lbl[..., k].reshape(-1),
                cfg.vocab_size, cfg.ce_chunks)
        return ce / cfg.n_codebooks
    return cross_entropy(logits_from_hidden(params, cfg, x), labels)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (B, S, K, Vp) f32; labels: (B, S) or (B, S, K) int.

    Positions with label < 0 are ignored.
    """
    if labels.dim() == 2:
        labels = labels[..., None]
    valid = labels >= 0
    if mask is not None:
        valid = valid & mask[..., None].bool()
    safe = labels.clamp_min(0).long()
    if sharding.is_dtensor(logits):
        # the label gather reads the whole vocab row (DTensor's gather of
        # a vocab-split operand masks with the wrong rank)
        logits = logical_constraint(logits, "batch", "seq", None, None)
    lse = torch.logsumexp(logits, dim=-1)
    picked = _pick(logits, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return nll.sum() / valid.sum().clamp_min(1)


def _pick(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``logits.gather(-1, idx)``. A DTensor (whole vocab rows, rows laid
    out by the rules) gathers in ``local_map`` on each rank's rows:
    DTensor's own gather backward would scatter into zeros of the global
    shape on every rank (the whole batch's logits)."""
    if not sharding.is_dtensor(logits):
        return logits.gather(-1, idx)
    mesh, rules = sharding._current()
    sh = sharding.make_sharding(("batch", "seq", None, None), mesh, rules)
    idx = logical_constraint(idx, "batch", "seq", None, None)
    local_map, kw = sharding.import_shard_map()
    pls = sh.placements
    return local_map(lambda lg, i: lg.gather(-1, i), out_placements=list(pls),
                     in_placements=(pls, pls), device_mesh=sh.device_mesh,
                     **kw)(logits, idx)


def cross_entropy_chunked_plain(x: torch.Tensor, w_vd: torch.Tensor,
                                labels: torch.Tensor, vocab_size: int,
                                n_chunks: int) -> torch.Tensor:
    """The reference's streaming logsumexp over vocab chunks, step for
    step. Each chunk's logits are the f32 products of the operands: the
    reference writes ``einsum(x, w_c).astype(float32)``, which rounds to
    bf16 first when run op by op, but XLA compiles the scan with the convert
    folded into the product and keeps f32, and the port follows what the
    reference computes. Plain PyTorch on any device; autograd keeps each
    chunk's logits for the backward."""
    T, d = x.shape
    Vp = w_vd.shape[0]
    assert Vp % n_chunks == 0
    Vc = Vp // n_chunks
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    m = torch.full((T,), -1e30, dtype=torch.float32, device=x.device)
    s = torch.zeros((T,), dtype=torch.float32, device=x.device)
    picked = torch.zeros((T,), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        col0 = c * Vc
        logits = torch.einsum("td,vd->tv", x.float(),
                              w_vd[col0:col0 + Vc].float())
        col = col0 + torch.arange(Vc, device=x.device)
        logits = logits.masked_fill((col >= vocab_size)[None, :], -1e30)
        m_new = torch.maximum(m, logits.max(dim=-1).values)
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(-1)
        m = m_new
        inchunk = (safe >= col0) & (safe < col0 + Vc)
        local = logits.gather(
            1, (safe - col0).clamp(0, Vc - 1)[:, None])[:, 0]
        picked = picked + torch.where(inchunk, local,
                                      torch.zeros_like(local))
    nll = torch.where(valid, torch.log(s) + m - picked, torch.zeros_like(s))
    return nll.sum() / valid.sum().clamp_min(1)


def cross_entropy_chunked(x: torch.Tensor, w_vd: torch.Tensor,
                          labels: torch.Tensor, vocab_size: int,
                          n_chunks: int) -> torch.Tensor:
    """Fused projection + CE without the (T, Vp) logits. x: (T, d); w_vd:
    (Vp, d); labels: (T,) (<0 = ignore). On a CUDA tensor it is
    :class:`FusedCEMean` (kernel G forward, a backward chunked by
    ``n_chunks``); on a CPU tensor the copy of the reference's scan,
    :func:`cross_entropy_chunked_plain`. Both keep the logits in f32, as
    the reference's Pallas kernel and its compiled scan do."""
    if sharding.is_dtensor(x):
        return _ce_on_mesh(x, w_vd, labels, vocab_size, n_chunks)
    if x.device.type != "cuda":
        return cross_entropy_chunked_plain(x, w_vd, labels, vocab_size,
                                           n_chunks)
    return FusedCEMean.apply(x.contiguous(), w_vd.contiguous(),
                             labels.to(torch.int32).contiguous(),
                             vocab_size, n_chunks)


def _ce_on_mesh(x, w_vd, labels, vocab_size: int, n_chunks: int):
    """:func:`cross_entropy_chunked` of DTensors: each rank's token rows
    against the whole (Vp, d) head weight, inside ``local_map``. Where the
    rules split the tokens, each rank's mean times its count is summed
    over the ranks and divided by the global count; else the local mean
    is the mean."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, rules = sharding._current()
    labels = logical_constraint(labels, "tokens")     # plain labels placed
    rows_sh = sharding.make_sharding(("tokens", None), mesh, rules)
    rows, dmesh = rows_sh.placements, rows_sh.device_mesh
    tok = sharding.make_sharding(("tokens",), mesh, rules).placements
    whole = tuple(Replicate() for _ in rows)
    split = tuple(Partial() if isinstance(p, Shard) else Replicate()
                  for p in rows)
    local_map, kw = sharding.import_shard_map()
    if split == whole:
        return local_map(
            lambda a, w, lab: cross_entropy_chunked(a, w, lab, vocab_size,
                                                    n_chunks),
            out_placements=list(whole), in_placements=(rows, whole, tok),
            in_grad_placements=(rows, split, tok), device_mesh=dmesh,
            **kw)(x, w_vd, labels)

    def local_sum(a, w, lab):
        mean = cross_entropy_chunked(a, w, lab, vocab_size, n_chunks)
        return mean * (lab >= 0).sum().clamp_min(1)
    total = local_map(local_sum, out_placements=list(split),
                      in_placements=(rows, whole, tok),
                      in_grad_placements=(rows, split, tok),
                      device_mesh=dmesh, **kw)(x, w_vd, labels)
    # (replicated as a DTensor, not full_tensor(): the loss stays a DTensor,
    # so no plain tensor meets a DTensor gradient in the backward)
    total = total.redistribute(dmesh, whole)
    return total / (labels >= 0).sum().clamp_min(1)


def _head_weight(params: Params, cfg: ModelConfig,
                 codebook: int) -> torch.Tensor:
    """(Vp, d) projection for one codebook, tied or untied."""
    if cfg.tie_embeddings:
        return params["embed"][codebook]
    vp = cfg.padded_vocab
    return params["lm_head"][:, codebook * vp:(codebook + 1) * vp].T


def loss_fn(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if cfg.chunked_ce:
        x, aux = hidden_states(params, cfg, batch["tokens"],
                               vision_embeds=batch.get("vision_embeds"))
        if cfg.n_prefix:
            x = x[:, cfg.n_prefix:]
        B, S, d = x.shape
        labels = batch["labels"]
        if labels.dim() == 2:
            labels = labels[..., None]
        ce = 0.0
        for k in range(cfg.n_codebooks):
            w = _head_weight(params, cfg, k).to(x.dtype)
            ce = ce + cross_entropy_chunked(
                x.reshape(B * S, d), w, labels[..., k].reshape(-1),
                cfg.vocab_size, cfg.ce_chunks)
        ce = ce / cfg.n_codebooks
    else:
        logits, aux = forward(params, cfg, batch["tokens"],
                              vision_embeds=batch.get("vision_embeds"))
        if cfg.n_prefix:
            logits = logits[:, cfg.n_prefix:]
        ce = cross_entropy(logits, batch["labels"])
    total = ce + cfg.router_aux_coef * aux
    return total, {"ce": ce, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Tuple[Any, ...]:
    """One dict per pattern position, every leaf stacked over the R
    repeats: ``{"k", "v"}`` (R, batch, max_seq, KH, hd) in ``dtype`` at an
    attention position, ``{"ssm", "conv"}`` f32 zeros at a Mamba position
    (real tensors, since decode writes them in place)."""
    R = cfg.n_repeats
    cache = []
    for mixer, axes in zip((m for m, _ in cfg.layer_pattern()),
                           cache_logical_axes(cfg)):
        if mixer == "attn":
            shape = (R, batch, max_seq, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            cache.append({n: sharding.zeros(shape, axes[n], dtype, device)
                          for n in ("k", "v")})
        else:
            cache.append({n: sharding.zeros((R,) + t.shape, axes[n],
                                            t.dtype, device)
                          for n, t in mamba.init_state(cfg, batch,
                                                       "meta").items()})
    return tuple(cache)


def cache_logical_axes(cfg: ModelConfig) -> Tuple[Any, ...]:
    axes = []
    for mixer, _ in cfg.layer_pattern():
        ax = (attention.cache_axes(cfg) if mixer == "attn"
              else mamba.state_axes(cfg))
        axes.append({k: ("stack",) + v for k, v in ax.items()})
    return tuple(axes)


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Tuple[Any, ...], cache_len
                ) -> Tuple[torch.Tensor, Tuple[Any, ...]]:
    """One new token per sequence against a filled cache.

    tokens: (B, 1) or (B, 1, K); cache_len: int (tokens in the cache).
    Writes the new k/v and SSM states into ``cache`` in place and returns
    (logits (B, 1, K, Vp), cache).
    """
    x = embed_tokens(params, cfg, tokens)
    pattern = cfg.layer_pattern()
    for r in range(cfg.n_repeats):
        for pos, (mixer, mlp) in enumerate(pattern):
            p = _layer(params["blocks"][pos], r)
            h = rms_norm(x, p["norm_mixer"]["w"], cfg.norm_eps)
            c = {n: t[r] for n, t in cache[pos].items()}
            if mixer == "attn":
                out, _ = attention.decode(p["mixer"], cfg, h, c, cache_len)
            else:
                out, new = mamba.decode(p["mixer"], cfg, h, c)
                for n, t in new.items():
                    c[n].copy_(t)
            x, _ = _mlp_residual(cfg, p, mlp, x + out, 0.0)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(params, cfg, x), cache


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: int, vision_embeds: Optional[torch.Tensor] = None,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Tuple[Any, ...]]:
    """Run the prompt through the model, returning last-position logits and
    a cache sized ``max_seq`` ready for decode_step."""
    x, positions = _prefix(params, cfg, tokens, vision_embeds)
    B = x.shape[0]
    cache = init_cache(cfg, B, max_seq, cache_dtype, x.device)
    pattern = cfg.layer_pattern()
    for r in range(cfg.n_repeats):
        for pos, (mixer, mlp) in enumerate(pattern):
            p = _layer(params["blocks"][pos], r)
            h = rms_norm(x, p["norm_mixer"]["w"], cfg.norm_eps)
            if mixer == "attn":
                out, st = _attn_prefill(p["mixer"], cfg, h, positions,
                                        max_seq, cache_dtype)
            else:
                out, st = mamba.apply(p["mixer"], cfg, h, return_state=True)
            for n, t in st.items():
                sharding.write_slice(cache[pos][n], 0, r, t[None])
            x, _ = _mlp_residual(cfg, p, mlp, x + out, 0.0)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(params, cfg, x[:, -1:]), cache


def _attn_prefill(p, cfg, h, positions, max_seq, cache_dtype):
    """Attention over the prompt, and the prompt's k/v (after qk-norm and
    RoPE, cast to ``cache_dtype``) in a (B, max_seq, KH, hd) cache. The
    projections are taken once and shared (the reference recomputes k/v and
    leaves XLA to merge the two)."""
    B, S, _ = h.shape
    q, k, v = attention._project_qkv(p, cfg, h, positions)
    out = attention._attend(p, cfg, q, k, v)
    kv = attention.init_cache(cfg, B, max_seq, cache_dtype, h.device)
    for n, t in (("k", k), ("v", v)):
        sharding.write_slice(kv[n], 1, 0, t.to(cache_dtype))
        kv[n] = logical_constraint(kv[n], "batch", "seq_kv", "act_kv",
                                   "head_dim")
    return out, kv
