"""Layer-pattern compiler, the serving subset: any architecture whose
pattern is attention mixers with dense (or no) MLPs, from a repeating
``(mixer, mlp)`` pattern looped over its repeats.

A copy of ``repro.models.model`` in PyTorch. Parameters keep the
reference's tree, as plain nested dicts of tensors: ``embed`` (K, Vp, d),
``blocks`` a list over pattern positions of ``{group: {name: (R, ...)}}``
stacked over the R repeats, ``final_norm`` and, untied, ``lm_head``. The
loop over repeats is a Python loop in place of ``lax.scan``.
``params_from_numpy`` / ``params_to_numpy`` carry the reference's
parameters across, key for key and bit for bit.

Mamba mixers and MoE MLPs wait for a later slice of the port (ROADMAP
Queue 1) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import (ParamDef, init_from_defs, mlp_apply,
                                       mlp_param_defs, rms_norm, torch_dtype)

Params = Dict[str, Any]


def _check_supported(cfg: ModelConfig) -> None:
    for mixer, mlp in cfg.layer_pattern():
        if mixer != "attn" or mlp == "moe":
            raise NotImplementedError(
                f"{cfg.name}: the ({mixer}, {mlp}) block needs "
                "models/mamba.py or models/moe.py, which wait for a later "
                "slice of the port (ROADMAP Queue 1)")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _block_defs(cfg: ModelConfig, mixer: str, mlp: str
                ) -> Dict[str, Dict[str, ParamDef]]:
    d = cfg.d_model
    out: Dict[str, Dict[str, ParamDef]] = {
        "norm_mixer": {"w": ParamDef((d,), ("embed",), init="ones")},
    }
    out["mixer"] = attention.param_defs(cfg)
    if mlp != "none":
        out["norm_mlp"] = {"w": ParamDef((d,), ("embed",), init="ones")}
        out["mlp"] = mlp_param_defs(cfg)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Parameters drawn from ``generator`` (on its device) and placed on
    ``device`` (default: the generator's): the reference's distributions
    (embed and lm_head normal x 0.02, weights normal / sqrt(fan_in), norms
    ones), in ``cfg.param_dtype``. The numbers differ from the reference's
    ``jax.random`` draws; tests carry weights across with
    :func:`params_from_numpy`."""
    _check_supported(cfg)
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
    _check_supported(cfg)
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


def activation_weights(params: Params, cfg: ModelConfig) -> Params:
    """``params`` with every matrix that the forward casts at use
    (``.to(x.dtype)``: the attention and MLP projections) cast once to
    ``cfg.dtype``; norms and the embedding stay as they are. The forward
    gives the same numbers from either tree; this one spares the copy each
    use makes (every projection, every step) for the cost of holding it."""
    dt = torch_dtype(cfg.dtype)
    out = dict(params)
    out["blocks"] = [
        {g: ({n: (w.to(dt) if w.dim() == 3 else w) for n, w in grp.items()}
             if g in ("mixer", "mlp") else grp)
         for g, grp in pos.items()}
        for pos in params["blocks"]]
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
    x = params["embed"][0][tokens[..., 0]].to(dt)
    for k in range(1, cfg.n_codebooks):
        x = x + params["embed"][k][tokens[..., k]].to(dt)
    return x


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, K, Vp) in float32; padded columns -1e30."""
    vp = cfg.padded_vocab
    B, S, _ = x.shape
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,kvd->bskv", x.float(),
                              params["embed"].float())
    else:
        logits = (x.float() @ params["lm_head"].float()).reshape(
            B, S, cfg.n_codebooks, vp)
    if vp != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _mlp_residual(cfg, pos_params, mlp: str, x):
    """The block's second half: x + mlp(norm(x)), or x without an MLP."""
    if mlp == "none":
        return x
    h = rms_norm(x, pos_params["norm_mlp"]["w"], cfg.norm_eps)
    return x + mlp_apply(pos_params["mlp"], cfg, h)


def _apply_block(cfg, pos_params, mixer: str, mlp: str, x, positions, aux):
    h = rms_norm(x, pos_params["norm_mixer"]["w"], cfg.norm_eps)
    x = x + attention.apply(pos_params["mixer"], cfg, h, positions)
    return _mlp_residual(cfg, pos_params, mlp, x), aux


def _prefix(params, cfg, tokens, vision_embeds):
    x = embed_tokens(params, cfg, tokens)
    if cfg.n_prefix and vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def hidden_states(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  vision_embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """forward() up to (but not including) the logit projection."""
    _check_supported(cfg)
    x, positions = _prefix(params, cfg, tokens, vision_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pattern = cfg.layer_pattern()
    for r in range(cfg.n_repeats):
        for pos, (mixer, mlp) in enumerate(pattern):
            x, aux = _apply_block(cfg, _layer(params["blocks"][pos], r),
                                  mixer, mlp, x, positions, aux)
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


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Tuple[Any, ...]:
    """One ``{"k", "v"}`` dict per pattern position, each (R, batch,
    max_seq, KH, hd)."""
    _check_supported(cfg)
    shape = (cfg.n_repeats, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return tuple({n: torch.zeros(shape, dtype=dtype, device=device)
                  for n in ("k", "v")} for _ in cfg.layer_pattern())


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Tuple[Any, ...], cache_len
                ) -> Tuple[torch.Tensor, Tuple[Any, ...]]:
    """One new token per sequence against a filled cache.

    tokens: (B, 1) or (B, 1, K); cache_len: int (tokens in the cache).
    Writes the new k/v into ``cache`` in place and returns (logits
    (B, 1, K, Vp), cache).
    """
    _check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    pattern = cfg.layer_pattern()
    for r in range(cfg.n_repeats):
        for pos, (mixer, mlp) in enumerate(pattern):
            p = _layer(params["blocks"][pos], r)
            h = rms_norm(x, p["norm_mixer"]["w"], cfg.norm_eps)
            c = {n: t[r] for n, t in cache[pos].items()}
            out, _ = attention.decode(p["mixer"], cfg, h, c, cache_len)
            x = _mlp_residual(cfg, p, mlp, x + out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(params, cfg, x), cache


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: int, vision_embeds: Optional[torch.Tensor] = None,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Tuple[Any, ...]]:
    """Run the prompt through the model, returning last-position logits and
    a cache sized ``max_seq`` ready for decode_step."""
    _check_supported(cfg)
    x, positions = _prefix(params, cfg, tokens, vision_embeds)
    B = x.shape[0]
    cache = init_cache(cfg, B, max_seq, cache_dtype, x.device)
    pattern = cfg.layer_pattern()
    for r in range(cfg.n_repeats):
        for pos, (mixer, mlp) in enumerate(pattern):
            p = _layer(params["blocks"][pos], r)
            h = rms_norm(x, p["norm_mixer"]["w"], cfg.norm_eps)
            q_out, kv = _attn_prefill(p["mixer"], cfg, h, positions,
                                      max_seq, cache_dtype)
            for n in ("k", "v"):
                cache[pos][n][r] = kv[n]
            x = _mlp_residual(cfg, p, mlp, x + q_out)
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
    kv["k"][:, :S] = k
    kv["v"][:, :S] = v
    return out, kv
