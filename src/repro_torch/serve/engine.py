"""Batched serving: prefill + greedy decode loops.

A copy of ``repro.serve.engine`` in PyTorch: ``make_prefill_step`` (with
the batch-microbatched path), ``make_decode_step``, ``sample_greedy`` and
``ServingEngine``. PyTorch runs eagerly, so the steps are plain functions
where the reference jits them.

On a mesh the engine runs under ``distributed.sharding.axis_rules`` (in
'serve' or 'serve_seq' mode, as ``placement.choose_serve_mode`` decides)
with parameters placed by ``placement.param_shardings``; the prefill
allocates its cache by ``model.cache_logical_axes``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import model


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    M = max(cfg.prefill_microbatches, 1)

    def prefill_step(params, tokens, vision_embeds=None):
        if M <= 1 or tokens.shape[0] % M:
            return model.prefill(params, cfg, tokens, max_seq,
                                 vision_embeds=vision_embeds)
        # batch-microbatched prefill: activation transients / M. Chunk m
        # takes the interleaved rows m::M, as in the reference; the merge
        # puts each chunk's rows back in their places (batch is axis 1 of
        # every cache leaf: k/v, and the SSM and conv states).
        logits = caches = None
        for m in range(M):
            vis = vision_embeds[m::M] if vision_embeds is not None else None
            lg, cache = model.prefill(params, cfg, tokens[m::M], max_seq,
                                      vision_embeds=vis)
            if logits is None:
                logits = lg.new_empty((tokens.shape[0],) + lg.shape[1:])
                caches = tuple(
                    {n: t.new_empty(t.shape[:1] + logits.shape[:1]
                                    + t.shape[2:]) for n, t in c.items()}
                    for c in cache)
            logits[m::M] = lg
            for full, part in zip(caches, cache):
                for n in full:
                    full[n][:, m::M] = part[n]
        return logits, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, tokens, cache, cache_len):
        return model.decode_step(params, cfg, tokens, cache, cache_len)
    return decode_step


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: (B, 1, K, Vp) -> tokens (B, 1) or (B, 1, K) int32; the first
    index wins a tie."""
    if sharding.is_dtensor(logits):
        # argmax: DTensor's strategy for a split vocab dim fails where
        # another mesh dim is Replicate ('serve_seq'), so the vocab is
        # gathered first (B x Vp values a step)
        logits = sharding.gather_dim(logits, -1)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if tok.shape[-1] == 1:
        tok = tok[..., 0]
    return tok


class ServingEngine:
    """Minimal batched engine: submit prompts, generate N tokens greedily.

    The engine holds ``params`` and, beside them, the leaves that each use
    casts to the activation dtype (the projections; see
    ``model.activation_weights``) cast once: the same numbers as casting at
    each use, without the per-step copies; with f32 parameters and bf16
    activations it costs half those leaves' f32 size in memory. The MoE
    expert stacks stay f32 and are cast at each use.
    """

    def __init__(self, cfg: ModelConfig, params, max_seq: int):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self._run_params = model.activation_weights(params, cfg)
        self._prefill = make_prefill_step(cfg, max_seq)
        self._decode = make_decode_step(cfg)

    def generate(self, tokens: torch.Tensor, n_tokens: int,
                 vision_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """tokens: (B, S[, K]) prompt; returns (B, n_tokens[, K])
        completions (int32). Runs under ``inference_mode``, or under
        ``no_grad`` while a mesh is active (DTensor makes views, which
        inference tensors do not allow)."""
        mesh, _ = sharding._current()
        with (torch.inference_mode() if mesh is None else torch.no_grad()):
            return self._generate(tokens, n_tokens, vision_embeds)

    def _generate(self, tokens, n_tokens, vision_embeds):
        S = tokens.shape[1]
        logits, cache = self._prefill(self._run_params, tokens,
                                      vision_embeds)
        prompt_len = S + (self.cfg.n_prefix if vision_embeds is not None
                          else 0)
        outs = []
        tok = sample_greedy(logits)
        for i in range(n_tokens):
            outs.append(tok)
            if i == n_tokens - 1:
                break
            logits, cache = self._decode(self._run_params, tok, cache,
                                         prompt_len + i)
            tok = sample_greedy(logits)
        return torch.cat(outs, dim=1)
