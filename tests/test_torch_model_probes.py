"""The dry-run's probe entry points of the port's model
(``single_repeat``, ``single_repeat_decode``, ``head_and_embed_loss``)
against the reference's, for all ten architectures at reduced width in
f32, on the CPU: the same numpy inputs and the same weights (drawn
once by the port's ``init_params`` and carried across with
``params_from_numpy``) go through both packages, the reference's under
``jax.jit``.

Bars (those of the MoE and SSD parity tests): outputs, caches and losses
within 1e-5 of max(1, the largest reference value); the MoE aux loss
within rtol 1e-5; gradients against ``jax.grad`` within 1e-5 of max(1,
each leaf's largest value)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.model as ref_model
import repro_torch.configs as configs
from repro_torch.models import model

torch.set_num_threads(1)

B, S = 2, 16
CACHE_LEN = 5


def _cfgs(arch, **over):
    """(reference cfg, port cfg) at reduced width in f32, equal field for
    field; SSD chunks of 8 so that a sequence spans two chunks."""
    base = dict(remat_policy="none", ssm_chunk=8, dtype="float32")
    base.update(over)
    ref = dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config(arch)), **base)
    mine = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               **base)
    assert dataclasses.asdict(ref) == dataclasses.asdict(mine)
    return ref, mine


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """Weights of ``arch`` (reduced, f32) as numpy arrays in the
    reference's tree: drawn once per architecture by the port's
    ``init_params`` (the reference's distributions, seed 0), cheaper than
    ``jax.random`` op by op."""
    _, cfg = _cfgs(arch)
    return model.params_to_numpy(model.init_params(
        cfg, torch.Generator().manual_seed(0)))


def _params(ref_cfg, cfg):
    """The same weights in both packages: the reference's as jax arrays,
    the port's carried across with ``params_from_numpy``."""
    w = _weights(cfg.name)
    return (jax.tree.map(jnp.asarray, w), model.params_from_numpy(cfg, w))


def _repeat0(ref_p, p):
    """Repeat 0 of every pattern position, in both packages."""
    ref_r = [jax.tree.map(lambda a: a[0], pos) for pos in ref_p["blocks"]]
    return ref_r, [model._layer(pos, 0) for pos in p["blocks"]]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_rel(got, want, rel=1e-5):
    w = _np(want)
    g = _np(got)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = np.abs(g - w).max()
    assert err <= rel * max(1.0, np.abs(w).max()), err


def _tokens(cfg, seed, n):
    shape = (B, n, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, n)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_single_repeat_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_p, p = _params(ref_cfg, cfg)
    ref_r, r = _repeat0(ref_p, p)
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, want_aux = jax.jit(
        lambda rr, xx, pp: ref_model.single_repeat(rr, ref_cfg, xx, pp))(
        ref_r, jnp.asarray(x), jnp.asarray(pos))
    got, aux = model.single_repeat(r, cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()))
    _close_rel(got, want)
    if cfg.n_experts:
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    else:
        assert float(aux) == float(want_aux) == 0.0


def _caches(ref_cfg, cfg, seed):
    """Per-position caches of one repeat (the repeat dim sliced away),
    filled with the same random numbers in both packages: f32 k/v up to
    the cache length, random SSM and conv states."""
    rng = np.random.default_rng(seed)
    ref_c = ref_model.init_cache(ref_cfg, B, S, jnp.float32)
    ref_out, mine = [], []
    for pos in ref_c:
        vals = {}
        for n, leaf in pos.items():
            a = rng.standard_normal(leaf.shape[1:]).astype(np.float32)
            if n in ("k", "v"):
                a[:, CACHE_LEN:] = 0.0
            vals[n] = a
        ref_out.append({n: jnp.asarray(a) for n, a in vals.items()})
        mine.append({n: torch.from_numpy(a.copy()) for n, a in vals.items()})
    return tuple(ref_out), tuple(mine)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_single_repeat_decode_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch, capacity_factor=16.0)
    ref_p, p = _params(ref_cfg, cfg)
    ref_r, r = _repeat0(ref_p, p)
    ref_c, c = _caches(ref_cfg, cfg, 2)
    x = np.random.default_rng(3).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    want, want_c = jax.jit(
        lambda rr, xx, cc, n: ref_model.single_repeat_decode(
            rr, ref_cfg, xx, cc, n))(ref_r, jnp.asarray(x), ref_c,
                                     jnp.int32(CACHE_LEN))
    got, got_c = model.single_repeat_decode(r, cfg, torch.from_numpy(x), c,
                                            CACHE_LEN)
    _close_rel(got, want)
    assert len(got_c) == len(want_c)
    for g, w in zip(got_c, want_c):
        assert set(g) == set(w)
        for n in w:
            _close_rel(g[n], w[n])


def _head_inputs(cfg, seed):
    toks = _tokens(cfg, seed, S)
    labels = _tokens(cfg, seed + 1, S)
    labels[0, :3] = -1
    hid = np.random.default_rng(seed + 2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return toks, labels, hid


HEAD_KEYS = ("embed", "final_norm", "lm_head")


@pytest.mark.parametrize("chunked", [False, True], ids=["full", "chunked"])
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_head_and_embed_loss_and_gradient_match_jax(arch, chunked):
    ref_cfg, cfg = _cfgs(arch, chunked_ce=chunked)
    ref_p, p = _params(ref_cfg, cfg)
    ref_h = {k: v for k, v in ref_p.items() if k in HEAD_KEYS}
    h = {k: v.clone().requires_grad_() for k, v in p.items()
         if k in HEAD_KEYS}
    toks, labels, hid = _head_inputs(cfg, 4)
    want, gwant = jax.jit(jax.value_and_grad(
        lambda q, tk, lb, hh: ref_model.head_and_embed_loss(
            q, ref_cfg, tk, lb, hh)))(ref_h, jnp.asarray(toks),
                                      jnp.asarray(labels), jnp.asarray(hid))
    got = model.head_and_embed_loss(h, cfg, torch.from_numpy(toks),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(hid))
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * max(
        1.0, abs(float(want)))
    got.backward()
    assert set(gwant) == set(h)
    for k, w in gwant.items():
        assert np.isfinite(_np(h[k].grad)).all(), k
        _close_rel(h[k].grad, w)


def test_head_and_embed_loss_honours_chunked_ce():
    """The chunked path runs the chunked loss (on the CPU its plain scan)
    and the full-logit path the full one, with the same value."""
    _, cfg = _cfgs("qwen3-4b")
    _, p = _params(*_cfgs("qwen3-4b"))
    toks, labels, hid = (torch.from_numpy(a)
                         for a in _head_inputs(cfg, 5))
    calls = []
    orig = model.cross_entropy_chunked_plain

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    model.cross_entropy_chunked_plain = spy
    try:
        full = model.head_and_embed_loss(p, cfg, toks, labels, hid)
        assert not calls
        chunked = model.head_and_embed_loss(
            p, dataclasses.replace(cfg, chunked_ce=True), toks, labels, hid)
        assert calls == [1]
    finally:
        model.cross_entropy_chunked_plain = orig
    assert abs(float(full) - float(chunked)) <= 1e-5
