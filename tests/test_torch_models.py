"""The port's LM layers, attention and model against the reference's, on
the CPU at reduced width (qwen3-4b, 2 layers): the same numpy inputs and
the same weights (carried across with ``params_from_numpy``) go through
both packages. Bars: layers, attention (both impls) and decode within
1e-5; prefill and decode_step logits within 1e-4, the bf16 caches within 1
bf16 ulp; the parameter round trip exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.attention as ref_attn
import repro.models.layers as ref_layers
import repro.models.model as ref_model
import repro_torch.configs as configs
from repro_torch.models import attention, layers, model

torch.set_num_threads(1)

B, S = 2, 24


def _cfgs(**over):
    """(reference cfg, port cfg), equal field for field."""
    ref = dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config("qwen3-4b")), n_layers=2,
        remat_policy="none", **over)
    mine = dataclasses.replace(configs.reduced(
        configs.get_config("qwen3-4b")), n_layers=2, remat_policy="none",
        **over)
    assert dataclasses.asdict(ref) == dataclasses.asdict(mine)
    return ref, mine


def _params(ref_cfg, cfg, seed=0):
    """The reference's initial parameters and the port's copy of them."""
    ref_p = ref_model.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_p, model.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_p))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(got, want, atol):
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= atol, err


def _within_one_bf16_ulp(a, b):
    """Each pair of bf16 values differs by at most one bf16 rounding step
    at the larger magnitude (2^-7 of its binade), or by at most 1e-6, the
    agreement of the f32 values before the cast, where a value is that
    small (a sum that cancels to ~1e-5 may round to bf16 values a few
    steps apart)."""
    a, b = _np(a), _np(b)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    excess = np.abs(a - b) - np.maximum(ulp, 1e-6)
    assert excess.max() <= 0, float(excess.max())


def _tokens(seed, cfg, n):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


# --- layers ---------------------------------------------------------------

def test_rms_norm_swiglu_rope():
    r = np.random.default_rng(1)
    x = r.standard_normal((B, S, 4, 32)).astype(np.float32)
    w = r.standard_normal(32).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-5)
    h = r.standard_normal((B, S, 64)).astype(np.float32)
    _close(layers.swiglu(torch.from_numpy(h)),
           ref_layers.swiglu(jnp.asarray(h)), 1e-5)
    pos = r.integers(0, 600, (B, S)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta)
        assert got.dtype == torch.float32
        _close(got, ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta), 1e-5)


def test_mlp_apply():
    ref_cfg, cfg = _cfgs()
    r = np.random.default_rng(2)
    p = {"wi": r.standard_normal((128, 512)).astype(np.float32) / 11,
         "wo": r.standard_normal((256, 128)).astype(np.float32) / 16}
    x = r.standard_normal((B, S, 128)).astype(np.float32)
    _close(layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            cfg, torch.from_numpy(x)),
           ref_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                ref_cfg, jnp.asarray(x)), 1e-5)


# --- attention -------------------------------------------------------------

def _attn_params(ref_cfg, cfg):
    ref_p, p = _params(ref_cfg, cfg)
    return (jax.tree.map(lambda a: a[0], ref_p["blocks"][0]["mixer"]),
            {k: v[0] for k, v in p["blocks"][0]["mixer"].items()})


def test_expand_kv_repeats_each_head_contiguously():
    k = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    got = attention._expand_kv(k, 6)
    want = ref_attn._expand_kv(jnp.asarray(k.numpy()), 6)
    assert torch.equal(got, torch.from_numpy(np.array(want)))
    assert torch.equal(got[:, :, 2], k[:, :, 0])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_apply(impl):
    ref_cfg, cfg = _cfgs(attention_impl=impl)
    ref_p, p = _attn_params(ref_cfg, cfg)
    r = np.random.default_rng(3)
    x = r.standard_normal((B, 32, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (B, 32))
    _close(attention.apply(p, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos.copy())),
           ref_attn.apply(ref_p, ref_cfg, jnp.asarray(x), jnp.asarray(pos)),
           1e-5)


def test_attention_chunked_path():
    ref_cfg, cfg = _cfgs()
    ref_p, p = _attn_params(ref_cfg, cfg)
    r = np.random.default_rng(4)
    x = r.standard_normal((B, 40, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (B, 40)).copy()
    q, k, v = attention._project_qkv(p, cfg, torch.from_numpy(x),
                                     torch.from_numpy(pos))
    k, v = (attention._expand_kv(t, cfg.n_heads) for t in (k, v))
    got = attention._chunked_causal_attend(q, k, v, 0.2, chunk=16)
    want = ref_attn._chunked_causal_attend(
        *[jnp.asarray(t.numpy()) for t in (q, k, v)], 0.2, chunk=16)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("cache_len", [0, 7, 15])
def test_attention_decode(cache_len):
    ref_cfg, cfg = _cfgs()
    ref_p, p = _attn_params(ref_cfg, cfg)
    r = np.random.default_rng(5 + cache_len)
    x = r.standard_normal((B, 1, 128)).astype(np.float32)
    kv = [r.standard_normal((B, 16, 2, 32)).astype(np.float32)
          for _ in range(2)]
    ref_cache = {n: jnp.asarray(a, jnp.bfloat16) for n, a in zip("kv", kv)}
    cache = {n: torch.from_numpy(a).to(torch.bfloat16)
             for n, a in zip("kv", kv)}
    want, want_c = ref_attn.decode(ref_p, ref_cfg, jnp.asarray(x),
                                   ref_cache, jnp.asarray(cache_len,
                                                          jnp.int32))
    got, got_c = attention.decode(p, cfg, torch.from_numpy(x), cache,
                                  cache_len)
    _close(got, want, 1e-5)
    for n in "kv":
        _within_one_bf16_ulp(got_c[n], want_c[n])


# --- model -----------------------------------------------------------------

def test_params_round_trip_exact():
    ref_cfg, cfg = _cfgs()
    ref_p = jax.tree.map(np.asarray, ref_model.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    back = model.params_to_numpy(model.params_from_numpy(cfg, ref_p))
    assert jax.tree.structure(back) == jax.tree.structure(ref_p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bad = dict(ref_p, final_norm=ref_p["final_norm"][:3])
    with pytest.raises(ValueError, match="shape"):
        model.params_from_numpy(cfg, bad)


def test_init_params_tree_and_distributions():
    ref_cfg, cfg = _cfgs()
    mine = model.params_to_numpy(model.init_params(
        cfg, torch.Generator().manual_seed(0)))
    ref = jax.tree.map(np.asarray, ref_model.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if b.std() == 0:
            assert np.array_equal(a, b)             # ones / zeros
        else:
            assert abs(a.std() / b.std() - 1) < 0.15
    again = model.params_to_numpy(model.init_params(
        cfg, torch.Generator().manual_seed(0)))
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(mine), jax.tree.leaves(again)))


@pytest.mark.parametrize("vocab", [512, 500])
def test_forward_logits(vocab):
    ref_cfg, cfg = _cfgs(vocab_size=vocab)
    ref_p, p = _params(ref_cfg, cfg)
    toks = _tokens(6, cfg, S)
    want, _ = ref_model.forward(ref_p, ref_cfg, jnp.asarray(toks))
    got, aux = model.forward(p, cfg, torch.from_numpy(toks))
    assert got.shape == (B, S, 1, 512) and float(aux) == 0.0
    _close(got, want, 1e-4)
    if vocab < 512:
        assert float(got[..., vocab:].max()) == np.float32(-1e30)


# decode_step's logits within 1e-4 with an f32 cache (the reference's own
# decode test keeps the cache in f32). With the bf16 cache the decode casts
# q, the probabilities and the new k/v to bf16, and where the two sides'
# f32 values (equal to ~1e-6) straddle a bf16 rounding boundary they round
# one step apart: a flip moves a logit by ~1e-4 (1.2e-4 seen), so there the
# bar is 1e-3 and the caches are held within one bf16 step.
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", [512, 500])
def test_prefill_and_decode_step(vocab, cache_dtype):
    ref_cfg, cfg = _cfgs(vocab_size=vocab)
    ref_p, p = _params(ref_cfg, cfg)
    toks = _tokens(7, cfg, S + 3)
    max_seq = S + 4
    want, ref_cache = ref_model.prefill(
        ref_p, ref_cfg, jnp.asarray(toks[:, :S]), max_seq,
        cache_dtype=getattr(jnp, cache_dtype))
    got, cache = model.prefill(p, cfg, torch.from_numpy(toks[:, :S]),
                               max_seq, cache_dtype=getattr(torch,
                                                            cache_dtype))
    _close(got, want, 1e-4)                   # prefill: no cast to bf16
    for i in range(3):
        nxt = toks[:, S + i:S + i + 1]
        want, ref_cache = ref_model.decode_step(
            ref_p, ref_cfg, jnp.asarray(nxt), ref_cache,
            jnp.asarray(S + i, jnp.int32))
        got, cache = model.decode_step(p, cfg, torch.from_numpy(nxt),
                                       cache, S + i)
        assert got.shape == (B, 1, 1, 512)
        _close(got, want, 1e-4 if cache_dtype == "float32" else 1e-3)
        if vocab < 512:
            assert float(got[..., vocab:].max()) == np.float32(-1e30)
        for c, rc in zip(cache, ref_cache):
            for n in "kv":
                assert c[n].dtype == getattr(torch, cache_dtype)
                if cache_dtype == "float32":
                    _close(c[n], rc[n], 1e-5)
                else:
                    _within_one_bf16_ulp(c[n], rc[n])


def test_activation_weights_give_the_same_numbers():
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    p = model.init_params(cfg, torch.Generator().manual_seed(3))
    run = model.activation_weights(p, cfg)
    assert run["blocks"][0]["mlp"]["wi"].dtype == torch.bfloat16
    assert run["blocks"][0]["mixer"]["q_norm"].dtype == torch.float32
    assert run["embed"] is p["embed"]
    toks = torch.from_numpy(_tokens(8, cfg, S))
    assert torch.equal(model.forward(p, cfg, toks)[0],
                       model.forward(run, cfg, toks)[0])
