"""The port's SSD, hybrid and MoE families against the reference's, on the
CPU at the reference's reduced widths (mamba2-780m, jamba-1.5-large-398b,
qwen2-moe-a2.7b, qwen3-moe-235b-a22b): the same numpy inputs and the same
weights (carried across with ``params_from_numpy``) go through both
packages.

Bars: the parameter tree and its round trip exact; ``forward`` logits
within 1e-4 and the MoE aux loss within rtol 1e-5; ``prefill`` plus 3
``decode_step``s within 1e-4 with an f32 cache, the SSM states and k/v
within 1e-5 of max(1, their largest value).
Every entry point runs for all ten architectures at reduced width. The
reference's own serving properties (``tests/test_decode.py``) run on the
port with their bars; ``activation_weights`` changes no served number;
the microbatched prefill places the SSM states; both CLIs run on the CPU.
The gradients are in ``tests/test_torch_model_families_grad.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.model as ref_model
import repro_torch.configs as configs
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model
from repro_torch.serve.engine import make_prefill_step

torch.set_num_threads(1)

FAMILIES = ["mamba2-780m", "jamba-1.5-large-398b", "qwen2-moe-a2.7b",
            "qwen3-moe-235b-a22b"]
B, S = 2, 16


def _cfgs(arch, **over):
    """(reference cfg, port cfg) at reduced width, equal field for field;
    SSD chunks of 8 so that the prompts span several chunks."""
    base = dict(remat_policy="none", ssm_chunk=8)
    base.update(over)
    ref = dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config(arch)), **base)
    mine = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               **base)
    assert dataclasses.asdict(ref) == dataclasses.asdict(mine)
    return ref, mine


def _params(ref_cfg, cfg, seed=0):
    ref_p = ref_model.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_p, model.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_p))


def _tokens(seed, cfg, n):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol):
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= atol, err


def _close_rel(got, want, rel):
    w = _np(want)
    err = np.abs(_np(got) - w).max()
    assert err <= rel * max(1.0, np.abs(w).max()), err


# --- parameters -----------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_params_tree_and_round_trip_exact(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_p = jax.tree.map(np.asarray, ref_model.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    back = model.params_to_numpy(model.params_from_numpy(cfg, ref_p))
    assert jax.tree.structure(back) == jax.tree.structure(ref_p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    mine = model.params_to_numpy(model.init_params(
        cfg, torch.Generator().manual_seed(0)))
    assert jax.tree.structure(mine) == jax.tree.structure(ref_p)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref_p)):
        assert a.shape == b.shape and a.dtype == b.dtype
    n = sum(a.size for a in jax.tree.leaves(mine))
    assert abs(n - cfg.param_count()) / cfg.param_count() < 0.02


# --- forward, prefill, decode ----------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_p, p = _params(ref_cfg, cfg)
    toks = _tokens(1, cfg, 2 * S)
    want, want_aux = ref_model.forward(ref_p, ref_cfg, jnp.asarray(toks))
    got, aux = model.forward(p, cfg, torch.from_numpy(toks))
    assert got.shape == want.shape
    _close(got, want, 1e-4)
    if cfg.n_experts:
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    else:
        assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_steps(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_p, p = _params(ref_cfg, cfg)
    toks = _tokens(2, cfg, S + 3)
    max_seq = S + 4
    want, ref_cache = ref_model.prefill(ref_p, ref_cfg,
                                        jnp.asarray(toks[:, :S]), max_seq,
                                        cache_dtype=jnp.float32)
    got, cache = model.prefill(p, cfg, torch.from_numpy(toks[:, :S]),
                               max_seq, cache_dtype=torch.float32)
    _close(got, want, 1e-4)
    for i in range(3):
        nxt = toks[:, S + i:S + i + 1]
        want, ref_cache = ref_model.decode_step(
            ref_p, ref_cfg, jnp.asarray(nxt), ref_cache,
            jnp.asarray(S + i, jnp.int32))
        got, cache = model.decode_step(p, cfg, torch.from_numpy(nxt), cache,
                                       S + i)
        _close(got, want, 1e-4)
        for (mixer, _), c, rc in zip(cfg.layer_pattern(), cache, ref_cache):
            assert set(c) == set(rc) == (
                {"k", "v"} if mixer == "attn" else {"ssm", "conv"})
            for n in c:
                assert c[n].dtype == torch.float32
                assert c[n].shape == rc[n].shape
                _close_rel(c[n], rc[n], 1e-5)


# the reference's serving properties (tests/test_decode.py), on the port
DECODE_ARCHS = ["qwen3-4b", "mamba2-780m", "jamba-1.5-large-398b",
                "qwen2-moe-a2.7b", "musicgen-medium"]
S_PROMPT, S_GEN = 24, 8


def _decode_cfg(arch):
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              remat_policy="none")
    if cfg.ssm_chunk:
        cfg = dataclasses.replace(cfg, ssm_chunk=8)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    return cfg


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_full_forward(arch):
    cfg = _decode_cfg(arch)
    p = model.init_params(cfg, torch.Generator().manual_seed(0))
    shape = ((B, S_PROMPT + S_GEN, cfg.n_codebooks) if cfg.n_codebooks > 1
             else (B, S_PROMPT + S_GEN))
    toks = torch.randint(0, cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(1))
    full, _ = model.forward(p, cfg, toks)
    logits, cache = model.prefill(p, cfg, toks[:, :S_PROMPT],
                                  max_seq=S_PROMPT + S_GEN,
                                  cache_dtype=torch.float32)
    outs = [logits]
    for i in range(S_GEN - 1):
        logits, cache = model.decode_step(
            p, cfg, toks[:, S_PROMPT + i:S_PROMPT + i + 1], cache,
            S_PROMPT + i)
        outs.append(logits)
    dec = torch.cat(outs, dim=1)
    ref = full[:, S_PROMPT - 1:S_PROMPT + S_GEN - 1]
    assert float((dec - ref).abs().max()) < 2e-2, arch
    agree = (dec.argmax(-1) == ref.argmax(-1)).float().mean()
    assert float(agree) > 0.98, arch


def test_moe_capacity_is_the_only_divergence():
    """tests/test_decode.py's pin, on the port: with a loose capacity factor
    the hybrid's prefill + decode reproduce its full forward within 1e-3."""
    loose = dataclasses.replace(
        configs.reduced(configs.get_config("jamba-1.5-large-398b")),
        remat_policy="none", ssm_chunk=8, capacity_factor=16.0)
    p = model.init_params(loose, torch.Generator().manual_seed(0))
    toks = torch.randint(0, loose.vocab_size, (B, 32),
                         generator=torch.Generator().manual_seed(1))
    full, _ = model.forward(p, loose, toks)
    logits, cache = model.prefill(p, loose, toks[:, :24], max_seq=32,
                                  cache_dtype=torch.float32)
    dec = [logits]
    for i in range(7):
        logits, cache = model.decode_step(p, loose, toks[:, 24 + i:25 + i],
                                          cache, 24 + i)
        dec.append(logits)
    err = (torch.cat(dec, 1) - full[:, 23:31]).abs().max()
    assert float(err) < 1e-3


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_arch_runs_every_entry_point(arch):
    """``init_params``, ``forward``, ``prefill``, ``decode_step`` and
    ``loss_fn`` run for all ten configurations at reduced width, with
    finite outputs of the reference's shapes."""
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              remat_policy="none", ssm_chunk=8)
    p = model.init_params(cfg, torch.Generator().manual_seed(0))
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    toks = torch.randint(0, cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(1))
    vis = (torch.ones((B, cfg.n_prefix, cfg.d_model)) if cfg.n_prefix
           else None)
    S_total = S + cfg.n_prefix
    logits, aux = model.forward(p, cfg, toks, vision_embeds=vis)
    assert logits.shape == (B, S_total, cfg.n_codebooks, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    last, cache = model.prefill(p, cfg, toks, S_total + 1,
                                vision_embeds=vis)
    assert last.shape == (B, 1, cfg.n_codebooks, cfg.padded_vocab)
    step_logits, _ = model.decode_step(p, cfg, toks[:, :1], cache, S_total)
    assert step_logits.shape == last.shape
    assert bool(torch.isfinite(step_logits[..., :cfg.vocab_size]).all())
    batch = {"tokens": toks, "labels": toks}
    if vis is not None:
        batch["vision_embeds"] = vis
    loss, metrics = model.loss_fn(p, cfg, batch)
    assert np.isfinite(float(loss)) and set(metrics) == {"ce", "moe_aux"}


# --- serving ---------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_activation_weights_give_the_same_numbers(arch):
    """bf16 serving from the cast tree == from the f32 tree, bitwise; the
    leaves read in f32 (router, shared_gate, A_log, D, dt_bias, norms) and
    the expert stacks stay f32."""
    _, cfg = _cfgs(arch, dtype="bfloat16")
    p = model.init_params(cfg, torch.Generator().manual_seed(3))
    run = model.activation_weights(p, cfg)
    for (mixer, mlp), pos in zip(cfg.layer_pattern(), run["blocks"]):
        for g, kind in (("mixer", mixer), ("mlp", mlp)):
            for n, w in pos.get(g, {}).items():
                want = (torch.bfloat16 if n in model.CAST_AT_USE[kind]
                        else torch.float32)
                assert w.dtype == want, (g, n)
        if mixer == "mamba":
            for n in ("A_log", "D", "dt_bias", "norm"):
                assert pos["mixer"][n].dtype == torch.float32
        if mlp == "moe":
            for n in ("router", "wi", "wo"):
                assert pos["mlp"][n].dtype == torch.float32
    toks = torch.from_numpy(_tokens(4, cfg, S))
    a, aux_a = model.forward(p, cfg, toks)
    b, aux_b = model.forward(run, cfg, toks)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    la, ca = model.prefill(p, cfg, toks, S + 2)
    lb, cb = model.prefill(run, cfg, toks, S + 2)
    assert torch.equal(la, lb)
    nxt = torch.from_numpy(_tokens(5, cfg, 1))
    assert torch.equal(model.decode_step(p, cfg, nxt, ca, S)[0],
                       model.decode_step(run, cfg, nxt, cb, S)[0])


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b"])
def test_microbatched_prefill_merges_ssm_states(arch):
    """Prefill in 2 batch microbatches (rows m::2) == in one, the SSM and
    conv states (batch on axis 1) placed row for row."""
    # a loose capacity: with C set by the tokens in a call, the two splits
    # would drop different tokens (tests/test_decode.py's pin)
    _, cfg = _cfgs(arch, capacity_factor=16.0)
    p = model.init_params(cfg, torch.Generator().manual_seed(5))
    toks = torch.randint(0, cfg.vocab_size, (4, S),
                         generator=torch.Generator().manual_seed(6))
    one = make_prefill_step(cfg, S + 4)(p, toks)
    two = make_prefill_step(dataclasses.replace(
        cfg, prefill_microbatches=2), S + 4)(p, toks)
    assert torch.allclose(one[0], two[0], atol=1e-5, rtol=0)
    n_ssm = 0
    for (mixer, _), c1, c2 in zip(cfg.layer_pattern(), one[1], two[1]):
        for n in c1:
            assert c1[n].shape == c2[n].shape and c1[n].shape[1] == 4
            assert torch.allclose(c1[n].float(), c2[n].float(),
                                  atol=1e-5, rtol=0), (mixer, n)
        n_ssm += mixer == "mamba"
    assert n_ssm > 0


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen2-moe-a2.7b"])
def test_serve_cli_runs_on_cpu(arch, capsys):
    out = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "16", "--gen",
                          "4"])
    assert out.shape == (2, 4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch} batch=2 prompt=16 gen=4 ")
    assert lines[1].startswith("sample completion ids: [")


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen2-moe-a2.7b"])
def test_train_cli_runs_on_cpu(arch, capsys, tmp_path):
    rep = train_cli.main(["--arch", arch, "--reduced", "--steps", "3",
                          "--batch", "2", "--seq-len", "32", "--device",
                          "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
                          "--log-every", "1"])
    assert rep["final_step"] == 3 and len(rep["losses"]) == 3
    assert all(np.isfinite(rep["losses"]))
    out = capsys.readouterr().out
    assert f"{arch}" in out and "final loss" in out
