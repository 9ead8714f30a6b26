"""The port's serving path against the reference's, on the CPU at reduced
width (qwen3-4b, 2 layers): ``ServingEngine.generate`` emits the same
tokens as the reference's engine on the same weights and prompts, for
both attention impls (pallas: the reference's Pallas kernel in interpret
mode, the port's kernel-F plain version) and with the prompt batch in 1 or
2 microbatches; the port's own prefill + decode reproduces its full
forward; the CLI runs to its end on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.model as ref_model
from repro.serve.engine import ServingEngine as RefServingEngine
import repro_torch.configs as configs
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model
from repro_torch.serve.engine import (ServingEngine, make_prefill_step,
                                      sample_greedy)

torch.set_num_threads(1)

B, S_PROMPT, S_GEN = 2, 24, 8


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_generate_matches_reference(impl, microbatches):
    over = dict(n_layers=2, remat_policy="none", attention_impl=impl,
                prefill_microbatches=microbatches)
    ref_cfg = dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config("qwen3-4b")), **over)
    cfg = dataclasses.replace(
        configs.reduced(configs.get_config("qwen3-4b")), **over)
    ref_p = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    p = model.params_from_numpy(cfg, jax.tree.map(np.asarray, ref_p))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S_PROMPT)).astype(np.int32)
    max_seq = S_PROMPT + S_GEN + 1
    want = RefServingEngine(ref_cfg, ref_p, max_seq).generate(
        jnp.asarray(toks), S_GEN)
    got = ServingEngine(cfg, p, max_seq).generate(torch.from_numpy(toks),
                                                  S_GEN)
    assert got.dtype == torch.int32 and got.shape == (B, S_GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_microbatched_prefill_keeps_row_order():
    cfg = dataclasses.replace(configs.reduced(
        configs.get_config("qwen3-4b")), n_layers=2)
    p = model.init_params(cfg, torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(3))
    one = make_prefill_step(cfg, 20)(p, toks)
    two = make_prefill_step(dataclasses.replace(
        cfg, prefill_microbatches=2), 20)(p, toks)
    assert torch.allclose(one[0], two[0], atol=1e-5, rtol=0)
    for c1, c2 in zip(one[1], two[1]):
        for n in ("k", "v"):
            assert c1[n].shape == c2[n].shape == (2, 4, 20, 2, 32)
            assert (c1[n].float() - c2[n].float()).abs().max() <= 2 ** -6


def test_sample_greedy_first_index_on_ties():
    logits = torch.zeros((2, 1, 1, 8))
    logits[0, 0, 0, [3, 5]] = 1.0
    logits[1, 0, 0, [6, 2]] = 2.0
    assert sample_greedy(logits).tolist() == [[3], [2]]
    multi = torch.zeros((1, 1, 4, 8))
    assert sample_greedy(multi).shape == (1, 1, 4)


@pytest.mark.parametrize("arch", ["qwen3-4b", "musicgen-medium"])
def test_decode_matches_full_forward(arch):
    """prefill + incremental decode reproduce the full forward's logits
    (the reference's own property and bar, tests/test_decode.py)."""
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              remat_policy="none")
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


def test_cli_runs_on_cpu(capsys):
    out = serve_cli.main(["--arch", "qwen3-4b", "--reduced", "--device",
                          "cpu", "--batch", "2", "--prompt-len", "16",
                          "--gen", "4"])
    assert out.shape == (2, 4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=qwen3-4b batch=2 prompt=16 gen=4 ")
    assert lines[1].startswith("sample completion ids: [")


def test_cli_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "qwen3-4b", "--reduced"])
