"""The port's LM examples (``examples/torch/fault_tolerant_train.py``,
``serve_lm.py``, ``train_lm.py``) against the reference's scripts of the
same names, on the CPU.

Each test loads the reference script by path and runs it (``main()`` with
``sys.argv`` patched, or ``demo``), capturing what it prints and recording
what its runner or engine returned; then it runs the port's script with
``--device cpu`` at the same arguments, with the reference's initial
parameters carried across (``model.params_from_numpy``: for the runners
in place of the port's ``init_params``, for ``serve_lm`` through
``demo(params=)``).

* ``fault_tolerant_train``: the eviction windows and the plan's crash steps
  equal the reference's; the port's clean and faulted runs are bitwise
  equal; the clean losses are within 1e-5 of the reference's (the bar of
  ``tests/test_torch_train.py``).
* ``serve_lm``, each of the four architectures: the prompts are bitwise
  the reference's ``jax.random.randint(PRNGKey(1), ...)``; the greedy
  token ids are equal. The example's own dtype is f32 (``reduced`` sets
  it) with the serving path's bf16 cache, so the f32 run is the example's
  run; its prefill logits and the logits of every decode step along the
  greedy trajectory are held at the bf16-cache bar of
  ``tests/test_torch_models.py`` (1e-3).
* ``train_lm --small`` for 30 steps, where the reference's own run lowers
  its loss (its assertion): losses within 1e-5 of the reference's.

Lines that print a time, a rate or a loss rounded to 4 places are compared
with those fields masked; the losses are compared as numbers.
"""
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.model as ref_model
import repro_torch.configs as configs
from repro_torch.models import model

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 1e-5
LOGIT_ATOL = 1e-3
TRAIN_STEPS = 30

torch.set_num_threads(1)


def load_script(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(name):
    return (load_script(ROOT / "examples" / f"{name}.py", f"ref_ex_{name}"),
            load_script(ROOT / "examples" / "torch" / f"{name}.py",
                        f"port_ex_{name}"))


def _record_runs(monkeypatch, ref):
    """The reports of every reference ``FaultTolerantRunner.run``."""
    reports = []

    class Recorded(ref.FaultTolerantRunner):
        def run(self, *a, **kw):
            rep = super().run(*a, **kw)
            reports.append(rep)
            return rep

    monkeypatch.setattr(ref, "FaultTolerantRunner", Recorded)
    return reports


def _carry_reference_init(monkeypatch, ref_cfg, seed=0):
    """The port's runners start from the reference's initial parameters
    (``jax.random.PRNGKey(seed)``, the reference runner's draw)."""
    ref_p = jax.tree.map(np.asarray,
                         ref_model.init_params(jax.random.PRNGKey(seed),
                                               ref_cfg))
    monkeypatch.setattr(
        model, "init_params",
        lambda cfg, generator, device=None: model.params_from_numpy(
            cfg, ref_p, device))


_LOSSES = re.compile(r"^(clean|faulted) +losses: \[(.*)\]$")


def test_fault_tolerant_train_matches_reference(monkeypatch, capsys):
    ref, port = _pair("fault_tolerant_train")
    reports = _record_runs(monkeypatch, ref)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["fault_tolerant_train.py"])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    ref_clean, ref_faulted = reports

    _carry_reference_init(monkeypatch, dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config("qwen3-4b")),
        remat_policy="none"))
    res = port.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()

    # the simulator's eviction windows and the plan: exact
    assert got[:2] == want[:2]
    assert want[0].startswith("simulated cluster: evictions in windows [")
    assert str(res["removal_windows"]) in want[0]
    assert res["crashes"] == sorted(int(s) for s in re.findall(
        r"\d+", want[1].split("steps")[1]))
    assert res["crashes"], "the churny trace must give the plan crashes"
    # the port's trajectories: bitwise equal through the recoveries
    assert res["identical"]
    assert res["clean"]["losses"] == res["faulted"]["losses"]
    assert res["faulted"]["recoveries"] == ref_faulted["recoveries"]
    # the losses: within 1e-5 of the reference's, lines masked
    np.testing.assert_allclose(res["clean"]["losses"], ref_clean["losses"],
                               rtol=0, atol=LOSS_ATOL)
    mask = [_LOSSES.sub(r"\1 losses: <losses>", ln) for ln in want]
    assert [_LOSSES.sub(r"\1 losses: <losses>", ln) for ln in got] == mask
    assert sum("<losses>" in ln for ln in mask) == 2


ARCHS = ("qwen3-4b", "mamba2-780m", "llava-next-34b", "musicgen-medium")
_TIMING = re.compile(r"in +\d+\.\ds \( *\d+\.\d tok/s\)")


def _serve_cfgs(arch):
    out = []
    for c in (ref_configs, configs):
        cfg = dataclasses.replace(c.reduced(c.get_config(arch)),
                                  remat_policy="none")
        if cfg.ssm_chunk:
            cfg = dataclasses.replace(cfg, ssm_chunk=8)
        out.append(cfg)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_matches_reference(arch, monkeypatch, capsys):
    ref, port = _pair("serve_lm")
    calls = []

    class Recorded(ref.ServingEngine):
        def generate(self, tokens, n_tokens, vision_embeds=None):
            out = super().generate(tokens, n_tokens, vision_embeds)
            calls.append((tokens, vision_embeds, out, self.max_seq))
            return out

    monkeypatch.setattr(ref, "ServingEngine", Recorded)
    capsys.readouterr()
    ref.demo(arch)
    want = capsys.readouterr().out.splitlines()
    (prompts, vis, ref_out, max_seq), = calls

    ref_cfg, cfg = _serve_cfgs(arch)
    assert cfg.dtype == "float32"       # the example's own dtype
    ref_p = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    p = model.params_from_numpy(cfg, jax.tree.map(np.asarray, ref_p))
    res = port.demo(arch, params=p, device="cpu")
    got = capsys.readouterr().out.splitlines()

    assert res["prompts"].dtype == torch.int32
    np.testing.assert_array_equal(res["prompts"].numpy(),
                                  np.asarray(prompts))
    np.testing.assert_array_equal(res["out"].numpy(), np.asarray(ref_out))
    assert len(want) == len(got) == 1
    assert _TIMING.sub("<timing>", got[0]) == _TIMING.sub("<timing>",
                                                          want[0])
    assert "<timing>" in _TIMING.sub("<timing>", want[0])

    # the logits along the greedy trajectory: prefill, then each step
    toks = res["prompts"]
    pvis = None if vis is None else torch.from_numpy(np.array(vis))
    with torch.inference_mode():
        got_l, cache = model.prefill(p, cfg, toks, max_seq,
                                     vision_embeds=pvis)
    want_l, ref_cache = ref_model.prefill(ref_p, ref_cfg, prompts, max_seq,
                                          vision_embeds=vis)
    err = [float(np.abs(got_l.numpy() - np.asarray(want_l)).max())]
    start = toks.shape[1] + (cfg.n_prefix if vis is not None else 0)
    ids = np.asarray(ref_out)
    for i in range(ids.shape[1] - 1):
        nxt = np.array(ids[:, i:i + 1])
        with torch.inference_mode():
            got_l, cache = model.decode_step(p, cfg, torch.from_numpy(nxt),
                                             cache, start + i)
        want_l, ref_cache = ref_model.decode_step(
            ref_p, ref_cfg, jnp.asarray(nxt), ref_cache,
            jnp.asarray(start + i, jnp.int32))
        err.append(float(np.abs(got_l.numpy() - np.asarray(want_l)).max()))
    assert max(err) <= LOGIT_ATOL, err


def test_serve_lm_main_serves_the_four_archs(capsys):
    """The port's ``main`` at its defaults (the port's own parameters)."""
    _, port = _pair("serve_lm")
    res = port.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert list(res) == list(ARCHS)
    assert [ln.split()[0] for ln in lines] == list(ARCHS)
    for arch, r in res.items():
        want = (4, 16, 4) if arch == "musicgen-medium" else (4, 16)
        assert r["shape"] == want and tuple(r["out"].shape) == want


_STEP = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})$")


def test_train_lm_small_matches_reference(monkeypatch, capsys, tmp_path):
    ref, port = _pair("train_lm")
    reports = _record_runs(monkeypatch, ref)
    args = ["--small", "--steps", str(TRAIN_STEPS)]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *args, "--ckpt-dir",
                                      str(tmp_path / "ref")])
    ref.main()          # asserts that its loss went down
    want = capsys.readouterr().out.splitlines()
    (ref_rep,) = reports
    assert len(ref_rep["losses"]) == TRAIN_STEPS

    _carry_reference_init(monkeypatch, ref.build_cfg(True))
    res = port.main([*args, "--ckpt-dir", str(tmp_path / "port"),
                     "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    np.testing.assert_allclose(res["losses"], ref_rep["losses"], rtol=0,
                               atol=LOSS_ATOL)
    assert res["losses"][-1] < res["losses"][0]
    assert (tmp_path / "port").is_dir()

    # describe, the step indices, ln V and the floor: as printed
    assert got[0] == want[0]
    steps_w = [_STEP.match(ln) for ln in want if _STEP.match(ln)]
    steps_g = [_STEP.match(ln) for ln in got if _STEP.match(ln)]
    assert [m.group(1) for m in steps_g] == [m.group(1) for m in steps_w]
    assert len(steps_w) == 15
    tail = lambda lines: [ln.split(")")[0].split("(")[1] for ln in lines
                          if ln.startswith("final loss")]
    assert tail(got) == tail(want) == [
        "uniform = ln V = 6.24;  copy-rule floor ~= 3.12"]
    assert got[-1].startswith(f"{TRAIN_STEPS} steps in ")
