"""Batched serving example: prefill a batch of prompts, decode greedily,
compare an attention arch vs an attention-free SSM (same API).

The port of ``examples/serve_lm.py``: the same steps, defaults and lines,
on the CUDA card unless ``--device cpu`` is passed. The prompts come from
the port's threefry stream (``core.prng``), bitwise the reference's
``jax.random.randint(PRNGKey(1), ...)``; the parameters from the port's
``init_params`` with a ``torch.Generator`` seeded 0 (not the reference's
numbers; ``demo(params=)`` takes any others, e.g. the reference's carried
across with ``model.params_from_numpy``).

Run:  PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.serve.engine import ServingEngine

ARCHS = ("qwen3-4b", "mamba2-780m", "llava-next-34b", "musicgen-medium")


def demo(arch: str, batch=4, prompt_len=32, gen=16, params=None,
         device=None) -> dict:
    device = resolve_device(device)
    cfg = dataclasses.replace(reduced(get_config(arch)), remat_policy="none")
    if cfg.ssm_chunk:
        cfg = dataclasses.replace(cfg, ssm_chunk=8)
    if params is None:
        params = model_mod.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
    engine = ServingEngine(cfg, params,
                           max_seq=prompt_len + cfg.n_prefix + gen + 1)
    shape = ((batch, prompt_len, cfg.n_codebooks) if cfg.n_codebooks > 1
             else (batch, prompt_len))
    prompts = prng.randint(prng.key(1, device), 0, cfg.vocab_size,
                           shape).to(torch.int32)
    vis = (torch.zeros((batch, cfg.n_prefix, cfg.d_model),
                       dtype=torch.float32, device=device)
           if cfg.n_prefix else None)
    t0 = time.time()
    out = engine.generate(prompts, gen, vision_embeds=vis)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    first = out[0].reshape(-1)[:6].tolist()
    print(f"{arch:<24} batch={batch} prompt={prompt_len} gen={gen} "
          f"-> {tuple(out.shape)} in {wall:5.1f}s ({batch*gen/wall:6.1f} tok/s) "
          f"first ids: {first}")
    return dict(shape=tuple(out.shape), wall_s=wall,
                tok_per_s=batch * gen / wall, first_ids=first,
                prompts=prompts.cpu(), out=out.cpu())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises if there is none)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return {arch: demo(arch, device=device) for arch in ARCHS}


if __name__ == "__main__":
    main()
