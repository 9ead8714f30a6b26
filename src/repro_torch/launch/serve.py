"""Serving driver on the PyTorch port: batched prefill + greedy decode.

  # qwen3-4b at full width on the card (kernel F in every prefill layer):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --batch 4 --prompt-len 512 --gen 32

  # the reduced config on the CPU (kernel F's plain version):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --reduced --device cpu

  # the SSD and MoE families (mamba2-780m has no attention layer, so
  # --attention-impl is moot there):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
      --reduced --device cpu

Prints the reference CLI's two lines. Parameters and prompts are drawn
from ``--seed`` with ``torch.Generator`` (not the reference's jax.random
numbers).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.serve.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises if there is none)")
    ap.add_argument("--attention-impl", choices=("xla", "pallas"),
                    default="pallas",
                    help="pallas: kernel F (the hand-written CUDA kernel on "
                         "the card, its plain version on the CPU); xla: the "
                         "plain einsum attention")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), remat_policy="none")
    cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_mod.init_params(cfg, gen, dev)
    max_seq = args.prompt_len + cfg.n_prefix + args.gen + 1
    engine = ServingEngine(cfg, params, max_seq=max_seq)

    tok_shape = ((args.batch, args.prompt_len, cfg.n_codebooks)
                 if cfg.n_codebooks > 1 else (args.batch, args.prompt_len))
    tokens = torch.randint(0, cfg.vocab_size, tok_shape, generator=gen,
                           device=dev, dtype=torch.int32)
    vis = (torch.zeros((args.batch, cfg.n_prefix, cfg.d_model),
                       dtype=torch.float32, device=dev)
           if cfg.n_prefix else None)

    t0 = time.time()
    out = engine.generate(tokens, args.gen, vision_embeds=vis)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    total_new = args.batch * args.gen
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} wall={wall:.2f}s tok/s={total_new / wall:.1f}")
    print("sample completion ids:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
