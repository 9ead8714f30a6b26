"""Training entry point on the PyTorch port.

Examples:
  # the reduced qwen3 on the CPU (kernel G is not on this path: the
  # reference's CLI trains with the full-logit loss):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --reduced --steps 3 --device cpu

  # on the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --reduced --steps 200 --batch 4 --seq-len 256

  # any of the ten architectures, e.g. the SSD and MoE families:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
      --reduced --steps 3 --device cpu

Fault tolerance is always on: periodic async checkpoints, SIGTERM-safe
preemption, optional simulator-driven fault injection (--inject-faults) and
straggler logging. Prints the reference CLI's lines. Parameters are drawn
from a ``torch.Generator`` seeded 0 (not the reference's jax.random
numbers).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

from repro_torch.config import SHAPES, TrainConfig, describe
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.fault import FaultPlan, FaultTolerantRunner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="width multiplier on the reduced config (e.g. 4 -> ~100M)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--inject-faults", type=int, nargs="*", default=None,
                    help="steps at which to inject simulated node failures")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises if there is none)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
        if args.scale != 1.0:
            s = args.scale
            cfg = dataclasses.replace(
                cfg, d_model=int(cfg.d_model * s), head_dim=int(32 * s) if cfg.head_dim else 0,
                d_ff=int(cfg.d_ff * s) if cfg.d_ff else 0,
                vocab_size=int(cfg.vocab_size * s))
        cfg = dataclasses.replace(cfg, remat_policy="none")
    if args.shape:
        shape = SHAPES[args.shape]
        args.batch, args.seq_len = shape.global_batch, shape.seq_len
        args.microbatches = shape.num_microbatches

    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     num_microbatches=args.microbatches,
                     checkpoint_every=args.ckpt_every,
                     checkpoint_dir=args.ckpt_dir,
                     grad_compression=args.grad_compression)
    plan = FaultPlan(crashes={s: "cli" for s in (args.inject_faults or [])})
    runner = FaultTolerantRunner(cfg, tc, batch=args.batch,
                                 seq_len=args.seq_len, fault_plan=plan,
                                 device=args.device)
    runner.install_preemption_handler()

    print(describe(cfg))
    t0 = time.time()
    report = runner.run(args.steps)
    wall = time.time() - t0
    losses = report["losses"]
    for i in range(0, len(losses), args.log_every):
        print(f"step {i:5d} loss {losses[i]:.4f}")
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) "
              f"steps/s {len(losses)/wall:.3f}")
    print(json.dumps({k: v for k, v in report.items() if k != 'losses'}))
    return report


if __name__ == "__main__":
    main()
