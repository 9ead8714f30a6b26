"""End-to-end LM training driver: a ~100M-parameter qwen3-family model
trained for a few hundred steps on synthetic structured data, with
checkpointing + fault tolerance on.

The structured synthetic stream (every second token is a deterministic
function of its predecessor) gives the model something learnable: loss should
drop well below ln(vocab) as it learns the copy+shift rule on half the
positions.

The port of ``examples/train_lm.py``: the same steps, defaults and lines,
on the CUDA card unless ``--device cpu`` is passed. The default checkpoint
directory is ``repro_torch_train_lm`` under the temp directory, apart from
the reference's; a directory left from an earlier run is restored from, so
pass a fresh one to train from step 0.

Run:  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] [--small]
      [--device cpu]
(--small: ~2M params for a fast CI-scale run; default ~100M.)
"""
import argparse
import math
import os
import tempfile
import time

from repro_torch.config import ModelConfig, TrainConfig, describe
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import FaultTolerantRunner


def build_cfg(small: bool) -> ModelConfig:
    if small:
        return ModelConfig(name="lm-2m", family="dense", n_layers=2,
                           d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                           d_ff=256, vocab_size=512, qk_norm=True,
                           tie_embeddings=True, remat_policy="none",
                           dtype="float32")
    # ~100M active params, qwen3-style (qk_norm, GQA, SwiGLU, tied embeds)
    return ModelConfig(name="lm-100m", family="dense", n_layers=8,
                       d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                       d_ff=2304, vocab_size=32_768, qk_norm=True,
                       tie_embeddings=True, remat_policy="none",
                       dtype="float32")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises if there is none)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_cfg(args.small)
    print(describe(cfg))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=20,
                     total_steps=args.steps, checkpoint_every=100,
                     checkpoint_dir=args.ckpt_dir, num_microbatches=1)
    runner = FaultTolerantRunner(cfg, tc, batch=args.batch,
                                 seq_len=args.seq_len, device=device)
    runner.install_preemption_handler()

    t0 = time.time()
    report = runner.run(args.steps, inject=False)
    wall = time.time() - t0
    losses = report["losses"]
    for i in range(0, len(losses), max(len(losses) // 15, 1)):
        print(f"step {i:4d}  loss {losses[i]:.4f}")
    ln_v = math.log(cfg.vocab_size)
    print(f"\nfinal loss {losses[-1]:.4f}  (uniform = ln V = "
          f"{ln_v:.2f};  copy-rule floor ~= "
          f"{0.5 * ln_v:.2f})")
    print(f"{len(losses)} steps in {wall:.0f}s "
          f"({len(losses)/wall:.2f} steps/s), "
          f"checkpoints in {args.ckpt_dir}")
    assert losses[-1] < losses[0], "training must reduce loss"
    return dict(losses=losses, final_loss=losses[-1], ln_v=ln_v,
                copy_floor=0.5 * ln_v, steps=len(losses), wall_s=wall,
                steps_per_s=len(losses) / wall,
                params=cfg.param_count(), report=report)


if __name__ == "__main__":
    main()
