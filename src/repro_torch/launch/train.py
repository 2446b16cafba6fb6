"""End-to-end trainer on PyTorch (counterpart of
``repro.launch.train``): a reduced arch config or a preset, the synthetic
data stream, AdamW, microbatch accumulation, atomic checkpoints and
restart.  It trains on the card unless ``--device cpu`` is given, and
exits non-zero when the loss does not fall.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --steps 60
  PYTHONPATH=src python -m repro_torch.launch.train --preset 100m --steps 300
  PYTHONPATH=src python -m repro_torch.launch.train --preset 10m --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.training import AdamW, TrainResult, TrainStepConfig, train
from repro_torch.training.data import batch_iterator

PRESETS = {
    # ~100M params: 12L x 768, GPT-2-small-ish with a swiglu MLP.
    "100m": ModelConfig(name="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                        vocab_size=32000),
    # ~10M: CPU-friendly demo scale.
    "10m": ModelConfig(name="lm-10m", family="dense", n_layers=6,
                       d_model=320, n_heads=8, n_kv_heads=4, d_ff=896,
                       vocab_size=8192),
}


def main(argv: Optional[list[str]] = None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="assigned arch id (reduced config is trained)")
    ap.add_argument("--preset", default=None, choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true",
                    help="bf16 gradient accumulation")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.preset:
        cfg = PRESETS[args.preset]
    else:
        cfg = get_config(args.arch or "qwen2-7b", reduced=True)
    model = build_model(cfg)
    print(f"[train] {cfg.name}: {model.n_params() / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq} on "
          f"{dev}")

    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    ctx_shape = None
    if model.needs_ctx():
        ctx_shape = (args.batch, cfg.n_context_tokens, cfg.d_model)
    batches = batch_iterator(cfg.vocab_size, args.batch, args.seq,
                             seed=args.seed, ctx_shape=ctx_shape)
    opt = AdamW(lr=args.lr, total_steps=args.steps)
    step_cfg = TrainStepConfig(microbatches=args.microbatches,
                               grad_compress=args.grad_compress)
    params, opt_state, result = train(
        model, params, batches, opt=opt, steps=args.steps,
        step_cfg=step_cfg, checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every, log_every=10)
    first, last = result.losses[0], result.losses[-1]
    print(f"[train] done: loss {first:.3f} -> {last:.3f} over "
          f"{result.steps} steps in {result.wall_time:.1f}s "
          f"({result.steps / max(result.wall_time, 1e-9):.2f} steps/s)")
    if not (last < first):
        raise SystemExit("loss did not improve — training substrate broken")
    return result


if __name__ == "__main__":
    main()
