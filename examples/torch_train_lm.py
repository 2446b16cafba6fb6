"""Train a small LM end to end on the PyTorch port: data -> AdamW ->
checkpoints -> restart (the port's twin of ``examples/train_lm.py``).

Exercises the training substrate: microbatch gradient accumulation,
atomic keep-N checkpoints, and a simulated crash + restart that resumes
mid-run from the latest checkpoint.  It trains on the card unless
``--device cpu`` asks for the plain PyTorch path; the ``10m`` preset's
head dim (40) is not one the card's kernels take, so on the card run
``--preset 100m``.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m [--steps 80]
      PYTHONPATH=src python examples/torch_train_lm.py --device cpu
"""

import argparse
import tempfile
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.launch.serve import head_dim_refusal
from repro_torch.launch.train import PRESETS
from repro_torch.models import build_model
from repro_torch.training import AdamW
from repro_torch.training.data import batch_iterator
from repro_torch.training.train_loop import TrainStepConfig, train
from repro_torch.training.tree import tree_map


def run(model, params, steps: int) -> list[float]:
    """Train ``model`` from ``params`` for ``steps`` steps with a crash
    and a restart from the latest checkpoint halfway; returns every
    step's loss.  ``params`` are updated in place."""
    cfg = model.cfg
    fresh = tree_map(torch.clone, params)  # the restart's own init
    opt = AdamW(lr=3e-4, total_steps=steps)
    step_cfg = TrainStepConfig(microbatches=2)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        half = steps // 2
        batches = batch_iterator(cfg.vocab_size, 4, 128, seed=0)
        _, _, res1 = train(model, params, batches, opt=opt, steps=half,
                           step_cfg=step_cfg, checkpoint_dir=ckpt_dir,
                           checkpoint_every=10, log_every=10)
        print(f"[crash] simulated failure at step {half}; restarting from "
              f"the latest checkpoint in {ckpt_dir}")
        # Restart: train() restores step/params/optimizer from disk; the
        # data pipeline is seekable so batches replay deterministically.
        batches2 = batch_iterator(cfg.vocab_size, 4, 128, seed=0)
        _, _, res2 = train(model, fresh, batches2, opt=opt, steps=steps,
                           step_cfg=step_cfg, checkpoint_dir=ckpt_dir,
                           checkpoint_every=10, log_every=10)
    return res1.losses + res2.losses


def main(argv: Optional[list[str]] = None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--preset", default="10m", choices=list(PRESETS))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = PRESETS[args.preset]
    refusal = head_dim_refusal(cfg) if device.type == "cuda" else None
    if refusal:
        ap.error(refusal)
    model = build_model(cfg)
    print(f"training {cfg.name}: {model.n_params() / 1e6:.1f}M params on "
          f"{device}")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    losses = run(model, params, args.steps)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({args.steps} total steps, restart at {args.steps // 2})")
    assert losses[-1] < losses[0], "loss must improve end to end"
    return losses


if __name__ == "__main__":
    main()
