"""Train-step factory and loop (counterpart of
``repro.training.train_loop``): microbatch accumulation, per-layer remat,
optional bf16 gradient accumulation, checkpoint/restart.

The step differentiates ``Model.forward`` with ``torch.autograd``: the
kernels of the training path go through their autograd Functions
(``kernels/ops.py``), and the gradients come out in the params' dtype
and are cast to the step's gradient dtype, as ``jax.value_and_grad``
gives them and ``train_loop.py:60-85`` casts them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.tree import leaves, rebuild, tree_map


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token NLL over the padded vocab: logits f32 (B, S, V),
    labels (B, S) int (train_loop.py:17-22)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean()


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: bool = True
    grad_compress: bool = False  # bf16 gradient accumulation
    aux_weight: float = 0.01  # MoE load-balance loss weight


def make_train_step(model: Model, opt: AdamW,
                    cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    metrics)`` (train_loop.py:39-101); params and moments are updated in
    place (``AdamW.update``).

    ``batch``: {"tokens": (B, S), "labels": (B, S)[, "ctx": (B, Sc, D)]},
    on the host or the params' device.  With ``microbatches > 1`` the
    batch splits along B and the gradients accumulate in the gradient
    dtype, then divide by the count.  ``grad_compress`` makes that dtype
    bf16 (f32 otherwise)."""
    grad_dtype = torch.bfloat16 if cfg.grad_compress else torch.float32

    def value_and_grad(params, tokens, labels, ctx):
        flat = leaves(params)
        diff = [p.detach().requires_grad_() for p in flat]
        logits, aux = model.forward(rebuild(params, diff), tokens, ctx=ctx,
                                    remat=cfg.remat)
        loss = cross_entropy(logits, labels) + cfg.aux_weight * aux
        del logits
        grads = torch.autograd.grad(loss, diff, materialize_grads=True)
        return loss.detach(), grads

    def train_step(params, opt_state: AdamWState, batch: dict):
        dev = leaves(params)[0].device
        tokens, labels = (batch[k].to(dev) for k in ("tokens", "labels"))
        ctx = batch.get("ctx")
        ctx = None if ctx is None else ctx.to(dev)
        n_mb = cfg.microbatches
        if n_mb == 1:
            loss, grads = value_and_grad(params, tokens, labels, ctx)
            grads = [g.to(grad_dtype).contiguous() for g in grads]
        else:
            b = tokens.shape[0]
            if b % n_mb:
                raise ValueError(f"batch {b} not divisible by {n_mb}")
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
                     for p in leaves(params)]
            mb = b // n_mb
            for i in range(n_mb):
                part = slice(i * mb, (i + 1) * mb)
                lo, gs = value_and_grad(
                    params, tokens[part], labels[part],
                    None if ctx is None else ctx[part])
                loss = loss + lo
                for acc, g in zip(grads, gs):
                    acc.add_(g.to(grad_dtype))
            loss = loss / n_mb
            for g in grads:
                g.div_(n_mb)
        params, opt_state, metrics = opt.update(rebuild(params, grads),
                                                opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


@dataclasses.dataclass
class TrainResult:
    losses: list[float]
    steps: int
    wall_time: float


def train(model: Model, params, batches: Iterator[dict], *,
          opt: Optional[AdamW] = None, steps: int = 100,
          step_cfg: TrainStepConfig = TrainStepConfig(),
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 50,
          log_every: int = 10,
          on_step: Optional[Callable[[int, dict], None]] = None
          ) -> tuple[Any, AdamWState, TrainResult]:
    """A single-process training loop with checkpoint/restart
    (train_loop.py:111-138): it resumes from the newest checkpoint in
    ``checkpoint_dir`` when there is one (placed on the params' devices),
    then runs steps ``start .. steps - 1``, one batch of ``batches``
    each, and saves every ``checkpoint_every`` steps."""
    opt = opt or AdamW(total_steps=steps)
    opt_state = opt.init(params)
    start_step = 0
    if checkpoint_dir:
        restored = ckpt.restore_latest(checkpoint_dir, params, opt_state)
        if restored is not None:
            start_step, host_p, host_s = restored

            def place(x, like):
                return x.to(like.device)
            params = tree_map(place, host_p, params)
            opt_state = AdamWState(step=host_s.step,
                                   m=tree_map(place, host_s.m, opt_state.m),
                                   v=tree_map(place, host_s.v, opt_state.v))
    step_fn = make_train_step(model, opt, step_cfg)
    losses: list[float] = []
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        batch = next(batches)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if on_step:
            on_step(step, metrics)
        if log_every and step % log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if checkpoint_dir and (step + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, step + 1, params, opt_state)
    return params, opt_state, TrainResult(
        losses=losses, steps=steps - start_step,
        wall_time=time.perf_counter() - t0)
