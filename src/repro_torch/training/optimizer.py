"""AdamW with global-norm clipping (counterpart of
``repro.training.optimizer``): JAX's update, element for element.

Moments are f32 whatever the param dtype; the update is computed in f32
and cast back.  The port updates params and moments in place, the
counterpart of the JAX train loop donating them, and works through each
leaf in slices of at most ``SLICE`` elements, so the update's f32
transients stay a slice's size, not the largest leaf's (the math is
elementwise: slicing changes no value).  The step count and the learning
rate live on the host (the rate in f32, as JAX computes it), so a step
reads nothing back from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.training.tree import leaves, tree_map

SLICE = 1 << 26  # elements of a leaf updated at a time (256 MB of f32)


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the host
    m: Any
    v: Any


def _slices(t: torch.Tensor):
    """Consecutive views of at most ``SLICE`` elements of a contiguous
    ``t``, in place (one view of a meta tensor, which holds no memory for
    a slice to bound: the dry run traces the update at full width)."""
    flat = t.view(-1)
    if flat.is_meta:
        yield flat
        return
    for a in range(0, flat.numel(), SLICE):
        yield flat[a:a + SLICE]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    schedule: str = "cosine"  # cosine | constant
    total_steps: int = 10_000

    def init(self, params: Any) -> AdamWState:
        """Zero f32 moments beside each leaf, on its device; step 0."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    def _lr_at(self, step: int) -> np.float32:
        """Linear warmup, then cosine decay to 0 at ``total_steps``, in f32
        (optimizer.py:43-50)."""
        f32 = np.float32
        warm = min(f32(1.0), f32(step + 1) / f32(max(self.warmup_steps, 1)))
        if self.schedule == "cosine":
            frac = np.clip(f32(step) / f32(max(self.total_steps, 1)),
                           f32(0.0), f32(1.0))
            decay = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac))
        else:
            decay = f32(1.0)
        return f32(self.lr) * warm * decay

    def update(self, grads: Any, state: AdamWState, params: Any
               ) -> tuple[Any, AdamWState, dict]:
        """One step from ``grads`` (any float dtype, the params' nesting):
        returns (params, state, {"grad_norm", "lr"}), params and moments
        updated in place.  The gradients are clipped to a global norm of
        ``clip_norm``; decoupled weight decay applies to leaves of two
        dims or more only (optimizer.py:52-85)."""
        flat_p, flat_g = leaves(params), leaves(grads)
        flat_m, flat_v = leaves(state.m), leaves(state.v)
        sq = None
        for g in flat_g:
            for c in _slices(g):
                cf = c.float()
                part = torch.sum(cf * cf)
                sq = part if sq is None else sq + part
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        t = int(state.step)
        lr = float(self._lr_at(t))
        f32 = np.float32
        b1c = float(f32(1.0) - f32(self.b1) ** f32(t + 1))
        b2c = float(f32(1.0) - f32(self.b2) ** f32(t + 1))
        with torch.no_grad(), torch.profiler.record_function("AdamW.update"):
            for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
                decay = p.dim() >= 2
                for pc, gc, mc, vc in zip(*map(_slices, (p, g, m, v))):
                    gc = gc.float() * scale
                    mc.mul_(self.b1).add_((1 - self.b1) * gc)
                    vc.mul_(self.b2).add_((1 - self.b2) * gc * gc)
                    delta = (mc / b1c) / (torch.sqrt(vc / b2c) + self.eps)
                    pf = pc.float()
                    if decay:
                        delta = delta + self.weight_decay * pf
                    pc.copy_(pf - lr * delta)
        new_state = AdamWState(step=state.step + 1, m=state.m, v=state.v)
        return params, new_state, {"grad_norm": gnorm,
                                   "lr": torch.tensor(lr)}
