"""End-to-end FaST-GShare serving driver on PyTorch (counterpart of
``repro.launch.serve``).

Deploys N weight-shared instances of each architecture onto a
``ServingEngine`` node, gates every step through the token scheduler,
drives a batch of requests, and reports throughput, latency, utilization,
occupancy and the model-sharing memory ledger.  The full-width config is
served on the card by default; ``--reduced`` serves the smoke cut and
``--device cpu`` runs the plain PyTorch path on the CPU.  ``--arch`` takes
qwen2-7b (the default), starcoder2-15b, gemma3-27b, qwen1.5-110b,
qwen2-moe-a2.7b, mixtral-8x7b, rwkv6-1.6b and hymba-1.5b;
``REPRO_KV_INT8=1`` in the environment serves the full-cache dense and moe
configs from int8 KV caches.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --instances 2 --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-15b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --arch mixtral-8x7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
  REPRO_KV_INT8=1 PYTHONPATH=src python -m repro_torch.launch.serve
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

On the card a config whose head dim the attention kernels are not built
for (they take 16, 32, 64 and 128; qwen1.5-110b's reduced head dim is 8),
or whose SSM state size the scan kernel does not take (8 or 16), is
refused before any weight is drawn; so are seamless-m4t-large-v2 and
llama-3.2-vision-11b on any device, whose prefill needs a context that no
request carries (``Model.prefill(ctx=)`` serves them).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.model_sharing import pytree_nbytes
from repro_torch.core.resources import Alloc
from repro_torch.kernels.build import HEAD_DIMS
from repro_torch.kernels.ssm_scan import STATE_SIZES
from repro_torch.models import Model, build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import (ServeRequest, ServingEngine,
                                       context_refusal)


def init_model(arch: str, *, reduced: bool, seed: int,
               device=None) -> tuple[Model, dict]:
    """Build ``arch`` and draw its bf16 weights on ``device`` from
    ``seed``, one leaf at a time."""
    dev = resolve_device(device)
    model = build_model(get_config(arch, reduced=reduced))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model, model.init(gen)


def head_dim_refusal(cfg: ModelConfig) -> Optional[str]:
    """Why the card's attention kernels cannot serve ``cfg``, or None: a
    plain function of the config, checked before any weight is drawn."""
    if (cfg.family in ("dense", "moe", "hybrid", "vlm", "encdec")
            and cfg.dh not in HEAD_DIMS):
        return (f"{cfg.name}: head dim {cfg.dh}, but the attention kernels "
                f"take head dims {HEAD_DIMS} only; serve it with "
                f"--device cpu")
    if cfg.family == "hybrid" and cfg.ssm_state not in STATE_SIZES:
        return (f"{cfg.name}: SSM state size {cfg.ssm_state}, but the scan "
                f"kernel takes {STATE_SIZES} only; serve it with "
                f"--device cpu")
    return None


def drive(engine: ServingEngine, fn: str, prompts: list[np.ndarray],
          max_new_tokens: int, budget_s: float = 600.0
          ) -> tuple[list[ServeRequest], int, float]:
    """Submit ``prompts`` to ``fn`` and pump until they are served.
    Returns (requests, completed, wall seconds)."""
    reqs = [engine.submit(fn, p, max_new_tokens=max_new_tokens)
            for p in prompts]
    t0 = time.perf_counter()
    done = engine.pump(budget_s=budget_s)
    return reqs, done, time.perf_counter() - t0


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="repeatable; each arch is served: qwen2-7b "
                         "(default), starcoder2-15b, gemma3-27b, "
                         "qwen1.5-110b, qwen2-moe-a2.7b, mixtral-8x7b, "
                         "rwkv6-1.6b or hymba-1.5b")
    ap.add_argument("--instances", type=int, default=2,
                    help="instances per function (share one weight copy)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--sm", type=float, default=0.24,
                    help="spatial share per instance")
    ap.add_argument("--quota", type=float, default=0.5)
    ap.add_argument("--quota-limit", type=float, default=1.0)
    ap.add_argument("--window", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced smoke config of each arch")
    args = ap.parse_args(argv)
    archs = args.arch or ["qwen2-7b"]
    for arch in archs:
        cfg = get_config(arch, reduced=args.reduced)
        refusal = context_refusal(cfg) or (
            head_dim_refusal(cfg)
            if torch.device(args.device).type != "cpu" else None)
        if refusal:
            ap.error(refusal)

    engine = ServingEngine(window=args.window, device=args.device)
    rng = np.random.default_rng(args.seed)
    alloc = Alloc(sm=args.sm, quota_request=args.quota,
                  quota_limit=args.quota_limit)

    unshared_total = 0
    for arch in archs:
        model, params = init_model(arch, reduced=args.reduced,
                                   seed=args.seed, device=engine.device)
        nbytes = pytree_nbytes(params)
        unshared_total += nbytes * args.instances
        engine.deploy(arch, model, params, alloc,
                      n_instances=args.instances, max_batch=args.max_batch,
                      max_len=args.prompt_len + args.max_new_tokens + 1)
        cfg = model.cfg
        kv = "int8" if model.kv_int8() else {
            "rwkv": "recurrent state",
            "hybrid": "rolled bf16 KV + SSM state"}.get(cfg.family, "bf16")
        if cfg.sliding_window and cfg.family in ("dense", "moe"):
            kv = ("rolled + global bf16" if cfg.local_global_ratio
                  else "rolled bf16")
        print(f"[deploy] {arch}: {args.instances} instances sharing "
              f"{nbytes / 1e6:.1f} MB of weights ({cfg.n_layers}L "
              f"d={cfg.d_model}, {kv} cache) on {engine.device}")

    reqs, done = [], 0
    t0 = time.perf_counter()
    for i, arch in enumerate(archs):
        vocab = get_config(arch, reduced=args.reduced).vocab_size
        n = len(range(i, args.requests, len(archs)))
        prompts = [rng.integers(0, vocab, size=args.prompt_len)
                   .astype(np.int32) for _ in range(n)]
        reqs += [engine.submit(arch, p, max_new_tokens=args.max_new_tokens)
                 for p in prompts]
    done = engine.pump(budget_s=600.0)
    wall = time.perf_counter() - t0

    print(f"\n[serve] completed {done}/{len(reqs)} requests in {wall:.2f}s "
          f"({done / max(wall, 1e-9):.1f} req/s)")
    for fn, rec in engine.recorders.items():
        if rec.count():
            print(f"  {fn:24s} n={rec.count():4d}  p50={rec.p50():.3f}s  "
                  f"p99={rec.p99():.3f}s")
    sched = engine.scheduler
    print(f"[manager] utilization={sched.utilization(last_n=50):.2f}  "
          f"occupancy={sched.occupancy(last_n=50):.2f}  "
          f"(window={args.window}s)")
    shared = engine.memory_bytes()
    print(f"[model sharing] weights resident: {shared / 1e6:.1f} MB shared "
          f"vs {unshared_total / 1e6:.1f} MB unshared "
          f"({1 - shared / max(unshared_total, 1):.0%} saved)")
    print(f"[syncs] {engine.sync_counts()}")
    sample = reqs[0]
    print(f"[sample] req0 prompt[:8]={sample.prompt[:8].tolist()} -> "
          f"tokens_out={sample.tokens_out}")


if __name__ == "__main__":
    main()
