"""Quickstart on the PyTorch port: the FaST-GShare data plane in ~60 lines.

Builds a reduced qwen2-7b, deploys two weight-shared instances behind the
FaST-Manager token scheduler, serves a handful of batched requests, and
prints throughput / latency / sharing stats (the port's twin of
``examples/quickstart.py``).  It runs on the card unless ``--device cpu``
asks for the plain PyTorch path.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.model_sharing import pytree_nbytes
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine


def run(model, params, device) -> dict:
    """Deploy ``model`` with ``params`` (on ``device``) as two instances,
    serve 8 requests, and return the engine, the requests and what
    completed."""
    cfg = model.cfg
    # One engine == one node: token scheduler + shared weight store.
    engine = ServingEngine(window=0.25, device=device)
    alloc = Alloc(sm=0.24, quota_request=0.5, quota_limit=1.0)
    engine.deploy("qwen2", model, params, alloc, n_instances=2, max_batch=4,
                  max_len=24)
    print(f"deployed 2 instances sharing "
          f"{pytree_nbytes(params) / 1e6:.1f} MB of weights; "
          f"store holds {engine.memory_bytes() / 1e6:.1f} MB total")

    # Submit batched requests; every dispatched step is token-gated.
    rng = np.random.default_rng(1)
    reqs = [engine.submit("qwen2",
                          rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                          max_new_tokens=6)
            for _ in range(8)]
    done = engine.pump(budget_s=60.0)
    return dict(engine=engine, reqs=reqs, done=done)


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # A model is a config + the port's module set; weights from a seed.
    cfg = get_config("qwen2-7b", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    print(f"model: {cfg.name} ({model.n_params() / 1e6:.1f}M params reduced)"
          f" on {device}")

    out = run(model, params, device)
    engine, reqs, done = out["engine"], out["reqs"], out["done"]
    rec = engine.recorders["qwen2"]
    print(f"served {done} requests: p50={rec.p50():.3f}s p99={rec.p99():.3f}s")
    print(f"scheduler: utilization={engine.scheduler.utilization(50):.2f} "
          f"occupancy={engine.scheduler.occupancy(50):.2f}")
    print(f"first completion: {reqs[0].tokens_out}")
    assert done == len(reqs)
    return out


if __name__ == "__main__":
    main()
