"""Live isolation demo on the PyTorch port: two real models share one node
without interference (the port's twin of
``examples/multi_tenant_isolation.py``).

Two functions (reduced qwen2 + rwkv6) run on one ServingEngine.  First the
aggressor runs with an elastic quota next to the victim (time sharing
style) — the victim's step dispatch rate drops.  Then both get hard
spatio-temporal partitions — the victim's rate is unaffected by the
aggressor.  The live analogue of paper Fig. 9, on the card's kernels
(``--device cpu``: the plain PyTorch path).

Where an aggressor runs, the victim's rate is read only over its
completions up to the aggressor's last one: past it the victim serves
alone, which reads no interference.  On the CPU the aggressor outlasts
the victim, so this is the twin's reading; on the card the time-shared
aggressor ends first, and the victim's solo tail, at its 0.8 quota
limit, swung the asserted ratio across its limit from run to run
(``scripts/isolation_spread.py`` prints both readings).

Run:  PYTHONPATH=src python examples/torch_multi_tenant_isolation.py
"""

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine


def allocs(isolated: bool) -> dict[str, Alloc]:
    """The victim is guaranteed 50%; the isolated run caps everyone's
    elasticity."""
    return {"victim": Alloc(sm=0.24 if isolated else 1.0, quota_request=0.5,
                            quota_limit=0.5 if isolated else 0.8),
            "aggressor": Alloc(sm=0.24 if isolated else 1.0,
                               quota_request=0.5,
                               quota_limit=0.5 if isolated else 1.0)}


def models(device) -> dict:
    """(model, params) of each function, weights from seeds 0 and 1."""
    out = {}
    for fn, arch, seed in (("victim", "rwkv6-1.6b", 0),
                           ("aggressor", "qwen2-7b", 1)):
        model = build_model(get_config(arch, reduced=True))
        gen = torch.Generator(device=device).manual_seed(seed)
        out[fn] = (model, model.init(gen))
    return out


def serve_victim(aggressor: bool, isolated: bool, fns: dict, device,
                 scale: int = 1) -> dict:
    """One run; returns the victim's completed requests/s, the engine and
    every request submitted.  ``scale`` multiplies both functions'
    request counts (1: the twin's 30 and 40)."""
    engine = ServingEngine(window=0.2, device=device)
    rng = np.random.default_rng(0)
    alloc = allocs(isolated)
    victim, params_v = fns["victim"]
    engine.deploy("victim", victim, params_v, alloc["victim"],
                  n_instances=1, max_batch=2, max_len=20)
    reqs = []
    if aggressor:
        model_a, params_a = fns["aggressor"]
        engine.deploy("aggressor", model_a, params_a, alloc["aggressor"],
                      n_instances=1, max_batch=2, max_len=20)
        for _ in range(40 * scale):
            reqs.append(engine.submit(
                "aggressor", rng.integers(0, model_a.cfg.vocab_size, 8)
                .astype(np.int32), max_new_tokens=8))
    n_victim = 30 * scale
    for _ in range(n_victim):
        reqs.append(engine.submit(
            "victim", rng.integers(0, victim.cfg.vocab_size, 8)
            .astype(np.int32), max_new_tokens=4))
    engine.pump(budget_s=30.0)
    return dict(rate=victim_rate(engine.recorders), engine=engine,
                reqs=reqs)


def victim_rate(recorders: dict) -> float:
    """The victim's completed requests/s while it shares the node: its
    completions up to the aggressor's last, if one ran."""
    times = sorted(recorders["victim"].completion_times)
    if "aggressor" in recorders:
        end = max(recorders["aggressor"].completion_times, default=0.0)
        times = [t for t in times if t <= end]
    # Rate over the trailing 3/4 of completions: the head holds the
    # first rounds' one-time costs (graph captures on the card), which
    # would swamp the isolation signal.
    if len(times) < 2:
        return 0.0
    k = len(times) // 4
    return (len(times) - 1 - k) / max(times[-1] - times[k], 1e-9)


def run(fns: dict, device, scale: int = 1) -> dict:
    """The three runs: alone, time-shared, isolated."""
    return {name: serve_victim(aggressor, isolated, fns, device, scale)
            for name, aggressor, isolated in (("alone", False, True),
                                              ("contended", True, False),
                                              ("isolated", True, True))}


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = run(models(device), device)
    alone, contended, isolated = (out[k]["rate"] for k in
                                  ("alone", "contended", "isolated"))
    print(f"victim rate alone       : {alone:6.1f} req/s")
    print(f"victim rate, time-shared: {contended:6.1f} req/s "
          f"({contended / alone:.0%} of alone — interference)")
    print(f"victim rate, isolated   : {isolated:6.1f} req/s "
          f"({isolated / alone:.0%} of alone)")
    assert contended > 0 and isolated > 0, \
        "the victim must complete requests while the aggressor runs"
    # Isolation must recover most of the drop the aggressor causes.
    assert isolated >= contended * 0.9, "isolation should not be worse"
    return out


if __name__ == "__main__":
    main()
