"""How much does ``examples/torch_multi_tenant_isolation.py``'s victim
rate move between runs on the card?  Draws the two reduced models once,
then runs the example's three runs (alone, time-shared, isolated)
``--reps`` times in this process (both functions' request counts times
``--scale``; 1 is the example's) and prints each repetition's victim
rates, their isolated / time-shared ratio as the example reads it (the
victim's completions while the aggressor still had work; the example
asserts at least 0.9) and as the JAX twin reads it (all of the victim's
completions), how many of the victim's completions each aggressor run
spanned, and the seconds from the victim's first completion to its last
and the aggressor's (the scheduler's window is 0.2 s).  The first
repetition is the process's first use of the models.  The last line
counts the repetitions below 0.9 in both readings.

Usage (one card, from the repo root):
  python3 scripts/isolation_spread.py [--reps 6] [--scale 1]
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def span(engine, fn: str):
    rec = engine.recorders.get(fn)
    if rec is None or not rec.count():
        return None
    times = sorted(rec.completion_times)
    return round(times[-1] - times[0], 4)


def shared(engine) -> int:
    """The victim's completions up to the aggressor's last."""
    end = max(engine.recorders["aggressor"].completion_times, default=0.0)
    return sum(t <= end for t in engine.recorders["victim"].completion_times)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--scale", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[isolation_spread] FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.build()
    spec = importlib.util.spec_from_file_location(
        "torch_multi_tenant_isolation",
        ROOT / "examples" / "torch_multi_tenant_isolation.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    dev = torch.device("cuda", torch.cuda.current_device())
    fns = ex.models(dev)
    ratios = {"example": [], "twin": []}
    for rep in range(args.reps):
        t0 = time.perf_counter()
        out = ex.run(fns, dev, args.scale)
        rates = {k: round(v["rate"], 1) for k, v in out.items()}
        twin = {k: ex.victim_rate({"victim": v["engine"].recorders["victim"]})
                for k, v in out.items()}
        ratios["example"].append(out["isolated"]["rate"]
                                 / out["contended"]["rate"])
        ratios["twin"].append(twin["isolated"] / twin["contended"])
        spanned = {k: shared(out[k]["engine"])
                   for k in ("contended", "isolated")}
        print(f"scale {args.scale} rep {rep}: victim req/s {rates}; isolated / time-shared "
              f"{ratios['example'][-1]:.3f} (twin's reading "
              f"{ratios['twin'][-1]:.3f}, victim req/s "
              f"{ {k: round(v, 1) for k, v in twin.items()} }); victim "
              f"completions while the aggressor ran {spanned}; "
              f"victim span s "
              f"{ {k: span(v['engine'], 'victim') for k, v in out.items()} }"
              f"; aggressor span s "
              f"{ {k: span(v['engine'], 'aggressor') for k, v in out.items()} }"
              f" ({time.perf_counter() - t0:.1f}s)", flush=True)
    print("below 0.9: "
          + "; ".join(f"{k} {sum(r < 0.9 for r in v)} of {len(v)} "
                      f"({min(v):.3f}-{max(v):.3f})"
                      for k, v in ratios.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
