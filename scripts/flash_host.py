"""The flash kernel's C entry point: the host's time a call, for several
source trees in turns in one process.

Each argument names a tree's ``src`` directory.  That tree's
``repro_torch/kernels/build.py`` is loaded under a module name of its
own, builds the tree's kernels (under the tree's ``build/``) and loads
its library, so every tree's ``repro_flash_attention_bf16`` is called
through ctypes on the same tensors in the same process.  For each shape:
``ROUNDS`` rounds, each timing ``CALLS`` calls of every tree (the order
rotating a round; the device's queue drained between them, not timed).
One JSON line a shape and tree: the median and quartiles of the rounds'
microseconds a call.  Then the card's name and power limit.  One card,
from the repo root:

  python3 scripts/flash_host.py src build/parent/src
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROUNDS = 15
CALLS = 200
# (name, B, Sq, Sk, H, KV, D, causal, window)
SHAPES = [
    ("main qwen2-7b", 1, 512, 512, 28, 4, 128, True, None),
    ("short bucket Sq=64", 1, 64, 64, 28, 4, 128, True, None),
    ("short bucket Sq=16", 1, 16, 16, 28, 4, 128, True, None),
    ("short bucket Sq=1", 1, 1, 1, 28, 4, 128, True, None),
    ("gemma3 local", 1, 1920, 1920, 32, 16, 128, True, 1024),
    ("D=16", 1, 512, 512, 28, 4, 16, True, None),
]


def load_build(src: Path, i: int):
    """``src``'s kernels/build.py as a module of its own."""
    path = src / "repro_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(f"flash_host_build{i}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("flash_host: needs a CUDA card", file=sys.stderr)
        return 1
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [Path(a).resolve() for a in argv]
    builds = [load_build(t, i) for i, t in enumerate(trees)]
    libs = [b.library() for b in builds]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, b, sq, sk, h, kv, d, causal, window in SHAPES:
        def rand(*shape):
            return torch.randn(shape, device=dev, generator=gen,
                               dtype=torch.bfloat16)
        q, k, v = rand(b, sq, h, d), rand(b, sk, kv, d), rand(b, sk, kv, d)
        o = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq,
                sk, h, kv, d, int(causal), -1 if window is None else window,
                0, d ** -0.5, stream)
        calls = [lib.repro_flash_attention_bf16 for lib in libs]
        for fn, bld in zip(calls, builds):  # build, load, first launch
            bld.check(fn(*args), "flash_attention")
        torch.cuda.synchronize()
        runs = [[] for _ in trees]
        for r in range(ROUNDS):
            for j in range(len(trees)):
                t = (r + j) % len(trees)
                fn = calls[t]
                t0 = time.perf_counter()
                for _ in range(CALLS):
                    fn(*args)
                runs[t].append((time.perf_counter() - t0) / CALLS * 1e6)
                torch.cuda.synchronize()
        for tree, us in zip(argv, runs):
            qs = statistics.quantiles(us, n=4)
            print(json.dumps(dict(
                tree=tree, shape=name, B=b, Sq=sq, Sk=sk, H=h, KV=kv, D=d,
                host_us_median=statistics.median(us), host_us_q1=qs[0],
                host_us_q3=qs[2], rounds=ROUNDS, calls=CALLS)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
