"""The flash kernel at every prefill shape the port's smoke times, beside
PyTorch's SDPA and the card's bound.

For each shape: the kernel's output against ``flash_attention_plain``
(bf16, tolerance 2e-2; the script fails past it), the kernel's device
time (``torch.profiler``'s kernel records over 30 calls) and CUDA-event
time, SDPA's device time (``enable_gqa``; ``is_causal``, a boolean window
mask or no mask, as the shape asks), and the bound: the larger of the
bytes (q, k, v read once, o written once) over ``launch/mesh.py``'s
``HBM_BW`` and the pairs' 4 * D flops over its ``PEAK_FLOPS_BF16``.
Calls rotate over copies of the inputs larger than twice the 50 MB L2,
so every call reads cold memory.  One JSON line a shape, then the card's
name and power limit.

``repro_torch`` is imported from whatever ``PYTHONPATH`` names, so the
same script times another tree's kernel (a ``git archive`` of the parent
commit unpacked under ``build/``) in turns with this one in one call:

  PYTHONPATH=src python3 scripts/flash_shapes.py --label change
  PYTHONPATH=build/parent/src python3 scripts/flash_shapes.py --label parent

Each line also gives ``wrapper_us``, the host's microseconds a call of
the wrapper (its checks, the output's allocation, the C entry point; the
median of five runs of 100 calls; ``flash_host.py`` times the C entry
point alone, several trees in turns).  ``--only`` keeps the shapes whose
names contain one of its comma-separated words.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

L2_BYTES = 50e6
ITERS = 30
TOL = 2e-2
# (name, B, Sq, Sk, H, KV, D, causal, window)
SHAPES = [
    ("main qwen2-7b", 1, 512, 512, 28, 4, 128, True, None),
    ("short bucket Sq=64", 1, 64, 64, 28, 4, 128, True, None),
    ("short bucket Sq=32", 1, 32, 32, 28, 4, 128, True, None),
    ("short bucket Sq=16", 1, 16, 16, 28, 4, 128, True, None),
    ("short bucket Sq=8", 1, 8, 8, 28, 4, 128, True, None),
    ("short bucket Sq=4", 1, 4, 4, 28, 4, 128, True, None),
    ("short bucket Sq=2", 1, 2, 2, 28, 4, 128, True, None),
    ("short bucket Sq=1", 1, 1, 1, 28, 4, 128, True, None),
    ("hymba prefill", 1, 640, 640, 25, 5, 64, True, 1024),
    ("gemma3 local", 1, 1920, 1920, 32, 16, 128, True, 1024),
    ("gemma3 global", 1, 1920, 1920, 32, 16, 128, True, None),
    ("starcoder2 48/4", 1, 512, 512, 48, 4, 128, True, None),
    ("qwen2-moe 16/16", 1, 512, 512, 16, 16, 128, True, None),
    ("seamless decoder 16/16 D=64", 1, 512, 512, 16, 16, 64, True, None),
    ("vision self 32/8", 1, 512, 512, 32, 8, 128, True, None),
    ("seamless encoder", 1, 1024, 1024, 16, 16, 64, False, None),
    ("seamless cross", 1, 512, 1024, 16, 16, 64, False, None),
    ("vision cross", 1, 512, 1600, 32, 8, 128, False, None),
    ("member 14/2", 1, 512, 512, 14, 2, 128, True, None),
    ("member 7/1", 1, 512, 512, 7, 1, 128, True, None),
    ("member gemma3 8/4 local", 1, 1920, 1920, 8, 4, 128, True, 1024),
    ("D=16", 1, 512, 512, 28, 4, 16, True, None),
    ("D=32", 1, 512, 512, 28, 4, 32, True, None),
    ("training forward 4x512", 4, 512, 512, 28, 4, 128, True, None),
]


def pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the shape attends (Sq = Sk where causal)."""
    if not causal:
        return sq * sk
    w = sq if window is None else min(window, sq)
    return w * (w + 1) // 2 + (sq - w) * w


def device_ms(calls, tries: int = 3) -> float:
    """Mean device time a call from the profiler's kernel records; a
    window that came back without records (it happens) is taken again."""
    from torch.profiler import ProfilerActivity, profile
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(ITERS):
                calls[i % len(calls)]()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CPU:
                total += e.duration_ns() if hasattr(e, "duration_ns") \
                    else e.duration_us() * 1e3
        if total > 0:
            return total / 1e6 / ITERS
    raise RuntimeError("the profiler recorded no device time")


def event_ms(calls) -> float:
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(ITERS):
        calls[i % len(calls)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def host_us(call, n: int = 100, reps: int = 5) -> float:
    """The host's microseconds a call: the median of ``reps`` runs of
    ``n`` calls, the device's queue drained between runs (not timed)."""
    call()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_shapes: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh
    label = args.label or str(Path(fa.__file__).resolve().parents[2])
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(0)
    words = [w for w in args.only.split(",") if w]
    for name, b, sq, sk, h, kv, d, causal, window in SHAPES:
        if words and not any(w in name for w in words):
            continue

        def rand(*shape):
            x = gen.standard_normal(shape).astype(np.float32)
            return torch.from_numpy(x).to(dev).to(torch.bfloat16)

        q, k, v = rand(b, sq, h, d), rand(b, sk, kv, d), rand(b, sk, kv, d)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=TOL,
                                   rtol=TOL, msg=lambda m: f"{name}: {m}")
        io = 2 * (2 * q.numel() + k.numel() + v.numel())
        n = max(2, int(2 * L2_BYTES // io) + 1)
        sets = [[x.clone() for x in (q, k, v)] for _ in range(n)]
        tsets = [[x.transpose(1, 2).contiguous() for x in xs] for xs in sets]
        kw = dict(enable_gqa=True)
        if causal and window is not None and window < sq:
            pos = torch.arange(sq, device=dev)
            kw["attn_mask"] = ((pos[None, :] <= pos[:, None])
                               & (pos[None, :] > pos[:, None] - window))
        elif causal:
            kw["is_causal"] = True
        kernel = [lambda x=x: fa.flash_attention(*x, causal=causal,
                                                 window=window) for x in sets]
        sdpa = [lambda x=x: F.scaled_dot_product_attention(*x, **kw)
                for x in tsets]
        wrapper = host_us(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window))
        flops = 4 * b * h * d * pairs(sq, sk, causal, window)
        t_ops, t_bytes = flops / mesh.PEAK_FLOPS_BF16, io / mesh.HBM_BW
        print(json.dumps(dict(
            label=label, shape=name, B=b, Sq=sq,
            Sk=sk, H=h, KV=kv, D=d, causal=causal, window=window,
            max_abs_err=err, device_ms=device_ms(kernel),
            ms=event_ms(kernel), wrapper_us=wrapper,
            sdpa_device_ms=device_ms(sdpa),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes")),
              flush=True)
        del sets, tsets
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()} (build {build.CSRC})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
