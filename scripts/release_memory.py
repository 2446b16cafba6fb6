#!/usr/bin/env python3
"""What ``retire`` and ``fail`` give back to the device, in one checkout of
the port, on one GPU.

Imports ``src/repro_torch`` from CHECKOUT (by default the checkout that
holds this script), draws qwen2-7b at full width and, for one and for two
paged instances (``max_batch=8``, ``max_len=1024``, block 16, each through
its graphs' capture), retires the first instance, once idle and once
mid-decode (the pump drains it and it closes), then fails the node.
After each, with ``gc.collect()`` and ``torch.cuda.empty_cache()``, it
logs how far the reserved device memory fell against the instance's KV
pool bytes, whether the instance, its graphs and its pools are still
referenced, and, from a memory snapshot, the live blocks that share a
cached segment with one of the KV pool's leaves (what keeps
``empty_cache`` from returning it) with their allocating frames.

To compare two versions in one call, run it on each checkout in turns.

Usage:  python3 scripts/release_memory.py [CHECKOUT]
"""

from __future__ import annotations

import gc
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def reserved() -> int:
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def pinning_blocks(ptrs: list[int]) -> list[str]:
    """The live blocks of every cached segment that holds one of ``ptrs``,
    with the port's frames that allocated them."""
    import torch
    out = []
    for seg in torch.cuda.memory._snapshot()["segments"]:
        start, size = seg["address"], seg["total_size"]
        if not any(start <= p < start + size for p in ptrs):
            continue
        for block in seg["blocks"]:
            if block["state"] == "inactive":
                continue
            frames = [f"{f['filename'].split('/')[-1]}:{f['line']}"
                      for f in block.get("frames", [])
                      if "repro" in f["filename"]][:3]
            out.append(f"segment of {size} bytes (pool "
                       f"{seg['segment_pool_id']}): live block of "
                       f"{block['size']} bytes from {frames}")
    return out


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("[release_memory] FAIL: no CUDA device", file=sys.stderr)
        return 2
    checkout = Path(argv[0]).resolve() if argv else ROOT
    sys.path[:0] = [str(checkout / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core.resources import Alloc
    from repro_torch.launch import serve

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cs.log(f"release memory of {checkout}")
    torch.cuda.memory._record_memory_history(max_entries=500000)
    model, params = serve.init_model(cs.ARCH, reduced=False, seed=cs.SEED)
    alloc = Alloc(sm=0.5, quota_request=0.5, quota_limit=1.0)
    prompts = cs.shared_prompts(np.random.default_rng(cs.SEED + 1),
                                model.cfg.vocab_size)
    short = 0
    for n_inst, mid_decode in ((1, False), (2, False), (2, True)):
        reserved()
        engine = cs.deploy(model, params, cs.ARCH, alloc, "paged",
                           n_instances=n_inst)
        cs.warm(engine, cs.ARCH, prompts[0])
        first = next(iter(engine.instances))
        inst = engine.instances[first]
        ptrs = [v.data_ptr() for v in inst.cache.values()]
        kv = sum(v.numel() * v.element_size() for v in inst.cache.values())
        refs = {k: weakref.ref(v) for k, v in inst.cache.items()}
        refs.update(instance=weakref.ref(inst),
                    round_graph=weakref.ref(inst.round_graph),
                    prefill_graphs=weakref.ref(inst.prefill_graphs))
        del inst
        if mid_decode:
            for p in prompts[:4]:
                engine.submit(cs.ARCH, p, max_new_tokens=8)
            engine.instances[first].run_step()
        r0 = reserved()
        engine.retire(first, strip_queue=False)
        engine.pump(budget_s=600.0)
        r1 = reserved()
        alive = sorted(k for k, r in refs.items() if r() is not None)
        short += r0 - r1 < kv
        when = "mid-decode" if mid_decode else "idle"
        cs.log(f"{n_inst} instance(s), retired {when}: reserved fell by "
               f"{r0 - r1} bytes against a KV pool of {kv}"
               f" ({'at least' if r0 - r1 >= kv else 'SHORT of'} it); still "
               f"referenced: {alive or 'nothing'}")
        for line in pinning_blocks(ptrs):
            cs.log(f"  KV segment pinned: {line}")
        engine.fail()
        del engine
        cs.log(f"  then the node failed: reserved fell by {r1 - reserved()}"
               f" bytes more")
    torch.cuda.memory._record_memory_history(enabled=None)
    cs.log(f"release memory of {checkout}: {short} of 3 cases short")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
