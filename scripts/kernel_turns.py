"""Flash, WKV-6 and the selective scan at the smoke's main shapes: a
digest of each kernel's output bits and its device time, so that two
trees' kernels can be held to each other in turns in one call.

Shapes (``chip_smoke.py``'s kernel phase): flash causal at B=1, Sq=Sk=512,
28 q / 4 kv heads of 128; chunked WKV-6 at B=1, S=512, 32 heads of 64 and
the step kernel at a round (B=8, S=1); the chunked scan at B=1, S=640, 25
heads of 64, N=16 and the step kernel at a round (B=8, S=1).  Inputs come
from seed 0 (``chip_smoke.wkv6_inputs`` and ``ssm_inputs``); device time
is ``decode_shapes.device_split``'s (the profiler's kernel records over
30 calls, inputs rotating over copies larger than twice the L2).  One
JSON line a kernel, then the card's name and power limit.

``repro_torch`` is imported from whatever ``PYTHONPATH`` names, so in
turns with a ``git archive`` of the parent unpacked under ``build/``:

  PYTHONPATH=src python3 scripts/kernel_turns.py --label change
  PYTHONPATH=build/parent/src python3 scripts/kernel_turns.py --label parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402
import decode_shapes  # noqa: E402


def cases(dev):
    """(name, call, its inputs) of each kernel at its main shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import wkv6 as wk
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)

    yield ("flash_kernel B=1 Sq=Sk=512 28/4 D=128 causal",
           lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
           (rand(1, 512, 28, 128), rand(1, 512, 4, 128),
            rand(1, 512, 4, 128)))
    for name, fn, b, s in (("wkv6_chunked_kernel B=1 S=512 H=32",
                            wk.wkv6_chunked, 1, 512),
                           ("wkv6_kernel B=8 S=1 H=32", wk.wkv6_step, 8, 1)):
        yield name, fn, chip_smoke.wkv6_inputs(rng, dev, b, s, 32, 1.0)
    for name, fn, b, s in (("ssm_chunked_kernel B=1 S=640 H=25 N=16",
                            ss.ssm_chunked, 1, 640),
                           ("ssm_scan_kernel B=8 S=1 H=25 N=16", ss.ssm_step,
                            8, 1)):
        yield name, fn, chip_smoke.ssm_inputs(rng, dev, b, s, 25, 1.0)


def digest(outs) -> int:
    """Every output's bits, weighted by position."""
    total = 0
    for out in outs if isinstance(outs, tuple) else (outs,):
        bits = out.contiguous().view(torch.int16 if out.element_size() == 2
                                     else torch.int32).long().flatten()
        total += int((bits * torch.arange(1, bits.numel() + 1,
                                          device=bits.device)).sum())
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_turns: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for name, fn, inputs in cases(dev):
        out = fn(*inputs)
        nbytes = sum(x.numel() * x.element_size() for x in inputs)
        n = max(2, int(2 * decode_shapes.L2_BYTES // nbytes) + 1)
        sets = [[x.clone() for x in inputs] for _ in range(n)]
        split = decode_shapes.device_split([lambda x=x: fn(*x) for x in sets])
        print(json.dumps(dict(label=args.label, kernel=name,
                              output_digest=digest(out),
                              device_ms=sum(split.values()),
                              by_kernel=split)), flush=True)
        del sets
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
