#!/usr/bin/env python3
"""The selective scan's decode round in one checkout of the port, on one GPU.

Builds and imports ``src/repro_torch`` from CHECKOUT (by default the
checkout that holds this script) and logs:

- the scan's step kernel's device time at hymba-1.5b's round (B=8, S=1,
  H=25, D=64, N=16), out of place (a new state buffer: every version of
  the wrapper takes that call);
- two floors of that time: a ``Tensor.copy_`` of the round's f32 state
  into a buffer apart (one kernel that reads and writes the state's bytes
  once) and a ``zero_`` of 16 floats (a launch and its drain);
- hymba-1.5b's profile window (8 requests x 8 tokens, continuous, one
  instance), whose log counts the copy and memcpy kernels.

To compare two versions in one call, run it on each checkout in turns
(parent, change, change, parent).  The timing and profiling helpers are
those of ``chip_smoke.py`` beside this script's directory.

Usage:  python3 scripts/scan_round.py [CHECKOUT]
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("[scan_round] FAIL: no CUDA device", file=sys.stderr)
        return 2
    checkout = Path(argv[0]).resolve() if argv else ROOT
    sys.path[:0] = [str(checkout / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core.resources import Alloc
    from repro_torch.kernels import build, ssm_scan
    from repro_torch.launch import serve

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cs.log(f"scan round of {checkout}: kernels {build.build()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(cs.SEED + 4)
    decode = cs.ssm_inputs(rng, dev, 8, 1, 25, 1.0)
    sets = [[v.clone() for v in decode]
            for _ in range(cs.copies_for(cs.ssm_cost(8, 1, 25)[1]))]
    ms = cs.device_ms([lambda v=v: ssm_scan.ssm_step(*v) for v in sets],
                      label="ssm step")
    cs.log(f"scan round: the step kernel at B=8 S=1 H=25 D=64 N=16, out of "
           f"place: device_ms={ms}")
    outs = [torch.empty_like(v[5]) for v in sets]
    copy_ms = cs.device_ms([lambda v=v, o=o: o.copy_(v[5])
                            for v, o in zip(sets, outs)])
    tiny = [torch.zeros(16, device=dev) for _ in range(4)]
    zero_ms = cs.device_ms([lambda t=t: t.zero_() for t in tiny])
    cs.log(f"scan round: floors: Tensor.copy_ of the round's state "
           f"({sets[0][5].nbytes} bytes read and written) device_ms="
           f"{copy_ms}; zero_ of 16 floats device_ms={zero_ms}")
    model, params = serve.init_model(cs.HYBRID_ARCH, reduced=False,
                                     seed=cs.SEED)
    prompts = [rng.integers(0, model.cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(64, 513, 8)]
    cs.profile_window(model, params, prompts,
                      Alloc(sm=0.5, quota_request=0.5, quota_limit=1.0),
                      cs.HYBRID_ARCH, "continuous")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
