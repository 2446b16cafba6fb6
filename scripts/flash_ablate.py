"""Where the flash kernel's time goes: device time of edited copies of
``csrc/flash_attention.cu`` at a few prefill shapes.

Each variant copies ``src/repro_torch/csrc`` under ``build/``, applies
text edits to the flash source (each edit must match once), builds that
copy and times the kernel (``flash_shapes.device_ms``: the profiler's
kernel records over 30 calls, inputs rotating over copies larger than
twice the L2).  The variants that drop work give wrong outputs and are
timed only:

- ``base``: the kernel as it is;
- ``loads``: no products and no softmax (the TMA loads of Q and the K/V
  rings, the barriers and the stores are left);
- ``no_softmax``: both products, no scale, mask or softmax;
- ``no_pv``: no P . V product;
- ``one_cta_s2``, ``one_cta_s3``, ``one_cta_s4``: one CTA an SM
  (``kMinBlocks = 1``, 240 registers a consumer thread, no second-wave
  reversal) with 2, 3 or 4 stages a ring (two CTAs an SM leave room for
  2 at D = 128);
- ``loads_one_cta_s4``: ``loads`` at one CTA an SM and 4 stages;
- ``in_order``: no second-wave reversal (CTAs take their tiles
  heaviest first throughout).

The card's name and power limit, then two rounds over the variants,
each variant timed in a process of its own (about 28 s each on the
card's machine, builds included): one line a variant and round.  One
card, from the repo root:

  python3 scripts/flash_ablate.py
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import flash_shapes  # noqa: E402

# One CTA an SM: its registers, and no second-wave reversal (a second
# wave then starts as SMs free up, heaviest first).
ONE_CTA = [("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;"),
           ("constexpr int kConsumerRegs = 2 * kEntryRegs - kProducerRegs;",
            "constexpr int kConsumerRegs = 240;"),
           ("scale * REPRO_LOG2E, sms);",
            "scale * REPRO_LOG2E, (int)(grid.x * grid.y * grid.z));")]


def ring(stages: int) -> tuple[str, str]:
    return ("budget / (2 * tile_bytes<D>()) > 4 ? 4",
            f"budget / (2 * tile_bytes<D>()) > {stages} ? {stages}")


NO_SOFTMAX = [("      softmax(0);  // O is still 0: nothing to rescale\n",
               ""), ("        softmax(i);\n", "")]
NO_PV = [("        values(i - 1);\n", ""), ("      values(n_kt - 1);\n", "")]
LOADS = NO_SOFTMAX + NO_PV + [("      scores(0);\n", ""),
                              ("        scores(i);\n", "")]
VARIANTS = {
    "base": [],
    "loads": LOADS,
    "no_softmax": NO_SOFTMAX,
    "no_pv": NO_PV,
    "one_cta_s2": ONE_CTA + [ring(2)],
    "one_cta_s3": ONE_CTA + [ring(3)],
    "one_cta_s4": ONE_CTA,
    "loads_one_cta_s4": ONE_CTA + LOADS,
    "in_order": [("? first_wave + n_cta - 1 - L", "? L")],
}
# (label, B, S, H, KV, window), D = 128, causal, Sq = Sk
SHAPES = [("main 28/4", 1, 512, 28, 4, None),
          ("member 7/1", 1, 512, 7, 1, None),
          ("16/16", 1, 512, 16, 16, None),
          ("gemma3 local", 1, 1920, 32, 16, 1024),
          ("training 4x512", 4, 512, 28, 4, None)]


def variant_csrc(build, name: str, edits) -> Path:
    dst = build.BUILD_ROOT.parent / f"flash_ablate_{name}" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    src = dst / "flash_attention.cu"
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit {old!r} does not match "
                             f"once in {src}")
        text = text.replace(old, new)
    src.write_text(text)
    return dst


def time_variant(name: str) -> None:
    """One line: the variant's device time at every shape."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    build.CSRC = variant_csrc(build, name, VARIANTS[name])
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(0)
    times = []
    for label, b, s, h, kv, window in SHAPES:
        def rand(*shape):
            x = gen.standard_normal(shape).astype(np.float32)
            return torch.from_numpy(x).to(dev).to(torch.bfloat16)
        qkv = [rand(b, s, h, 128), rand(b, s, kv, 128), rand(b, s, kv, 128)]
        io = 2 * sum(x.numel() for x in qkv) + 2 * qkv[0].numel()
        n = max(2, int(2 * flash_shapes.L2_BYTES // io) + 1)
        sets = [[x.clone() for x in qkv] for _ in range(n)]
        times.append(flash_shapes.device_ms(
            [lambda x=x: fa.flash_attention(*x, window=window)
             for x in sets]))
        del sets
    print(f"{name:17s} " + "  ".join(
        f"{shape[0]} {t:.5f}" for shape, t in zip(SHAPES, times)),
        flush=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("flash_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    if argv:  # one variant, in a process of its own
        time_variant(argv[0])
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    # Each variant in a fresh process: a long run of profiler windows and
    # library reloads in one process came back without device records.
    failed = 0
    for rnd in range(2):
        for name in VARIANTS:
            print(f"round {rnd} ", end="", flush=True)
            failed += subprocess.run([sys.executable, __file__, name]
                                     ).returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
