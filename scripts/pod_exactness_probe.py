"""Where can a sharded pod's bf16 results leave one device's bits?  A
member multiplies by its columns of ``wq``/``wk``/``w_up``/the head only
and attends over its own heads (``distributed/sharding.py``,
``models/attention.py`` ``attn_tp``), so its results are one device's
exactly where these agree bit for bit with the same columns or heads of
the one-device computation.

1. Column slices: for qwen2-7b's projections (d = 3584: ``wq``, ``wk``,
   ``w_up``, the head) and two reduced ones (d = 896: ``wq_tiny``,
   ``wk_r``, the card's reduced pod check), in bf16 and in f32 with TF32
   off, at 1-512 rows (odd counts too, as prefills take), each width is
   split into 2 and 4 column slices; every slice's product is compared
   with the full product's columns.
2. Attention kernels at a member's heads: causal flash (S = 512 and 317,
   28 q / 4 kv heads of 128) and dense and paged decode (B = 8, S = 1024, mixed
   lengths) over all heads, against the same kernel over a 2- and a
   4-member pod's share (14 / 2 and 7 / 1 heads), head for head.

One line a case: the entries that differ and the largest difference.
Inputs are drawn on the card from seed 0.

Usage (one card, from the repo root; builds the port's kernels):
  python3 scripts/pod_exactness_probe.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

SHAPES = {"wq": (3584, 3584), "wk": (3584, 512), "w_up": (3584, 18944),
          "head": (3584, 152064), "wq_tiny": (896, 896), "wk_r": (896, 128)}
ROWS = (1, 8, 64, 77, 128, 317, 512)
H, K, D = 28, 4, 128  # qwen2-7b's heads


def differ(piece: torch.Tensor, ref: torch.Tensor) -> tuple[int, float]:
    return (int((piece != ref).sum()),
            float((piece.float() - ref.float()).abs().max()))


def column_slices(dev, gen) -> None:
    for dtype in (torch.bfloat16, torch.float32):
        for name, (k, n) in SHAPES.items():
            w = (torch.randn((k, n), generator=gen, device=dev)
                 * k ** -0.5).to(dtype)
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                full = x @ w
                cols = []
                for parts in (2, 4):
                    c = n // parts
                    bad, worst = 0, 0.0
                    for j in range(parts):
                        piece = x @ w[:, j * c:(j + 1) * c].contiguous()
                        nb, wd = differ(piece, full[:, j * c:(j + 1) * c])
                        bad, worst = bad + nb, max(worst, wd)
                    cols.append(f"{parts} slices: {bad}/{m * n} differ "
                                f"(max {worst:.3g})")
                print(f"columns {str(dtype)[6:]} {name} ({k}x{n}) rows {m}: "
                      + "; ".join(cols), flush=True)


def member_heads(dev, gen) -> None:
    from repro_torch.kernels import ops

    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    s, b, bs = 512, 8, 16
    q, k, v = rand(1, s, H, D), rand(1, s, K, D), rand(1, s, K, D)
    qd, kc, vc = rand(b, 1, H, D), rand(b, 1024, K, D), rand(b, 1024, K, D)
    lens = torch.tensor([1024, 1, 517, 64, 1000, 333, 768, 129],
                        dtype=torch.int32, device=dev)
    per = 1024 // bs
    tables = torch.arange(b * per, dtype=torch.int32,
                          device=dev).view(b, per)
    kp, vp = (c.reshape(b * per, bs, K, D) for c in (kc, vc))

    def heads(t, sl):  # a member's heads, as its own contiguous tensor
        return t[:, :, sl].contiguous()

    cases = {
        "flash causal S=512": (lambda hq, hk: ops.flash_attention(
            heads(q, hq), heads(k, hk), heads(v, hk), causal=True)),
        "flash causal S=317": (lambda hq, hk: ops.flash_attention(
            heads(q[:, :317], hq), heads(k[:, :317], hk),
            heads(v[:, :317], hk), causal=True)),
        "decode": (lambda hq, hk: ops.decode_attention(
            heads(qd, hq), heads(kc, hk), heads(vc, hk), lens)),
        "paged decode": (lambda hq, hk: ops.paged_decode_attention(
            heads(qd, hq), heads(kp, hk), heads(vp, hk), tables, lens)),
    }
    for name, run in cases.items():
        full = run(slice(0, H), slice(0, K))
        cols = []
        for parts in (2, 4):
            hq, hk = H // parts, K // parts
            bad, worst = 0, 0.0
            for j in range(parts):
                piece = run(slice(j * hq, (j + 1) * hq),
                            slice(j * hk, (j + 1) * hk))
                nb, wd = differ(piece, full[:, :, j * hq:(j + 1) * hq])
                bad, worst = bad + nb, max(worst, wd)
            cols.append(f"{parts} members ({hq} q / {hk} kv): "
                        f"{bad}/{full.numel()} differ (max {worst:.3g})")
        print(f"heads {name}: " + "; ".join(cols), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the probe runs on the card only")
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    column_slices(dev, gen)
    member_heads(dev, gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
