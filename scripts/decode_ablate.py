"""Where the bf16 decode kernels' time goes: device time of edited copies
of ``csrc/decode_attention.cu`` at a few decode shapes.

Each variant copies ``src/repro_torch/csrc`` under ``build/``, applies
text edits to the decode source (each edit must match once), builds that
copy and times the kernels (``decode_shapes.device_split``: the
profiler's kernel records over 30 calls, inputs rotating over copies
larger than twice the L2).  The variants that drop work give wrong
outputs and are timed only:

- ``base``: the kernels as they are;
- ``no_compute``: the consumer warps wait for each tile and release it,
  without its products or softmax;
- ``no_merge``: no merge across the cluster (the kernel ends after the
  warps' merge: no cluster barrier, no distributed shared memory, no
  output);
- ``empty``: every CTA has no tiles (no loads, no products), the merges
  as they are;
- ``empty_no_merge``: both: the launch, the barriers' set-up and the
  warps' merge alone;
- ``no_dsmem``: the cluster merge's barriers and arithmetic without its
  loads from the peers' shared memory;
- ``paged_linear``: the paged producer takes page ``b * M + p`` for
  entry ``p`` of sequence b instead of the table's (the pool read in
  its own order rather than the tables' random one).

Each shape is timed under the bf16 plan (``cluster_plan``), the main
shape also with clusters of at most 8 splits.  The card's name and power
limit, then ``--rounds`` rounds (2) over the variants (``--only``: the
comma-separated names), each variant timed in a process of its own: one
line a variant and round.  One card, from the repo root:

  python3 scripts/decode_ablate.py
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import decode_shapes  # noqa: E402

NO_COMPUTE = [(
    """      float s[2][4];
      tile_scores<D>(q_lane, k_tile, box_bytes, k_row, k_x, s);
      const int r0 = (t_first + j) * kTile;
      warp_scale_mask<2>(s, scale_log2, [&](int, int c) {
        const int r = r0 + c;
        return ((bits >> c) & 1u) && r >= rows.lo && r < rows.hi;
      });
      warp_softmax<2, NO>(s, m, l, acc);
      tile_values<D>(s, k_tile + kBoxes * box_bytes, box_bytes, v_row, v_x,
                     acc);
""", "      acc[0][0] += (float)(bits + k_tile);\n")]
NO_MERGE = [("  cluster_sync();  // every split's partial is in its CTA's "
             "shared memory\n", "  return;\n")]
EMPTY = [("  const int n = max(0, t_end - t_first);",
          "  const int n = 0 * max(0, t_end - t_first);")]
NO_DSMEM = [(
    "        ml[rk] = ld_cluster2(cluster_map(ml_at + 8 * gg, rk));\n"
    "        v[rk] = ld_cluster2(cluster_map(part_at + 8 * i, rk));\n",
    "        ml[rk] = make_float2(0.f, 1.f);\n"
    "        v[rk] = make_float2(0.f, 0.f);\n")]
PAGED_LINEAR = [(
    "c3 = lane < kTile && page < rows.M ? tbl[page - w_lo] : -1;",
    "c3 = lane < kTile && page < rows.M ? (int)blockIdx.y * rows.M + page "
    ": -1;")]
VARIANTS = {
    "base": [],
    "no_compute": NO_COMPUTE,
    "no_merge": NO_MERGE,
    "empty": EMPTY,
    "empty_no_merge": EMPTY + NO_MERGE,
    "no_dsmem": NO_DSMEM,
    "paged_linear": PAGED_LINEAR,
}
MIXED = decode_shapes.MIXED
# (label, B, S, H, KV, D, page (None: dense), cache_len, max cluster)
SHAPES = [("main", 8, 1024, 28, 4, 128, None, MIXED, 16),
          ("main c8", 8, 1024, 28, 4, 128, None, MIXED, 8),
          ("main paged", 8, 1024, 28, 4, 128, 16, MIXED, 16),
          ("D=16", 8, 1024, 28, 4, 16, None, MIXED, 16),
          ("D=16 paged", 8, 1024, 28, 4, 16, 16, MIXED, 16),
          ("B=1", 1, 1024, 28, 4, 128, None, [1024], 16)]


def variant_csrc(build, name: str, edits) -> Path:
    dst = build.BUILD_ROOT.parent / f"decode_ablate_{name}" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    src = dst / "decode_attention.cu"
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
    from repro_torch.kernels import decode_attention as da
    build.CSRC = variant_csrc(build, name, VARIANTS[name])
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(0)
    times = []
    for label, b, s, h, kv, d, page, lens, cluster in SHAPES:
        da.MAX_CLUSTER = cluster

        def rand(*shape):
            x = gen.standard_normal(shape).astype(np.float32)
            return torch.from_numpy(x).to(dev).to(torch.bfloat16)
        q, kc, vc = rand(b, 1, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        n = max(2, int(2 * decode_shapes.L2_BYTES // (kc.numel() * 4)) + 1)
        if page is None:
            sets = [[x.clone() for x in (q, kc, vc)] for _ in range(n)]
            calls = [lambda x=x: da.decode_attention(*x, lens_t)
                     for x in sets]
        else:
            (kp, vp), tables = decode_shapes.paged_copy((kc, vc), page, gen)
            sets = [[x.clone() for x in (q, kp, vp)] for _ in range(n)]
            calls = [lambda x=x: da.paged_decode_attention(*x, tables,
                                                           lens_t)
                     for x in sets]
        times.append(sum(decode_shapes.device_split(calls).values()))
        del sets
    print(f"{name:15s} " + "  ".join(
        f"{shape[0]} {t:.5f}" for shape, t in zip(SHAPES, times)),
        flush=True)


def main(argv: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variant", nargs="?", help=argparse.SUPPRESS)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    if args.variant:  # one variant, in a process of its own
        time_variant(args.variant)
        return 0
    names = [n for n in args.only.split(",") if n] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    failed = 0
    for rnd in range(args.rounds):
        for name in names:
            print(f"round {rnd} ", end="", flush=True)
            failed += subprocess.run([sys.executable, __file__, name]
                                     ).returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
