"""Where the decode kernels' time goes: device time of edited copies of
``csrc/decode_attention.cu`` at a few decode shapes, bf16 and int8 (one
body serves both, so an edit of it reaches all four kernels).

Each variant copies ``src/repro_torch/csrc`` under ``build/``, applies
text edits to the decode source (each edit must match once), builds that
copy and times the kernels (``decode_shapes.device_split``: the
profiler's kernel records over 30 calls, inputs rotating over copies
larger than twice the L2).  The variants that drop work give wrong
outputs and are timed only:

- ``base``: the kernels as they are;
- ``no_compute``: the consumer warps wait for each tile and release it,
  without its products, softmax or (int8) the widening of its codes;
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
  its own order rather than the tables' random one);
- ``no_widen``: the int8 consumer warps put the codes' bytes into their
  B fragments as they are (one byte permute), without widening them or
  the scales (the codes still load, the products still run);
- ``no_scales``: the int8 producer copies no scales, its lanes still
  arriving on the full barrier (its chain without them; the consumers
  widen whatever the slots hold);
- ``smem_max``: every int8 launch asks the shared memory of a full ring
  (at most as many CTAs an SM as bf16 at the main shape).

Each shape is timed under the plan (``cluster_plan``), the main bf16
shape also with clusters of at most 8 splits.  The card's name and power
limit, then ``--rounds`` rounds (2) over the variants (``--only``: the
comma-separated names; ``--shapes``: the shapes whose labels contain one
of its comma-separated words), each variant timed in a process of its
own: one line a variant and round.  One card, from the repo root:

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
    """      unsigned ks[2], vs[4];
      float s[2][4];
      if constexpr (kQ8) {
        const unsigned* sc = scales + st * kTile * 2;
        const unsigned odd = odds[st];
#pragma unroll
        for (int i = 0; i < 2; ++i) ks[i] = row_scale(sc, odd, k8[i], 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) vs[i] = row_scale(sc, odd, v8[i], 1);
        tile_scores_q8<D>(q_lane, tile_p, k8_row, k8_x, ks, s);
      } else {
        tile_scores<D>(q_lane, tile, box_bytes, k_row, k_x, s);
      }
      const int r0 = (t_first + j) * kTile;
      warp_scale_mask<2>(s, scale_log2, [&](int, int c) {
        const int r = r0 + c;
        return ((bits >> c) & 1u) && r >= rows.lo && r < rows.hi;
      });
      // The accumulators' rescale, but where it changes no bit: before
      // the warp's first tile (they are 0) or where no row's maximum
      // moved (every factor 1).
      float alpha[2];
      softmax_tile<2>(s, m, l, alpha);
      if (j != warp &&
          !__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f))
        warp_rescale<NO>(acc, alpha);
      if constexpr (kQ8)
        tile_values_q8<D>(s, tile_p + box_bytes, v8_row, v8_x, vs, acc);
      else
        tile_values<D>(s, tile + kBoxes * box_bytes, box_bytes, v_row, v_x,
                       acc);
""",
    "      acc[0][0] += (float)(bits + tile) + tile_p[0];\n")]
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
NO_WIDEN = [(
    """  const unsigned m = (t & 0x007f007fu) | 0x43004300u;
  const unsigned k = (t & 0x00800080u) | 0xc300c300u;
  unsigned c, out;
  asm("add.rn.bf16x2 %0, %1, %2;\\n" : "=r"(c) : "r"(m), "r"(k));
  asm("mul.rn.bf16x2 %0, %1, %2;\\n" : "=r"(out) : "r"(c), "r"(s2));
  return out;""", "  return t ^ s2;")]
SMEM_MAX = [("smem_bytes<kD, true>(stages, H / KV, kTile)", "max_smem<kD>()"),
            ("smem_bytes<kD, true>(stages, H / KV, g)", "max_smem<kD>()")]
NO_SCALES = [(
    """          cp_async4(slot, reinterpret_cast<const void*>(
                              reinterpret_cast<uintptr_t>(ks) & ~3ull),
                    stored);
          cp_async4(slot + 4, reinterpret_cast<const void*>(
                                  reinterpret_cast<uintptr_t>(vs) & ~3ull),
                    stored);
""", "")]
VARIANTS = {
    "base": [],
    "no_compute": NO_COMPUTE,
    "no_merge": NO_MERGE,
    "empty": EMPTY,
    "empty_no_merge": EMPTY + NO_MERGE,
    "no_dsmem": NO_DSMEM,
    "paged_linear": PAGED_LINEAR,
    "no_widen": NO_WIDEN,
    "no_scales": NO_SCALES,
    "smem_max": SMEM_MAX,
}
MIXED = decode_shapes.MIXED
# (label, B, S, H, KV, D, page (None: dense), cache_len, max cluster);
# "int8" shapes time the int8 pair on the rows quantized on the card.
SHAPES = [("main", 8, 1024, 28, 4, 128, None, MIXED, 16),
          ("main c8", 8, 1024, 28, 4, 128, None, MIXED, 8),
          ("main paged", 8, 1024, 28, 4, 128, 16, MIXED, 16),
          ("D=16", 8, 1024, 28, 4, 16, None, MIXED, 16),
          ("D=16 paged", 8, 1024, 28, 4, 16, 16, MIXED, 16),
          ("B=1", 1, 1024, 28, 4, 128, None, [1024], 16),
          ("int8 main", 8, 1024, 28, 4, 128, None, MIXED, 16),
          ("int8 main paged", 8, 1024, 28, 4, 128, 16, MIXED, 16),
          ("int8 D=16", 8, 1024, 28, 4, 16, None, MIXED, 16),
          ("int8 B=1", 1, 1024, 28, 4, 128, None, [1024], 16)]


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


def time_variant(name: str, words: list[str]) -> None:
    """One line: the variant's device time at every shape (whose label
    contains one of ``words``, where any are given)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.attention import kv_quantize
    build.CSRC = variant_csrc(build, name, VARIANTS[name])
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(0)
    times = []
    shapes = [x for x in SHAPES if not words or any(w in x[0] for w in words)]
    for label, b, s, h, kv, d, page, lens, cluster in shapes:
        da.MAX_CLUSTER = cluster

        def rand(*shape):
            x = gen.standard_normal(shape).astype(np.float32)
            return torch.from_numpy(x).to(dev).to(torch.bfloat16)
        q, kc, vc = rand(b, 1, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        n = max(2, int(2 * decode_shapes.L2_BYTES // (kc.numel() * 4)) + 1)
        int8 = label.startswith("int8")
        leaves = ((*kv_quantize(kc), *kv_quantize(vc)) if int8
                  else (kc, vc))
        if int8:  # codes, codes, scales, scales
            leaves = (leaves[0], leaves[2], leaves[1], leaves[3])
        fn = {(False, False): da.decode_attention,
              (False, True): da.paged_decode_attention,
              (True, False): da.decode_attention_quant,
              (True, True): da.paged_decode_attention_quant}[
                  (int8, page is not None)]
        tail = (lens_t,)
        if page is not None:
            leaves, tables = decode_shapes.paged_copy(leaves, page, gen)
            tail = (tables, lens_t)
        sets = [[x.clone() for x in (q, *leaves)] for _ in range(n)]
        calls = [lambda x=x: fn(*x, *tail) for x in sets]
        times.append(sum(decode_shapes.device_split(calls).values()))
        del sets
    print(f"{name:15s} " + "  ".join(
        f"{shape[0]} {t:.5f}" for shape, t in zip(shapes, times)),
        flush=True)


def main(argv: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variant", nargs="?", help=argparse.SUPPRESS)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="")
    ap.add_argument("--shapes", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    if args.variant:  # one variant, in a process of its own
        time_variant(args.variant,
                     [w for w in args.shapes.split(",") if w])
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
            failed += subprocess.run([sys.executable, __file__, name,
                                      "--shapes", args.shapes]
                                     ).returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
