"""The decode kernels, dense and paged, bf16 and (``--int8``) int8, at
every decode shape the port's smoke runs, beside PyTorch's SDPA and the
card's bound.

For each shape: the kernel's output against its plain version (bf16,
tolerance 2e-2; the script fails past it; a paged shape also bit-equal
to the dense kernel on the same rows), a digest of its output bits
(equal across trees whose arithmetic is unchanged), the device time of a
call split by CUDA kernel (``torch.profiler``'s kernel records over 30
calls), the CUDA-event time, the host's microseconds a call of the
wrapper (``host_us``: checks, output allocation, tensor maps, the
launch; the median of five runs of 100 calls), SDPA's device time beside
the dense bf16 kernel (``enable_gqa``, a length mask), and the bound: the
larger of the bytes (the live K/V rows, or codes and scales, q, o, the
lengths and table entries, each once) over ``launch/mesh.py``'s
``HBM_BW`` and the 4 * H * D flops a row over its ``PEAK_FLOPS_BF16``.
Calls rotate over copies of the inputs larger than twice the 50 MB L2,
so every call reads cold memory.  One JSON line a shape and kind, then
the card's name and power limit.

``repro_torch`` is imported from whatever ``PYTHONPATH`` names, so the
same script times another tree's kernels (a ``git archive`` of the
parent commit unpacked under ``build/``) in turns with this one:

  PYTHONPATH=src python3 scripts/decode_shapes.py --label change
  PYTHONPATH=build/parent/src python3 scripts/decode_shapes.py --label parent

``--max-cluster N`` plans the launches of a tree that has
``cluster_plan`` with at most N splits (its ``MAX_CLUSTER``, 8 or 16;
the kernel takes up to 16); ``--only`` keeps the shapes whose names
contain one of its comma-separated words; ``--int8`` adds the int8
kernels, dense and paged, at every shape with pages, on the bf16 rows
quantized on the card (no PyTorch call computes them).
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
MIXED = [1024, 1, 517, 64, 1000, 333, 768, 129]
GEMMA = [2048, 1, 1517, 64, 1900, 333, 1168, 129]
# (name, B, S, H, KV, D, page (None: dense only), plan_kv, cache_len)
SHAPES = [
    ("main qwen2-7b 28/4", 8, 1024, 28, 4, 128, 16, None, MIXED),
    ("main pages of 8", 8, 1024, 28, 4, 128, 8, None, MIXED),
    ("main pages of 32", 8, 1024, 28, 4, 128, 32, None, MIXED),
    ("starcoder2 48/4 G=12", 8, 1024, 48, 4, 128, 16, None, MIXED),
    ("gemma3 global 32/16 G=2 S=2048", 8, 2048, 32, 16, 128, 16, None,
     GEMMA),
    ("qwen2-moe 16/16 G=1", 8, 1024, 16, 16, 128, 16, None, MIXED),
    ("vision self 32/8 G=4", 8, 1024, 32, 8, 128, None, None, MIXED),
    ("seamless self 16/16 D=64", 8, 1024, 16, 16, 64, None, None, MIXED),
    ("member 2 of qwen2-7b 14/2", 8, 1024, 14, 2, 128, 16, 4, MIXED),
    ("member 4 of qwen2-7b 7/1", 8, 1024, 7, 1, 128, 16, 4, MIXED),
    ("member 4 of qwen2-moe 4/4", 8, 1024, 4, 4, 128, 16, 16, MIXED),
    ("D=32 28/4", 8, 1024, 28, 4, 32, 16, None, MIXED),
    ("D=16 28/4", 8, 1024, 28, 4, 16, 16, None, MIXED),
    ("B=1 full 28/4", 1, 1024, 28, 4, 128, 16, None, [1024]),
]


def device_split(calls, tries: int = 3) -> dict:
    """Device ms a call by CUDA kernel name, from the profiler's kernel
    records; a window that came back without records (it happens) is
    taken again."""
    from torch.profiler import ProfilerActivity, profile
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(ITERS):
                calls[i % len(calls)]()
            torch.cuda.synchronize()
        by = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CPU:
                ns = e.duration_ns() if hasattr(e, "duration_ns") \
                    else e.duration_us() * 1e3
                name = e.name().replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("(")[0]
                by[name] = by.get(name, 0.0) + ns / 1e6 / ITERS
        if by:
            return by
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


def paged_copy(xs, page, gen):
    """Dense (B, S, KV, D) leaves scattered over ``page``-row pages in a
    random order: (pools, (B, S / page) int32 tables)."""
    b, s = xs[0].shape[:2]
    m = s // page
    order = torch.as_tensor(gen.permutation(b * m).astype(np.int32),
                            device=xs[0].device)
    pools = []
    for x in xs:
        pool = torch.empty((b * m, page, *x.shape[2:]), dtype=x.dtype,
                           device=x.device)
        pool[order.long()] = x.reshape(b * m, page, *x.shape[2:])
        pools.append(pool)
    return pools, order.reshape(b, m)


def check(name, got, want) -> float:
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=TOL,
                               rtol=TOL, msg=lambda m: f"{name}: {m}")
    return err


def digest(out) -> int:
    """The output's bits, weighted by position: equal iff (almost surely)
    the bits are."""
    return int(out.view(torch.int16).long().mul(
        torch.arange(1, out.numel() + 1, device=out.device).view(out.shape))
        .sum())


def int8_lines(label, da, mesh, shape, q, kc, vc, lens_t, page, plan_kv,
               gen) -> None:
    """The int8 kernels at one shape, on the codes and scales of ``kc``
    and ``vc``: dense and over ``page``-row pages, each against its plain
    version, paged bit-equal to dense."""
    from repro_torch.models.attention import kv_quantize
    b, _, h, d = q.shape
    s, kv = kc.shape[1:3]
    k8, ks, v8, vs = kv_quantize(kc) + kv_quantize(vc)
    pools, tables = paged_copy((k8, v8, ks, vs), page, gen)
    lens = lens_t.tolist()
    rows = int(np.minimum(lens, s).sum())
    entries = int(sum(-(-min(x, s) // page) for x in lens))
    t_ops = 4 * h * d * rows / mesh.PEAK_FLOPS_BF16
    n = max(2, int(2 * L2_BYTES // (k8.numel() * 2)) + 1)
    dense = None
    for kind, fn, plain, leaves, tail, extra in (
            ("int8 dense", da.decode_attention_quant,
             da.decode_attention_quant_plain, (k8, v8, ks, vs), (lens_t,),
             0),
            (f"int8 paged {page}", da.paged_decode_attention_quant,
             da.paged_decode_attention_quant_plain, pools, (tables, lens_t),
             4 * entries)):
        out = fn(q, *leaves, *tail, plan_kv=plan_kv)
        err = check(f"{shape} {kind}", out, plain(q, *leaves, *tail))
        if dense is None:
            dense = out
        elif not torch.equal(out, dense):
            raise AssertionError(f"{shape}: int8 paged differs from dense")
        io = (2 * rows * kv * (d + 2) + 2 * q.numel() * 2 + 4 * b + extra)
        sets = [[x.clone() for x in (q, *leaves)] for _ in range(n)]
        calls = [lambda x=x: fn(*x, *tail, plan_kv=plan_kv) for x in sets]
        split = device_split(calls)
        t_bytes = io / mesh.HBM_BW
        print(json.dumps(dict(
            label=label, shape=shape, kind=kind, B=b, S=s, H=h, KV=kv, D=d,
            plan_kv=plan_kv, max_abs_err=err, output_digest=digest(out),
            device_ms=sum(split.values()), by_kernel=split,
            ms=event_ms(calls),
            wrapper_us=host_us(lambda: fn(q, *leaves, *tail,
                                          plan_kv=plan_kv)),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes")),
            flush=True)
        del sets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default="")
    ap.add_argument("--max-cluster", type=int, default=0)
    ap.add_argument("--int8", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_shapes: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import mesh
    if args.max_cluster and hasattr(da, "MAX_CLUSTER"):
        da.MAX_CLUSTER = args.max_cluster
    label = args.label or str(Path(da.__file__).resolve().parents[2])
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(0)
    words = [w for w in args.only.split(",") if w]
    for name, b, s, h, kv, d, page, plan_kv, lens in SHAPES:
        if words and not any(w in name for w in words):
            continue

        def rand(*shape):
            x = gen.standard_normal(shape).astype(np.float32)
            return torch.from_numpy(x).to(dev).to(torch.bfloat16)

        q, kc, vc = rand(b, 1, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        dense = da.decode_attention(q, kc, vc, lens_t, plan_kv=plan_kv)
        err = check(name, dense, da.decode_attention_plain(q, kc, vc, lens_t))
        rows = int(np.minimum(lens, s).sum())
        io = 2 * rows * kv * d * 2 + 2 * q.numel() * 2 + 4 * b
        n = max(2, int(2 * L2_BYTES // (kc.numel() * 4)) + 1)
        sets = [[x.clone() for x in (q, kc, vc)] for _ in range(n)]
        kernel = [lambda x=x: da.decode_attention(*x, lens_t,
                                                  plan_kv=plan_kv)
                  for x in sets]
        tsets = [[x[0].reshape(b, h, 1, d)]
                 + [c.transpose(1, 2).contiguous() for c in x[1:]]
                 for x in sets]
        mask = (torch.arange(s, device=dev)[None, :]
                < lens_t[:, None])[:, None, None, :]
        sdpa = [lambda x=x: F.scaled_dot_product_attention(
            *x, attn_mask=mask, enable_gqa=True) for x in tsets]
        flops = 4 * h * d * rows
        t_ops = flops / mesh.PEAK_FLOPS_BF16
        split = device_split(kernel)
        line = dict(
            label=label, shape=name, kind="dense", B=b, S=s, H=h, KV=kv,
            D=d, plan_kv=plan_kv, max_abs_err=err,
            output_digest=digest(dense),
            device_ms=sum(split.values()), by_kernel=split,
            ms=event_ms(kernel),
            wrapper_us=host_us(lambda: da.decode_attention(
                q, kc, vc, lens_t, plan_kv=plan_kv)),
            sdpa_device_ms=sum(device_split(sdpa).values()),
            bound_ms=max(t_ops, io / mesh.HBM_BW) * 1e3,
            bound_by="operations" if t_ops > io / mesh.HBM_BW else "bytes")
        print(json.dumps(line), flush=True)
        del sets, tsets
        if page is None:
            continue
        (kp, vp), tables = paged_copy((kc, vc), page, gen)
        paged = da.paged_decode_attention(q, kp, vp, tables, lens_t,
                                          plan_kv=plan_kv)
        err = check(f"{name} paged", paged,
                    da.paged_decode_attention_plain(q, kp, vp, tables,
                                                    lens_t))
        if not torch.equal(paged, dense):
            raise AssertionError(f"{name}: paged differs from dense")
        entries = int(sum(-(-min(x, s) // page) for x in lens))
        io_p = io + 4 * entries
        psets = [[x.clone() for x in (q, kp, vp)] for _ in range(n)]
        kernel = [lambda x=x: da.paged_decode_attention(
            *x, tables, lens_t, plan_kv=plan_kv) for x in psets]
        split = device_split(kernel)
        print(json.dumps(dict(
            label=label, shape=name, kind=f"paged {page}", B=b, S=s, H=h,
            KV=kv, D=d, plan_kv=plan_kv, max_abs_err=err,
            output_digest=digest(paged),
            device_ms=sum(split.values()), by_kernel=split,
            ms=event_ms(kernel),
            wrapper_us=host_us(lambda: da.paged_decode_attention(
                q, kp, vp, tables, lens_t, plan_kv=plan_kv)),
            bound_ms=max(t_ops, io_p / mesh.HBM_BW) * 1e3,
            bound_by="operations" if t_ops > io_p / mesh.HBM_BW
            else "bytes")), flush=True)
        del psets
        if args.int8:
            int8_lines(label, da, mesh, name, q, kc, vc, lens_t, page,
                       plan_kv, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()} (build {build.CSRC}, max cluster "
          f"{getattr(da, 'MAX_CLUSTER', 'none')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
