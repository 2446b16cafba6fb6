#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and then:

1. kernel phase — holds each kernel against its plain PyTorch version on
   the card (bf16, tolerance 2e-2 as ``tests/test_kernels.py``) at the
   main path's shapes and at edge shapes, and times kernel, plain version,
   one PyTorch library call where one computes the same function, and the
   card's bound for the same work;
2. reference phase — a 2-layer model with qwen2-7b's head geometry
   (head dim 128, 7 query heads per kv head) runs prefill, dense decode
   and paged decode on the card through the kernels, against the same
   weights in f32 on the CPU through the plain versions;
3. serve phase — full-width qwen2-7b (28 layers, d=3584; random bf16
   weights from a seed) on one ``ServingEngine``, two instances sharing
   one weight copy, continuous then paged (block size 16), 16 requests of
   64-512 prompt tokens and 32 new tokens each; launch counts are set to 0
   just before each mode and read just after it.

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero, and so does a machine without a card.

Usage:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_FLOPS = 989e12   # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
TOL = 2e-2            # bf16 kernel vs plain version (tests/test_kernels.py)
REF_TOL = 5e-2        # bf16 model on the card vs f32 model on the CPU,
#                       as max |diff| / max |reference logit|
L2_BYTES = 50e6       # timed inputs rotate over copies exceeding 2x L2
SEED = 0
ARCH = "qwen2-7b"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(calls, iters: int = 30) -> float:
    """Mean ms per call, CUDA events around ``iters`` calls after warm-up;
    ``calls`` rotate over input copies so every call reads cold memory."""
    import torch
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def copies_for(nbytes: float) -> int:
    return max(2, int(2 * L2_BYTES // max(nbytes, 1)) + 1)


def close(name: str, out, ref) -> float:
    import torch
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL,
                               msg=lambda m: f"{name}: {m}")
    return err


# --------------------------------------------------------------------------
# 1. kernels against their plain versions
# --------------------------------------------------------------------------


def kernel_phase(rng) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda", torch.cuda.current_device())

    def rand(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(dev).to(torch.bfloat16)

    out = {}
    # -- flash attention (prefill): main shape B=1, Sq=Sk=512, causal ------
    b, s, h, kv, d = 1, 512, 28, 4, 128
    q, k, v = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    err = close("flash main", fa.flash_attention(q, k, v, causal=True),
                fa.flash_attention_plain(q, k, v, causal=True))
    for (eb, sq, sk, causal, window, q_off, ed) in [
            (2, 37, 37, True, None, 0, 128),   # Sq not a tile multiple
            (1, 1, 1, True, None, 0, 128),     # bucket of one token
            (1, 100, 100, True, 33, 0, 128),   # sliding window
            (1, 20, 84, True, None, 64, 128),  # q_offset (chunk at tail)
            (2, 40, 70, False, None, 0, 128),  # non-causal, ragged Sk
            (1, 65, 65, True, None, 0, 64)]:   # head dim 64
        eq, ek, ev = rand(eb, sq, h, ed), rand(eb, sk, kv, ed), \
            rand(eb, sk, kv, ed)
        close(f"flash edge {(eb, sq, sk, causal, window, q_off, ed)}",
              fa.flash_attention(eq, ek, ev, causal=causal, window=window,
                                 q_offset=q_off),
              fa.flash_attention_plain(eq, ek, ev, causal=causal,
                                       window=window, q_offset=q_off))
    io_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
    n = copies_for(io_bytes)
    qs = [q.clone() for _ in range(n)]
    ks = [k.clone() for _ in range(n)]
    vs = [v.clone() for _ in range(n)]
    qt = [x.transpose(1, 2).contiguous() for x in qs]
    kt = [x.transpose(1, 2).contiguous() for x in ks]
    vt = [x.transpose(1, 2).contiguous() for x in vs]
    pairs = s * (s + 1) // 2
    bnd, by = bound(4 * b * h * d * pairs, io_bytes)
    out["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:94",
        max_abs_err=err,
        ms=time_ms([lambda i=i: fa.flash_attention(qs[i], ks[i], vs[i])
                    for i in range(n)]),
        plain_ms=time_ms([lambda i=i: fa.flash_attention_plain(
            qs[i], ks[i], vs[i]) for i in range(n)], iters=6),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms([lambda i=i: F.scaled_dot_product_attention(
            qt[i], kt[i], vt[i], is_causal=True, enable_gqa=True)
            for i in range(n)]),
        shape="B=1 Sq=Sk=512 H=28 K=4 D=128 causal bf16")

    # -- decode attention (continuous): B=8, S=1024, mixed cache_len ------
    b, s = 8, 1024
    lens_np = np.array([1024, 1, 517, 64, 1000, 333, 768, 129], np.int32)
    q, kc, vc = rand(b, 1, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    lens = torch.as_tensor(lens_np, device=dev)
    dense_out = da.decode_attention(q, kc, vc, lens)
    err = close("decode main", dense_out,
                da.decode_attention_plain(q, kc, vc, lens))
    for name, el, win in [("cache_len=1", [1] * b, None),
                          ("cache_len=S", [s] * b, None),
                          ("window=100", lens_np, 100),
                          ("cache_len>S (free slot)", lens_np + s, None)]:
        elt = torch.as_tensor(np.asarray(el, np.int32), device=dev)
        close(f"decode edge {name}",
              da.decode_attention(q, kc, vc, elt, window=win),
              da.decode_attention_plain(q, kc, vc, elt, window=win))
    rows = int(np.minimum(lens_np, s).sum())
    kv_bytes = 2 * rows * kv * d * 2
    io = kv_bytes + 2 * q.numel() * 2 + 4 * b
    n = copies_for(kc.numel() * 4)
    qs = [q.clone() for _ in range(n)]
    kcs = [kc.clone() for _ in range(n)]
    vcs = [vc.clone() for _ in range(n)]
    qsd = [x.reshape(b, h, 1, d) for x in qs]
    kct = [x.transpose(1, 2).contiguous() for x in kcs]
    vct = [x.transpose(1, 2).contiguous() for x in vcs]
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[:, None,
                                                                 None, :]
    bnd, by = bound(4 * h * d * rows, io)
    out["decode_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:362",
        max_abs_err=err,
        ms=time_ms([lambda i=i: da.decode_attention(qs[i], kcs[i], vcs[i],
                                                    lens) for i in range(n)]),
        plain_ms=time_ms([lambda i=i: da.decode_attention_plain(
            qs[i], kcs[i], vcs[i], lens) for i in range(n)]),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms([lambda i=i: F.scaled_dot_product_attention(
            qsd[i], kct[i], vct[i], attn_mask=mask, enable_gqa=True)
            for i in range(n)]),
        shape="B=8 S=1024 cache_len in [1, 1024] H=28 K=4 D=128 bf16")

    # -- paged decode: the same K/V scattered over 16-row pages ------------
    bs, m = 16, s // 16
    n_blocks = 1 + b * m
    perm = rng.permutation(np.arange(1, n_blocks))
    tables_np = np.zeros((b, m), np.int32)  # null block 0 past the end
    kp = torch.zeros((n_blocks, bs, kv, d), dtype=torch.bfloat16, device=dev)
    vp = torch.zeros_like(kp)
    for i in range(b):
        used = -(-int(lens_np[i]) // bs)
        tables_np[i, :used] = perm[i * m:i * m + used]
        for t in range(used):
            kp[tables_np[i, t]] = kc[i, t * bs:(t + 1) * bs]
            vp[tables_np[i, t]] = vc[i, t * bs:(t + 1) * bs]
    tables = torch.as_tensor(tables_np, device=dev)
    paged_out = da.paged_decode_attention(q, kp, vp, tables, lens)
    err = close("paged main", paged_out,
                da.paged_decode_attention_plain(q, kp, vp, tables, lens))
    if not torch.equal(paged_out, dense_out):
        raise AssertionError("paged and dense decode kernels differ on "
                             "identical K/V (they share one tile loop)")
    one = torch.ones(b, dtype=torch.int32, device=dev)
    close("paged edge cache_len=1",
          da.paged_decode_attention(q, kp, vp, tables, one),
          da.paged_decode_attention_plain(q, kp, vp, tables, one))
    tbl_entries = int((-(-lens_np // bs)).sum())
    n = copies_for(kp.numel() * 4)
    kps = [kp.clone() for _ in range(n)]
    vps = [vp.clone() for _ in range(n)]
    bnd, by = bound(4 * h * d * int(lens_np.sum()),
                    2 * int(lens_np.sum()) * kv * d * 2
                    + 2 * q.numel() * 2 + 4 * b + 4 * tbl_entries)
    out["paged_decode_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:199",
        max_abs_err=err,
        ms=time_ms([lambda i=i: da.paged_decode_attention(
            qs[i], kps[i], vps[i], tables, lens) for i in range(n)]),
        plain_ms=time_ms([lambda i=i: da.paged_decode_attention_plain(
            qs[i], kps[i], vps[i], tables, lens) for i in range(n)]),
        bound_ms=bnd, bound_by=by, library_ms=None,
        shape="B=8 bs=16 M=64 cache_len in [1, 1024] H=28 K=4 D=128 bf16")
    for name, r in out.items():
        log(f"kernel {name}: max_abs_err={r['max_abs_err']} ms={r['ms']} "
            f"plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
            f"bound_ms={r['bound_ms']} ({r['bound_by']}) [{r['shape']}]")
    return out


# --------------------------------------------------------------------------
# 2. the model through the kernels against the model through plain versions
# --------------------------------------------------------------------------


def reference_phase(rng) -> None:
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="qwen2-7b-heads", family="dense", n_layers=2,
                      d_model=896, n_heads=7, n_kv_heads=1, head_dim=128,
                      d_ff=1024, vocab_size=1024, qkv_bias=True,
                      mlp="swiglu", rope_theta=1e6)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(SEED))  # bf16
    # Give the zero-initialised norms and biases values, so they are
    # checked too.
    for lp in (p_cpu["layers"], p_cpu["layers"]["attn"]):
        for key, leaf in lp.items():
            if isinstance(leaf, torch.Tensor) and leaf.dim() == 2:
                leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator()
                                       .manual_seed(SEED + 1)) * 0.1)
    dev = torch.device("cuda", torch.cuda.current_device())
    p_gpu = _tree(p_cpu, lambda t: t.to(dev))
    p_ref = _tree(p_cpu, lambda t: t.float())  # exact widening
    max_len, n = 64, 37
    prompt = np.zeros((1, max_len), np.int32)
    prompt[0, :n] = rng.integers(0, cfg.vocab_size, n)
    worst = 0.0

    def compare(what, got, ref):
        nonlocal worst
        got = got.float().cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"reference {what}: non-finite logits")
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        worst = max(worst, rel)
        if rel > REF_TOL:
            raise AssertionError(f"reference {what}: rel err {rel} > "
                                 f"{REF_TOL}")

    lg, cg = model.prefill(p_gpu, torch.as_tensor(prompt, device=dev),
                           max_len=max_len, length=n)
    lr, cr = model.prefill(p_ref, torch.as_tensor(prompt), max_len=max_len,
                           length=n)
    compare("prefill", lg, lr)
    # Paged pools from the same prefill entries (4 blocks of 16 rows,
    # scattered), then teacher-forced decode on both planes.
    bs = 16
    row = np.array([3, 1, 4, 2], np.int32)
    write = np.ones(4, bool)
    pg = model.append_paged(model.init_paged_cache(5, bs, dev), cg, row,
                            write)
    pr = model.append_paged(model.init_paged_cache(5, bs), cr, row, write)
    tbl_g = torch.as_tensor(row[None], device=dev)
    tbl_r = torch.as_tensor(row[None])
    tok = model.sample_greedy(lr)
    for step in range(8):
        pos = n + step
        lg, cg = model.decode_step(p_gpu, tok.to(dev), cg)
        lr, cr = model.decode_step(p_ref, tok, cr)
        compare(f"decode step {step}", lg, lr)
        plg, _ = model.decode_step_paged(
            p_gpu, tok.to(dev), pg, tbl_g,
            torch.tensor([pos], dtype=torch.int32, device=dev))
        plr, _ = model.decode_step_paged(
            p_ref, tok, pr, tbl_r, torch.tensor([pos], dtype=torch.int32))
        compare(f"paged decode step {step}", plg, plr)
        tok = model.sample_greedy(lr)
    log(f"reference: 2-layer d=896 H=7 K=1 D=128 model, prefill + 8 dense "
        f"+ 8 paged decode steps on the card within {worst:.4f} "
        f"(max |diff| / max |logit|, limit {REF_TOL}) of f32 on the CPU")


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------------
# 3. full-width serving, continuous then paged
# --------------------------------------------------------------------------


def serve_phase(rng) -> dict[str, int]:
    import torch
    from repro_torch import kernels
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.core.resources import Alloc
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    t0 = time.perf_counter()
    model, params = serve.init_model(ARCH, reduced=False, seed=SEED)
    torch.cuda.synchronize()
    cfg = model.cfg
    wbytes = pytree_nbytes(params)
    log(f"serve: {ARCH} full width ({cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} D={cfg.dh} d_ff={cfg.d_ff} "
        f"V={cfg.vocab_size}), {model.n_params()} params, {wbytes} bytes, "
        f"drawn on the card in {time.perf_counter() - t0:.1f}s")
    lens = rng.integers(64, 513, 16)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    alloc = Alloc(sm=0.5, quota_request=0.5, quota_limit=1.0)
    new_tokens = 32
    totals = {name: 0 for name in kernels.KERNELS}
    streams = {}
    for mode in ("continuous", "paged"):
        engine = ServingEngine(window=0.2, device="cuda")
        engine.deploy(ARCH, model, params, alloc, n_instances=2,
                      max_batch=8, max_len=1024, batching=mode,
                      block_size=16)
        if engine.memory_bytes() != wbytes:
            raise AssertionError(
                f"{mode}: store holds {engine.memory_bytes()} bytes for two "
                f"instances, expected one copy of {wbytes}")
        serve.drive(engine, ARCH, [prompts[0][:64]] * 2, 2)  # warm-up
        before = {k: dict(v) for k, v in engine.telemetry().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        reqs, done, wall = serve.drive(engine, ARCH, prompts, new_tokens)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        if done != len(prompts) or not all(
                r.done and len(r.tokens_out) == new_tokens for r in reqs):
            raise AssertionError(f"{mode}: served {done}/{len(prompts)}")
        passes = {k: v["steps"] - before[k]["steps"]
                  for k, v in engine.telemetry().items()}
        syncs = {k: v["syncs"] - before[k]["syncs"]
                 for k, v in engine.telemetry().items()}
        if passes != syncs:
            raise AssertionError(f"{mode}: syncs {syncs} != passes {passes}")
        used = "decode_attention" if mode == "continuous" \
            else "paged_decode_attention"
        idle = "paged_decode_attention" if mode == "continuous" \
            else "decode_attention"
        if counts["flash_attention"] == 0 or counts[used] == 0 \
                or counts[idle] != 0:
            raise AssertionError(f"{mode}: kernel launches {counts}")
        for r in reqs:
            tok = np.asarray(r.tokens_out)
            if tok.min() < 0 or tok.max() >= cfg.vocab_size:
                raise AssertionError(f"{mode}: token out of vocab")
        lat = np.array([r.finished_at - r.submitted_at for r in reqs])
        n_tok = sum(len(r.tokens_out) for r in reqs)
        log(f"serve {mode}: {done} requests, {n_tok} tokens in {wall:.3f}s "
            f"= {n_tok / wall:.1f} tokens/s; latency p50={np.percentile(lat, 50):.3f}s "
            f"p99={np.percentile(lat, 99):.3f}s; passes {passes}; syncs "
            f"{syncs} (1 per pass); launches {counts}; peak device memory "
            f"{torch.cuda.max_memory_allocated()} bytes; weights stored "
            f"once: {engine.memory_bytes()} bytes for 2 instances")
        for k in totals:
            totals[k] += counts[k]
        streams[mode] = [list(r.tokens_out) for r in reqs]
    if streams["continuous"] != streams["paged"]:
        raise AssertionError("continuous and paged greedy streams differ")
    log("serve: continuous and paged emit identical greedy streams")
    profile_window(model, params, prompts[:8], alloc)
    return totals


def profile_window(model, params, prompts, alloc) -> None:
    """Where a paged serve pass spends its time: device time by kernel
    and the device's busy share of the wall time, from ``torch.profiler``
    over 8 requests x 8 tokens on one instance (after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(window=0.2, device="cuda")
    engine.deploy(ARCH, model, params, alloc, n_instances=1, max_batch=8,
                  max_len=1024, batching="paged", block_size=16)
    serve.drive(engine, ARCH, prompts[:2], 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = serve.drive(engine, ARCH, prompts, 8)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    # Device-side (kernel) events only: the CPU-side op events carry the
    # same device time again as their children's.
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    if not rows:
        log("profile: the profiler recorded no device time (not measured)")
        return
    busy_us = sum(t for t, _, _ in rows)
    groups = {"port attention kernels": 0.0, "cuBLAS matmuls": 0.0,
              "other torch kernels": 0.0}
    for t, _, key in rows:
        if any(k in key for k in ("flash_kernel", "decode_kernel",
                                  "combine_kernel")):
            groups["port attention kernels"] += t
        elif any(k in key for k in ("nvjet", "gemm", "cutlass", "xmma")):
            groups["cuBLAS matmuls"] += t
        else:
            groups["other torch kernels"] += t
    log(f"profile: 8 requests x 8 tokens, paged, 1 instance: wall "
        f"{wall * 1e3:.1f} ms (profiler on), device busy "
        f"{busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.3f} of wall, "
        f"{sum(n for _, n, _ in rows)} kernel launches")
    for name, t in groups.items():
        log(f"profile: {t / 1e3:9.3f} ms  {name}")
    for t, n, key in sorted(rows, reverse=True)[:10]:
        log(f"profile: {t / 1e3:9.3f} ms  {n:6d} calls  {key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("[chip_smoke] FAIL: src/repro_torch not found beside this "
              "script", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s: {lib}")
    for line in (lib.parent / "ptxas.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            log(f"ptxas {line.strip()}")
    rng = np.random.default_rng(SEED)
    results = kernel_phase(rng)
    reference_phase(rng)
    launches = serve_phase(rng)
    listing = [dict(name=name, launches=launches[name],
                    **{k: v for k, v in r.items() if k != "shape"})
               for name, r in results.items()]
    print(json.dumps({"kernels": listing}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
