#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, logs each
kernel's registers and spills from the ptxas report and, by the
toolkit's ``cuobjdump`` (the smoke fails without it), the tensor-core
instructions (HMMA) in each kernel's SASS, failing if flash or any decode kernel, at any head dim
they are built for (16, 32, 64, 128), chunked WKV-6 or the chunked
selective scan (N = 16 and 8) holds none or spills, or if the scan's
step kernel spills or moves its state otherwise than by one coherent
16-byte load and one 16-byte store a thread (it updates the state in
place), and then:

1. kernel phase — holds each kernel (flash, bf16 and int8 dense and paged
   decode, the chunked and step WKV-6 kernels, the chunked and step
   selective-scan kernels) against
   its plain PyTorch version on the card (bf16, tolerance 2e-2 as
   ``tests/test_kernels.py``) at the main path's shapes and at edge
   shapes, and times kernel, plain version, one PyTorch library call where
   one computes the same function, and the card's bound for the same work
   (flash also at a short serve bucket, Sq=64, and at hymba's prefill,
   beside SDPA; bf16 paged decode at pages of 8, 16 and 32 rows and int8
   at 8, 16, 32 and 64, bit-equal to dense; all four decode kernels also
   at starcoder2-15b's 12 query heads per kv head; flash and the four
   decode kernels at head dims 16 and 32, timed; an int8 code view off a
   16-byte boundary refused; chunked WKV-6 at a 512-token prefill and
   the chunked scan at hymba's 640-row prefill, each at its edge cases,
   step WKV-6 and the step scan at a decode round's shape, B=8 and S=1,
   the step scan in place; both scan kernels in place == out of place,
   bit for bit);
2. reference phase — a 2-layer model with qwen2-7b's head geometry
   (head dim 128, 7 query heads per kv head) runs prefill, dense decode
   and paged decode from bf16 and from int8 caches, a 2-layer RWKV-6
   model (head size 64; its 37-token prefill through chunked WKV-6) and
   a 2-layer hybrid with hymba-1.5b's head geometry (d=1600, 25 query and
   5 kv heads of 64, N=16; its 77-row prefill through the chunked scan)
   run prefill and decode, on the card through
   the kernels, against the same weights in f32 on the CPU through the
   plain versions; then ``serve.main --reduced`` serves qwen2-7b's and
   hymba-1.5b's reduced configs (head dim 16) on the card;
3. serve phase — full-width qwen2-7b (28 layers, d=3584; random bf16
   weights from a seed) on one ``ServingEngine``, two instances sharing
   one weight copy, continuous then paged (block size 16), with bf16 and
   then with int8 KV, 16 requests of 64-512 prompt tokens and 32 new
   tokens each; then full-width rwkv6-1.6b (24 layers, d=2048) and
   full-width hymba-1.5b (32 layers, d=1600, 128 meta tokens, window
   1024) continuous with the same mix.  Each instance's fused decode
   round is a CUDA graph (``serving/graphs.py``), and so is each of its
   qwen2-7b admissions, one graph per prompt bucket (64, 128, 256, 512);
   all are captured in a warm-up before the run (two admissions of every
   bucket per instance) and replayed in every round and every qwen2-7b
   admission of it, never captured again (rwkv6 and hymba prefill
   eagerly, at the exact length); a ``fused=False`` engine (the
   host-argmax reference, eager) must give the same greedy streams on the
   same prompts, one qwen2-7b paged decode step replayed over a copy of
   the pools must equal the eager ``decode_step_paged`` bit for bit
   (logits, pools), as must the instance's own replayed round (tokens,
   positions, pools), and in each qwen2-7b mode a replayed admission must
   equal the eager admission body bit for bit (logits, pools, slot and
   pending tokens).  Launch counts are set to 0 just before each mode and
   read just after it.  Each model's profile window logs its wall, device
   busy share, kernels and the host's launch calls per decode round and
   per prefill;
4. sharing, migration and release phase — qwen2-7b at full width, paged
   with prefix sharing (the default) from bf16 and then int8 KV, two
   instances, 16 requests each of one 256-token system prompt and a
   unique suffix of 16-240 tokens (two pairs of exact duplicates an
   instance), 32 new tokens each: the sharing hits and copy-on-write
   copies equal a host replay of the admission plan, every timed round
   and prefill is a replay, ``kv_bytes_saved() > 0`` mid-run, the streams
   equal an unshared paged and a continuous engine's, and the allocator's
   high watermark is below the unshared run's; the profiler counts the
   host launches of a COW pass (one copy a pool leaf) and of the passes
   after it (none); slots exported after two passes from one
   single-instance engine (paged with sharing, then continuous) and
   imported into another whose graphs are captured give the unmigrated
   streams, with every later round of the target a replay; and after
   ``retire`` drains an instance, and after ``fail``, the reserved device
   memory falls by at least that instance's KV pool;
5. fleet phase — qwen2-7b at full width above the engine: a bare engine
   measures an instance's pools beyond its KV charge (the
   ``framework_bytes`` admission then charges) and gives each prompt's
   reference stream; the FaST-Profiler's table over sm {0.25, 0.5} x
   quota {0.4, 0.8} on a live paged instance; then a ``FunctionSpec``
   from it reconciled by ``ControlPlane(LiveBackend(ClusterFrontend))``
   over two nodes on the card with a ``FleetModelStore`` (pinned
   staging, overlapped uploads), scaling 1 -> 3 -> 1 with node 1 failed
   and the function re-placed; no request may drop, every first token
   must equal the bare engine's, and the decision sequence must equal
   the port's simulator replay of the same spec.  It logs the cold-start
   tiers with their upload calls and TTFTs, fleet tokens/s, each
   instance's admission charge beside the reserved bytes of its pools,
   and the reserved bytes returned at scale-down and at the failure.

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero, and so does a machine without a card.

Usage:  python3 chip_smoke.py
        python3 chip_smoke.py --windows CHECKOUT   (see ``windows_phase``)
"""

from __future__ import annotations

import bisect
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
RWKV_ARCH = "rwkv6-1.6b"
HYBRID_ARCH = "hymba-1.5b"


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


def device_ms(calls, iters: int = 30, label: str = "") -> float:
    """Mean device time per call of the kernels ``calls`` launch, from
    ``torch.profiler``'s kernel records: unlike ``time_ms`` it leaves out
    the host's dispatch, which bounds ``time_ms`` when a call's kernels
    finish before Python dispatches the next call.  With a ``label``,
    logs the time per call of each CUDA kernel the calls launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3 / iters, e.key)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    if label:
        log(f"device ms per call of {label} by kernel: " + "; ".join(
            f"{_port_name(key) or key[:50]} {t:.5f}" for t, key in rows))
    return sum(t for t, _ in rows)


def kernel_times(calls, plain, library=None, plain_iters: int = 30,
                 label: str = "") -> dict:
    """The kernel's and the library call's times by CUDA events and by
    device time (split by CUDA kernel in the log where ``label`` names
    the calls), and the plain version's by CUDA events."""
    return dict(ms=time_ms(calls), device_ms=device_ms(calls, label=label),
                plain_ms=time_ms(plain, iters=plain_iters),
                library_ms=library and time_ms(library),
                library_device_ms=library and device_ms(
                    library, label=label and f"{label} (library)"))


def _port_name(key: str) -> str:
    """``flash_kernel<128>`` from a profiler key of one of the port's
    kernels (``KERNEL_NAMES``, in anonymous namespaces); "" for any other
    kernel."""
    tag = "(anonymous namespace)::"
    if tag not in key:
        return ""
    name = key.split(tag, 1)[1].split("(")[0]
    return name if name.split("<")[0] in KERNEL_NAMES else ""


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

    def rand(*shape, gen=rng):
        x = gen.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(dev).to(torch.bfloat16)

    # Shapes beyond the first set draw from their own generator, so the
    # serve phase's prompts (drawn from ``rng`` after this phase) do not
    # move when a check is added here.
    extra = np.random.default_rng(SEED + 6)

    def rand_extra(*shape):
        return rand(*shape, gen=extra)

    out = {}
    # -- flash attention (prefill): main shape B=1, Sq=Sk=512, causal ------
    b, s, h, kv, d = 1, 512, 28, 4, 128
    q, k, v = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    err = close("flash main", fa.flash_attention(q, k, v, causal=True),
                fa.flash_attention_plain(q, k, v, causal=True))
    edges = [(2, 37, 37, True, None, 0, 128),   # Sq not a tile multiple
             (1, 1, 1, True, None, 0, 128),     # bucket of one token
             (1, 100, 100, True, 33, 0, 128),   # sliding window
             (1, 20, 84, True, None, 64, 128),  # q_offset (chunk at tail)
             (2, 40, 70, False, None, 0, 128),  # non-causal, ragged Sk
             (1, 65, 65, True, None, 0, 64)]    # head dim 64
    more_edges = [(1, 23, 45, False, None, 0, 128),  # Sk not a multiple
                  (1, 37, 77, True, None, 40, 128)]  # of 16; q_offset too
    for case, draw in ([(c, rand) for c in edges]
                       + [(c, rand_extra) for c in more_edges]):
        eb, sq, sk, causal, window, q_off, ed = case
        eq, ek, ev = draw(eb, sq, h, ed), draw(eb, sk, kv, ed), \
            draw(eb, sk, kv, ed)
        close(f"flash edge {case}",
              fa.flash_attention(eq, ek, ev, causal=causal, window=window,
                                 q_offset=q_off),
              fa.flash_attention_plain(eq, ek, ev, causal=causal,
                                       window=window, q_offset=q_off))
    for sq in (2, 16, 128, 256):  # more serve buckets, at both head dims
        for ed, eh, ekv in ((128, h, kv), (64, 25, 5)):
            eq, ek, ev = rand_extra(1, sq, eh, ed), \
                rand_extra(1, sq, ekv, ed), rand_extra(1, sq, ekv, ed)
            close(f"flash bucket Sq=Sk={sq} D={ed}",
                  fa.flash_attention(eq, ek, ev),
                  fa.flash_attention_plain(eq, ek, ev))
    flash_logged("a short serve bucket", rand_extra(b, 64, h, d),
                 rand_extra(b, 64, kv, d), rand_extra(b, 64, kv, d))
    flash_hymba(rand, rand_extra)
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
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        shape="B=1 Sq=Sk=512 H=28 K=4 D=128 causal bf16",
        **kernel_times(
            [lambda i=i: fa.flash_attention(qs[i], ks[i], vs[i])
             for i in range(n)],
            [lambda i=i: fa.flash_attention_plain(qs[i], ks[i], vs[i])
             for i in range(n)],
            [lambda i=i: F.scaled_dot_product_attention(
                qt[i], kt[i], vt[i], is_causal=True, enable_gqa=True)
             for i in range(n)], plain_iters=6))

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
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        shape="B=8 S=1024 cache_len in [1, 1024] H=28 K=4 D=128 bf16",
        **kernel_times(
            [lambda i=i: da.decode_attention(qs[i], kcs[i], vcs[i], lens)
             for i in range(n)],
            [lambda i=i: da.decode_attention_plain(qs[i], kcs[i], vcs[i],
                                                   lens) for i in range(n)],
            [lambda i=i: F.scaled_dot_product_attention(
                qsd[i], kct[i], vct[i], attn_mask=mask, enable_gqa=True)
             for i in range(n)], label="bf16 dense decode"))

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
    for page in (8, 32):  # pages below and above one 16-row tile
        pools, order = scatter_pages((kc, vc), page, extra)
        if not torch.equal(da.paged_decode_attention(q, *pools, order, lens),
                           dense_out):
            raise AssertionError(f"paged decode with {page}-row pages "
                                 f"differs from dense on identical K/V")
    log("decode: paged (pages of 8, 16, 32 rows) == dense, bit for bit")
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
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        shape="B=8 bs=16 M=64 cache_len in [1, 1024] H=28 K=4 D=128 bf16",
        **kernel_times(
            [lambda i=i: da.paged_decode_attention(qs[i], kps[i], vps[i],
                                                   tables, lens)
             for i in range(n)],
            [lambda i=i: da.paged_decode_attention_plain(
                qs[i], kps[i], vps[i], tables, lens) for i in range(n)],
            label="bf16 paged decode"))
    out.update(int8_kernels(q, kc, vc, lens_np, tables_np))
    wide_group_kernels(dev)
    small_head_dims(dev)
    out.update(wkv6_kernel(np.random.default_rng(SEED + 3), dev))
    out.update(ssm_kernel(np.random.default_rng(SEED + 4), dev))
    for name, r in out.items():
        log(f"kernel {name}: max_abs_err={r['max_abs_err']} ms={r['ms']} "
            f"device_ms={r['device_ms']} plain_ms={r['plain_ms']} "
            f"library_ms={r['library_ms']} library_device_ms="
            f"{r['library_device_ms']} bound_ms={r['bound_ms']} "
            f"({r['bound_by']}) [{r['shape']}]")
    return out


def scatter_pages(xs, page, rng):
    """Dense (B, S, ...) leaves ``xs`` scattered over a pool of ``page``-row
    pages in a random order: (pools, (B, S / page) int32 tables)."""
    import torch
    b, s = xs[0].shape[:2]
    m = s // page
    order = torch.as_tensor(rng.permutation(b * m).astype(np.int32),
                            device=xs[0].device)
    pools = []
    for x in xs:
        pool = torch.empty((b * m, page, *x.shape[2:]), dtype=x.dtype,
                           device=x.device)
        pool[order.long()] = x.reshape(b * m, page, *x.shape[2:])
        pools.append(pool)
    return pools, order.reshape(b, m)


def int8_kernels(q, kc, vc, lens_np, tables_np) -> dict:
    """The int8 dense and paged decode kernels on the codes and scales of
    the bf16 decode phase's K/V (quantized on the card), at its shapes;
    paged at pages of 8, 32 and 64 rows too, bit-equal to dense; a code
    view off a 16-byte boundary refused."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.attention import kv_quantize

    dev = q.device
    b, s, kv, d = kc.shape
    h = q.shape[2]
    (k8, ks), (v8, vs) = kv_quantize(kc), kv_quantize(vc)
    lens = torch.as_tensor(lens_np, device=dev)
    dense_out = da.decode_attention_quant(q, k8, v8, ks, vs, lens)
    out = {}
    err = close("int8 decode main", dense_out,
                da.decode_attention_quant_plain(q, k8, v8, ks, vs, lens))
    for name, el in [("cache_len=1", np.ones(b)), ("cache_len=S",
                                                   np.full(b, s)),
                     ("cache_len>S (free slot)", lens_np + s)]:
        elt = torch.as_tensor(np.asarray(el, np.int32), device=dev)
        close(f"int8 decode edge {name}",
              da.decode_attention_quant(q, k8, v8, ks, vs, elt),
              da.decode_attention_quant_plain(q, k8, v8, ks, vs, elt))
    rows = int(np.minimum(lens_np, s).sum())
    qo_bytes = 2 * q.numel() * 2
    n = copies_for(k8.numel() * 2)
    leaves = [[x.clone() for x in (q, k8, v8, ks, vs)] for _ in range(n)]
    bnd, by = bound(4 * h * d * rows,
                    2 * rows * kv * d + 2 * rows * kv * 2 + qo_bytes + 4 * b)
    out["decode_attention_quant"] = dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:311",
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        shape="B=8 S=1024 cache_len in [1, 1024] H=28 K=4 D=128 int8 codes "
              "+ bf16 scales",
        **kernel_times(
            [lambda x=x: da.decode_attention_quant(*x, lens) for x in leaves],
            [lambda x=x: da.decode_attention_quant_plain(*x, lens)
             for x in leaves], label="int8 dense decode"))

    # -- the same codes and scales scattered over the bf16 phase's pages --
    bs, m = 16, tables_np.shape[1]
    pages = [torch.zeros((1 + b * m, bs, kv, x.shape[-1]), dtype=x.dtype,
                         device=dev) for x in (k8, v8, ks, vs)]
    for i in range(b):
        for t in range(-(-int(lens_np[i]) // bs)):
            for page, x in zip(pages, (k8, v8, ks, vs)):
                page[tables_np[i, t]] = x[i, t * bs:(t + 1) * bs]
    tables = torch.as_tensor(tables_np, device=dev)
    paged_out = da.paged_decode_attention_quant(q, *pages, tables, lens)
    err = close("int8 paged main", paged_out,
                da.paged_decode_attention_quant_plain(q, *pages, tables,
                                                      lens))
    if not torch.equal(paged_out, dense_out):
        raise AssertionError("int8 paged and dense decode kernels differ on "
                             "identical codes (they share one tile loop)")
    one = torch.ones(b, dtype=torch.int32, device=dev)
    close("int8 paged edge cache_len=1",
          da.paged_decode_attention_quant(q, *pages, tables, one),
          da.paged_decode_attention_quant_plain(q, *pages, tables, one))
    dirty = [p.clone() for p in pages]
    for p in dirty:
        p[0] = 77  # the null block, named past every table's end
    if not torch.equal(da.paged_decode_attention_quant(q, *dirty, tables,
                                                       lens), paged_out):
        raise AssertionError("int8 paged decode read the null block")
    page_rng = np.random.default_rng(SEED + 7)
    for page in (8, 32, 64):
        pools, order = scatter_pages((k8, v8, ks, vs), page, page_rng)
        if not torch.equal(da.paged_decode_attention_quant(
                q, *pools, order, lens), dense_out):
            raise AssertionError(f"int8 paged decode with {page}-row pages "
                                 f"differs from dense on identical codes")
    log("int8 decode: paged (pages of 8, 16, 32, 64 rows) == dense, bit "
        "for bit")
    flat = torch.zeros(max(k8.numel(), pages[0].numel()) + 16,
                       dtype=torch.int8, device=dev)
    shifted = flat[1:1 + k8.numel()].view(k8.shape)
    shifted_pages = flat[1:1 + pages[0].numel()].view(pages[0].shape)
    for name, call in [
            ("dense", lambda: da.decode_attention_quant(q, shifted, v8, ks,
                                                        vs, lens)),
            ("paged", lambda: da.paged_decode_attention_quant(
                q, shifted_pages, *pages[1:], tables, lens))]:
        try:
            call()
        except ValueError as e:
            log(f"int8 {name} decode refuses a code view at a 1-byte "
                f"offset: {e}")
        else:
            raise AssertionError(f"int8 {name} decode took a code view at "
                                 f"a 1-byte offset")
    tbl_entries = int((-(-lens_np // bs)).sum())
    n = copies_for(pages[0].numel() * 2)
    page_sets = [[p.clone() for p in pages] for _ in range(n)]
    bnd, by = bound(4 * h * d * rows,
                    2 * rows * kv * d + 2 * rows * kv * 2 + qo_bytes + 4 * b
                    + 4 * tbl_entries)
    out["paged_decode_attention_quant"] = dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:256",
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        shape="B=8 bs=16 M=64 cache_len in [1, 1024] H=28 K=4 D=128 int8 "
              "codes + bf16 scales",
        **kernel_times(
            [lambda x=x: da.paged_decode_attention_quant(q, *x, tables, lens)
             for x in page_sets],
            [lambda x=x: da.paged_decode_attention_quant_plain(
                q, *x, tables, lens) for x in page_sets],
            label="int8 paged decode"))
    return out


def wide_group_kernels(dev) -> None:
    """All four decode kernels at starcoder2-15b's attention geometry (48
    query heads over 4 kv heads of 128: G = 12), B=8, S=1024, mixed
    cache_len, against their plain versions; each paged kernel (pages of
    16 rows) bit-equal to its dense one."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.attention import kv_quantize

    rng = np.random.default_rng(SEED + 8)
    b, s, h, kv, d = 8, 1024, 48, 4, 128

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)

    q, kc, vc = rand(b, 1, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    lens = torch.tensor([1024, 1, 517, 64, 1000, 333, 768, 129],
                        dtype=torch.int32, device=dev)
    k8, ks, v8, vs = kv_quantize(kc) + kv_quantize(vc)
    (kp, vp), tables = scatter_pages((kc, vc), 16, rng)
    pools, tables8 = scatter_pages((k8, v8, ks, vs), 16, rng)
    errs = {}
    for name, dense, paged in [
            ("bf16", (da.decode_attention, da.decode_attention_plain,
                      (q, kc, vc, lens)),
             (da.paged_decode_attention, da.paged_decode_attention_plain,
              (q, kp, vp, tables, lens))),
            ("int8", (da.decode_attention_quant,
                      da.decode_attention_quant_plain,
                      (q, k8, v8, ks, vs, lens)),
             (da.paged_decode_attention_quant,
              da.paged_decode_attention_quant_plain,
              (q, *pools, tables8, lens)))]:
        outs = []
        for label, (kernel, plain, args) in (("dense", dense),
                                             ("paged", paged)):
            outs.append(kernel(*args))
            errs[f"{name} {label}"] = close(f"{name} {label} decode G=12",
                                            outs[-1], plain(*args))
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"{name} paged and dense decode differ at "
                                 f"G=12 on identical K/V")
    log(f"decode at G=12 (B=8 S=1024 H=48 K=4 D=128): max_abs_err {errs}; "
        f"paged == dense, bit for bit, in bf16 and int8")


def wkv6_kernel(rng, dev) -> dict:
    """The two WKV-6 kernels (rwkv6-1.6b: 32 heads of 64): the chunked one
    at a batch-1 prefill of 512 tokens from a zero state, the step one at
    a decode round (B=8, S=1), each timed; and edge cases through the
    scan: S not a multiple of a chunk, nonzero states, the threshold's
    S - 1, S and S + 1, strong decay (-exp(N + 2): a chunk's decay reaches
    hundreds) and weak decay (-1e-3), S = 2048 from a nonzero state, and
    a scan split at step 777 equal to the whole."""
    import torch
    from repro_torch.kernels import wkv6

    def inputs(b, s, h, state_scale, decay="mild"):
        def rand(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev)
        r, k, v = (rand(b, s, h, 64).to(torch.bfloat16) for _ in range(3))
        n = rand(b, s, h, 64)
        w = {"mild": -torch.exp(n * 0.3) - 0.01, "strong": -torch.exp(n + 2),
             "weak": torch.full_like(n, -1e-3)}[decay].to(torch.bfloat16)
        return r, k, v, w, rand(h, 64).to(torch.bfloat16), \
            rand(b, h, 64, 64) * state_scale

    def check(name, x, kernel=None):
        before = (wkv6.wkv6_step.launches, wkv6.wkv6_chunked.launches)
        o, st = wkv6.wkv6_scan(*x)
        took = "chunked" if wkv6.wkv6_chunked.launches > before[1] else \
            "step"
        want = "chunked" if x[0].shape[1] >= wkv6.CHUNKED_MIN_S else "step"
        if took != want or (kernel and kernel != took):
            raise AssertionError(f"{name}: ran the {took} kernel")
        po, pst = wkv6.wkv6_scan_plain(*x)
        if not (torch.isfinite(o.float()).all() and torch.isfinite(st).all()):
            raise AssertionError(f"{name}: non-finite output")
        close(f"{name} state", st, pst)
        return close(name, o, po)

    def cost(b, s, h):
        """(operations, bytes): r, k, v, w read and out written (bf16), u
        read, the state read and written (f32); 5 D^2 operations a step
        and head, as the recurrence is written."""
        seq = b * s * h * 64
        return 5 * seq * 64, 5 * seq * 2 + 2 * b * h * 64 * 64 * 4 + h * 128

    b, s, h = 1, 512, 32
    main = inputs(b, s, h, 0.0)
    err = check("wkv6 main (prefill)", main, "chunked")
    decode = inputs(8, 1, h, 1.0)
    decode_err = check("wkv6 decode step (B=8 S=1)", decode, "step")
    t = wkv6.CHUNKED_MIN_S
    for shape in [(2, 77, 4, 1.0), (1, 33, 2, 3.0), (1, t - 1, h, 1.0),
                  (1, t, h, 1.0), (1, t + 1, h, 1.0),
                  (1, 512, h, 1.0, "strong"), (1, 512, h, 1.0, "weak"),
                  (1, 2048, h, 1.0)]:
        check(f"wkv6 edge (B, S, H, state scale, decay)={shape}",
              inputs(*shape))
    r, k, v, w, u, st0 = inputs(1, 2048, h, 1.0)
    whole, st_whole = wkv6.wkv6_scan(r, k, v, w, u, st0)
    head, st_mid = wkv6.wkv6_scan(r[:, :777], k[:, :777], v[:, :777],
                                  w[:, :777], u, st0)
    tail, st_end = wkv6.wkv6_scan(*(x[:, 777:].contiguous()
                                    for x in (r, k, v, w)), u, st_mid)
    close("wkv6 split at 777 == whole", torch.cat([head, tail], 1), whole)
    close("wkv6 split at 777 == whole, state", st_end, st_whole)
    log(f"wkv6: the step kernel below S={t}, the chunked kernel from S={t}; "
        f"edge cases (threshold, strong and weak decay, S=2048, split == "
        f"whole) within {TOL} of the plain scan")
    flops, io = cost(b, s, h)
    n = copies_for(io)
    sets = [[x.clone() for x in main] for _ in range(n)]
    bnd, by = bound(flops, io)
    dflops, dio = cost(8, 1, h)
    dsets = [[x.clone() for x in decode] for _ in range(copies_for(dio))]
    dbnd, dby = bound(dflops, dio)
    step_at_prefill = device_ms([lambda x=x: wkv6.wkv6_step(*x)
                                 for x in sets])
    log(f"wkv6: the step kernel at the prefill shape (B=1 S=512 H=32), for "
        f"comparison: device_ms={step_at_prefill}")
    return {
        "wkv6_chunked": dict(
            route="cuda", source="src/repro_torch/csrc/wkv6.cu",
            replaces="src/repro/kernels/wkv6.py:64", max_abs_err=err,
            bound_ms=bnd, bound_by=by,
            shape="B=1 S=512 H=32 D=64 bf16, f32 state (prefill)",
            **kernel_times([lambda x=x: wkv6.wkv6_scan(*x) for x in sets],
                           [lambda x=x: wkv6.wkv6_scan_plain(*x)
                            for x in sets], plain_iters=3,
                           label="wkv6 chunked")),
        "wkv6_step": dict(
            route="cuda", source="src/repro_torch/csrc/wkv6.cu",
            replaces="src/repro/kernels/wkv6.py:64",
            max_abs_err=decode_err, bound_ms=dbnd, bound_by=dby,
            shape="B=8 S=1 H=32 D=64 bf16, f32 state (a decode round)",
            **kernel_times([lambda x=x: wkv6.wkv6_scan(*x) for x in dsets],
                           [lambda x=x: wkv6.wkv6_scan_plain(*x)
                            for x in dsets], label="wkv6 step"))}


def small_head_dims(dev) -> None:
    """Flash and the four decode kernels at head dims 16 (the reduced
    configs') and 32, at qwen2-7b's heads (28 q / 4 kv), against their
    plain versions: flash causal at B=1 Sq=Sk=512 (timed beside SDPA and
    its bound), windowed (window 8, the reduced hymba's) and ragged; the
    four decode kernels at B=8 S=1024 with mixed cache_len (timed), each
    paged kernel bit-equal to its dense one at pages of 8 and 16 rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import kv_quantize

    rng = np.random.default_rng(SEED + 9)
    h, kv = 28, 4

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)

    lens_np = np.array([1024, 1, 517, 64, 1000, 333, 768, 129], np.int32)
    lens = torch.as_tensor(lens_np, device=dev)
    rows = int(lens_np.sum())
    for d in (16, 32):
        q, k, v = rand(1, 512, h, d), rand(1, 512, kv, d), rand(1, 512, kv, d)
        err = close(f"flash D={d}", fa.flash_attention(q, k, v),
                    fa.flash_attention_plain(q, k, v))
        for sq, sk, causal, window, off in [(100, 100, True, 8, 0),
                                            (37, 77, True, None, 40),
                                            (40, 70, False, None, 0)]:
            eq, ek, ev = rand(2, sq, h, d), rand(2, sk, kv, d), \
                rand(2, sk, kv, d)
            close(f"flash D={d} ({sq}, {sk}, {causal}, {window}, {off})",
                  fa.flash_attention(eq, ek, ev, causal=causal,
                                     window=window, q_offset=off),
                  fa.flash_attention_plain(eq, ek, ev, causal=causal,
                                           window=window, q_offset=off))
        io = 2 * (q.numel() * 2 + k.numel() + v.numel())
        sets = [[x.clone() for x in (q, k, v)] for _ in range(copies_for(io))]
        tsets = [[x.transpose(1, 2).contiguous() for x in xs] for xs in sets]
        bnd, by = bound(4 * h * d * (512 * 513 // 2), io)
        kernel_ms = device_ms([lambda x=x: fa.flash_attention(*x)
                               for x in sets])
        sdpa_ms = device_ms([lambda x=x: F.scaled_dot_product_attention(
            *x, is_causal=True, enable_gqa=True) for x in tsets])
        log(f"kernel flash_attention at D={d} (B=1 Sq=Sk=512 H=28 K=4, "
            f"causal): max_abs_err={err} device_ms={kernel_ms} "
            f"library_device_ms={sdpa_ms} (SDPA) bound_ms={bnd} ({by})")

        q = rand(8, 1, h, d)
        kc, vc = rand(8, 1024, kv, d), rand(8, 1024, kv, d)
        k8, ks, v8, vs = kv_quantize(kc) + kv_quantize(vc)
        times = {}
        for page in (16, 8):
            (kp, vp), tables = scatter_pages((kc, vc), page, rng)
            pools, tables8 = scatter_pages((k8, v8, ks, vs), page, rng)
            cases = {
                "decode_attention": (da.decode_attention,
                                     da.decode_attention_plain,
                                     (q, kc, vc, lens)),
                "paged_decode_attention": (
                    da.paged_decode_attention,
                    da.paged_decode_attention_plain,
                    (q, kp, vp, tables, lens)),
                "decode_attention_quant": (
                    da.decode_attention_quant,
                    da.decode_attention_quant_plain,
                    (q, k8, v8, ks, vs, lens)),
                "paged_decode_attention_quant": (
                    da.paged_decode_attention_quant,
                    da.paged_decode_attention_quant_plain,
                    (q, *pools, tables8, lens))}
            outs = {}
            for name, (kernel, plain, args) in cases.items():
                outs[name] = kernel(*args)
                close(f"{name} D={d} pages of {page}", outs[name],
                      plain(*args))
                if page == 16:
                    times[name] = device_ms([lambda a=args, f=kernel: f(*a)
                                             for _ in range(2)])
            for dense, paged in [("decode_attention",
                                  "paged_decode_attention"),
                                 ("decode_attention_quant",
                                  "paged_decode_attention_quant")]:
                if not torch.equal(outs[dense], outs[paged]):
                    raise AssertionError(f"{paged} differs from {dense} at "
                                         f"D={d}, pages of {page}")
        bf16_b = bound(4 * h * d * rows, 2 * rows * kv * d * 2)
        int8_b = bound(4 * h * d * rows, 2 * rows * kv * (d + 2))
        log(f"decode at D={d} (B=8 S=1024 H=28 K=4, mixed cache_len): "
            f"device_ms {times}; bound_ms bf16 {bf16_b[0]} int8 {int8_b[0]} "
            f"(bytes); paged == dense, bit for bit, at pages of 8 and 16, "
            f"bf16 and int8")


def reduced_serve() -> None:
    """``python -m repro_torch.launch.serve --reduced`` on the card:
    qwen2-7b's and hymba-1.5b's reduced configs (head dim 16; hymba's SSM
    state 8, its 20-row prefills through the chunked scan) through
    ``serve.main``, with their launch counts."""
    import contextlib
    import io
    import re
    from repro_torch import kernels
    from repro_torch.launch import serve

    kernels.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--reduced", "--arch", "qwen2-7b", "--arch",
                    "hymba-1.5b", "--requests", "8", "--max-new-tokens", "8"])
    counts = kernels.launch_counts()
    text = buf.getvalue()
    m = re.search(r"completed (\d+)/(\d+) requests", text)
    if not m or m.group(1) != m.group(2) or m.group(2) != "8":
        raise AssertionError(f"reduced serve: {text[-2000:]}")
    if any(counts[k] == 0 for k in ("flash_attention", "decode_attention",
                                    "ssm_chunked", "ssm_step")):
        raise AssertionError(f"reduced serve: kernel launches {counts}")
    log(f"reduced serve (serve.main --reduced, qwen2-7b and hymba-1.5b, "
        f"head dim 16) on the card: {m.group(0)}; launches {counts}")


def flash_logged(label, q, k, v, window=None) -> None:
    """The flash kernel at one more prefill shape, held against its plain
    version and timed (logged; the JSON line keeps qwen2-7b's main shape)
    beside SDPA (causal, window not applied: at the shapes timed here
    every causal pair lies inside the window)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    b, sq, h, d = q.shape
    kv = k.shape[2]
    err = close(f"flash {label}",
                fa.flash_attention(q, k, v, causal=True, window=window),
                fa.flash_attention_plain(q, k, v, causal=True,
                                         window=window))
    io = 2 * (q.numel() * 2 + k.numel() + v.numel())
    n = copies_for(io)
    sets = [[x.clone() for x in (q, k, v)] for _ in range(n)]
    tsets = [[x.transpose(1, 2).contiguous() for x in xs] for xs in sets]
    bnd, by = bound(4 * b * h * d * (sq * (sq + 1) // 2), io)
    calls = [lambda x=x: fa.flash_attention(*x, causal=True, window=window)
             for x in sets]
    sdpa = [lambda x=x: F.scaled_dot_product_attention(
        *x, is_causal=True, enable_gqa=True) for x in tsets]
    log(f"kernel flash_attention at {label} (B={b} Sq=Sk={sq} H={h} K={kv} "
        f"D={d} window {window}): max_abs_err={err} ms={time_ms(calls)} "
        f"device_ms={device_ms(calls)} library_ms={time_ms(sdpa)} "
        f"library_device_ms={device_ms(sdpa)} (SDPA, causal) "
        f"bound_ms={bnd} ({by})")


def flash_hymba(rand, rand_extra) -> None:
    """The flash kernel at hymba-1.5b's prefill geometry (25 query heads
    over 5 kv heads of 64, window 1024): a 512-token prompt plus 128 meta
    rows (timed), 1152 rows, where the window cuts tiles, and 1 + 128
    rows (from ``rand_extra``)."""
    from repro_torch.kernels import flash_attention as fa

    b, h, kv, d, w = 1, 25, 5, 64, 1024
    for sq, draw in ((640, rand), (1152, rand), (129, rand_extra)):
        q, k, v = draw(b, sq, h, d), draw(b, sq, kv, d), draw(b, sq, kv, d)
        if sq == 640:
            flash_logged("hymba's prefill", q, k, v, window=w)
        else:
            close(f"flash hymba Sq=Sk={sq} window={w}",
                  fa.flash_attention(q, k, v, causal=True, window=w),
                  fa.flash_attention_plain(q, k, v, causal=True, window=w))


def ssm_inputs(rng, dev, b, s, h, state_scale, decay="mild", d=64, n=16):
    """x, dt, a_log, b, c, state of the selective scan on the card, as the
    hybrid layer makes them: dt = softplus(.) in bf16, a_log at the
    ``small`` init scale ("mild"); "strong": a_log = log(1..N) + 2 and dt
    = softplus(N + 2); "weak": dt = 1e-3."""
    import torch
    import torch.nn.functional as F

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
    bf = torch.bfloat16
    z = rand(b, s, h)
    dt = {"mild": F.softplus(z), "strong": F.softplus(z + 2),
          "weak": torch.full_like(z, 1e-3)}[decay]
    a_log = torch.log(torch.arange(1.0, n + 1, device=dev)).repeat(
        h, 1) + 2 if decay == "strong" else rand(h, n) * 0.02
    return (rand(b, s, h, d).to(bf), dt.to(bf), a_log.to(bf),
            rand(b, s, h, n).to(bf), rand(b, s, h, n).to(bf),
            rand(b, h, d, n) * state_scale)


def ssm_cost(b, s, h, d=64, n=16):
    """(operations, bytes) of the selective scan: x read and y written
    (bf16), b and c and dt read (bf16), a_log read, the state read and
    written (f32)."""
    return (5 * b * s * h * d * n + 3 * b * s * h * n,
            4 * b * s * h * d + 4 * b * s * h * n + 2 * b * s * h
            + 2 * h * n + 8 * b * h * d * n)


def ssm_kernel(rng, dev) -> dict:
    """The two selective-scan kernels (hymba-1.5b: 25 heads of 64, N=16):
    the chunked one at a batch-1 prefill of a 512-token prompt plus 128
    meta tokens from a zero state, the step one at a decode round (B=8,
    S=1; timed in place, as the hybrid's round calls it), each timed
    (device time split by CUDA kernel); and edge cases through the scan:
    S=1 at B=1, a ragged S=77, S=300 (past the Pallas kernel's 256-step
    block), nonzero states, the threshold's S - 1, S and S + 1, strong
    decay (a_log = log(1..N) + 2, dt = softplus(N + 2): a chunk's exponent
    reaches hundreds) and weak decay (dt = 1e-3), S=2048 from a nonzero
    state, N=8 at D=16 (the reduced hymba), and a scan split at step 777
    equal to the whole; and each kernel alone with its state as its own
    ``state_out``, bit for bit equal to a new buffer (the step kernel at
    its edge cases and a partial tail CTA).  Inputs as the hybrid layer
    makes them: dt = softplus(.) in bf16, a_log at the ``small`` init
    scale."""
    import torch
    from repro_torch.kernels import ssm_scan

    def inputs(*shape):
        return ssm_inputs(rng, dev, *shape)

    def check(name, x, kernel=None):
        before = (ssm_scan.ssm_step.launches, ssm_scan.ssm_chunked.launches)
        y, st = ssm_scan.ssm_scan(*x)
        took = "chunked" if ssm_scan.ssm_chunked.launches > before[1] \
            else "step"
        want = "chunked" if x[0].shape[1] >= ssm_scan.CHUNKED_MIN_S \
            else "step"
        if took != want or (kernel and kernel != took):
            raise AssertionError(f"{name}: ran the {took} kernel")
        py, pst = ssm_scan.ssm_scan_plain(*x)
        if not (torch.isfinite(y.float()).all() and torch.isfinite(st).all()):
            raise AssertionError(f"{name}: non-finite output")
        close(f"{name} state", st, pst)
        return close(name, y, py)

    def in_place(name, fn, x):
        """``fn`` with the state as its own ``state_out`` equals ``fn``
        with a new buffer bit for bit, and the plain scan within TOL."""
        y, st = fn(*x)
        mine = x[5].clone()
        y_in, st_in = fn(*x[:5], mine, state_out=mine)
        if st_in is not mine or not (torch.equal(y_in, y)
                                     and torch.equal(mine, st)):
            raise AssertionError(f"{name}: in place != out of place")
        py, pst = ssm_scan.ssm_scan_plain(*x)
        close(f"{name} state", mine, pst)
        return close(name, y_in, py)

    b, s, h = 1, 640, 25
    main = inputs(b, s, h, 0.0)
    err = check("ssm main (prefill)", main, "chunked")
    decode = inputs(8, 1, h, 1.0)
    decode_err = check("ssm decode step (B=8 S=1)", decode, "step")
    decode_err = max(decode_err, in_place("ssm decode step (B=8 S=1)",
                                          ssm_scan.ssm_scan, decode))
    t = ssm_scan.CHUNKED_MIN_S
    for shape in [(1, 1, h, 1.0), (1, 77, h, 1.0), (1, 300, h, 1.0),
                  (2, 33, 4, 3.0), (1, t - 1, h, 1.0), (1, t, h, 1.0),
                  (1, t + 1, h, 1.0), (1, 640, h, 1.0, "strong"),
                  (1, 640, h, 1.0, "weak"), (1, 2048, h, 1.0),
                  (2, 77, 4, 1.0, "mild", 16, 8),
                  (1, 640, 4, 1.0, "strong", 16, 8)]:
        check(f"ssm edge (B, S, H, state scale, decay, D, N)={shape}",
              inputs(*shape))
    # The step kernel alone, in place and out of place: strong decay (the
    # decay underflows to 0) and weak, from zero and nonzero states, N = 8
    # at D = 16, and B H D N / 4 threads that leave the last CTA of 128
    # one warp short (B=1 H=5 D=16 N=8: 160 threads).
    for shape in [(8, 1, h, 1.0, "strong"), (8, 1, h, 0.0, "weak"),
                  (8, t - 1, h, 1.0, "strong"), (8, 2, h, 0.0, "weak"),
                  (8, 1, h, 1.0, "mild", 16, 8), (1, 1, 5, 1.0, "mild", 16, 8),
                  (1, 3, 5, 1.0, "strong", 16, 8)]:
        in_place(f"ssm step kernel (B, S, H, state scale, decay, D, N)="
                 f"{shape}", ssm_scan.ssm_step, inputs(*shape))
    for shape in [(2, t, h, 1.0), (2, 77, 4, 1.0, "mild", 16, 8)]:
        in_place(f"ssm chunked kernel (B, S, H, state scale, decay, D, N)="
                 f"{shape}", ssm_scan.ssm_chunked, inputs(*shape))
    x, dt, a_log, bm, cm, st0 = inputs(1, 2048, h, 1.0)
    whole, st_whole = ssm_scan.ssm_scan(x, dt, a_log, bm, cm, st0)
    head, st_mid = ssm_scan.ssm_scan(x[:, :777], dt[:, :777], a_log,
                                     bm[:, :777], cm[:, :777], st0)
    tail, st_end = ssm_scan.ssm_scan(
        *(v[:, 777:].contiguous() for v in (x, dt)), a_log,
        *(v[:, 777:].contiguous() for v in (bm, cm)), st_mid)
    close("ssm split at 777 == whole", torch.cat([head, tail], 1), whole)
    close("ssm split at 777 == whole, state", st_end, st_whole)
    log(f"ssm: the step kernel below S={t}, the chunked kernel from S={t}; "
        f"edge cases (threshold, strong and weak decay, S=2048, N=8, a "
        f"partial tail CTA, split == whole) within {TOL} of the plain scan; "
        f"each kernel's state in place == out of place, bit for bit")
    flops, io = ssm_cost(b, s, h)
    n = copies_for(io)
    sets = [[v.clone() for v in main] for _ in range(n)]
    bnd, by = bound(flops, io)
    dflops, dio = ssm_cost(8, 1, h)
    dsets = [[v.clone() for v in decode] for _ in range(copies_for(dio))]
    dbnd, dby = bound(dflops, dio)
    log(f"ssm: the step kernel at a round (B=8 S=1 H=25), out of place "
        f"(a new state buffer): device_ms="
        f"{device_ms([lambda v=v: ssm_scan.ssm_step(*v) for v in dsets])}")
    for label, shape in (("B=1 (100 CTAs)", (1, 640, h)),
                         ("B=2 (200 CTAs: two waves?)", (2, 640, h)),
                         ("S=2048 (128 chunks)", (1, 2048, h))):
        more = inputs(*shape, 0.0)
        log(f"ssm: the chunked kernel at {label}: device_ms="
            f"{device_ms([lambda: ssm_scan.ssm_chunked(*more)])}")
    return {
        "ssm_chunked": dict(
            route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
            replaces="src/repro/kernels/ssm_scan.py:60", max_abs_err=err,
            bound_ms=bnd, bound_by=by,
            shape="B=1 S=640 H=25 D=64 N=16 bf16, f32 state (prefill)",
            **kernel_times([lambda v=v: ssm_scan.ssm_scan(*v) for v in sets],
                           [lambda v=v: ssm_scan.ssm_scan_plain(*v)
                            for v in sets], plain_iters=3,
                           label="ssm chunked")),
        "ssm_step": dict(
            route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
            replaces="src/repro/kernels/ssm_scan.py:60",
            max_abs_err=decode_err, bound_ms=dbnd, bound_by=dby,
            shape="B=8 S=1 H=25 D=64 N=16 bf16, f32 state updated in place "
                  "(a decode round)",
            **kernel_times([lambda v=v: ssm_scan.ssm_scan(*v, state_out=v[5])
                            for v in dsets],
                           [lambda v=v: ssm_scan.ssm_scan_plain(*v)
                            for v in dsets], label="ssm step"))}


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
    compare = Compare("reference")
    for kv_int8 in (False, True):
        _reference_decode(model, p_gpu, p_ref, prompt, n, max_len, kv_int8,
                          compare)
    log(f"reference: 2-layer d=896 H=7 K=1 D=128 model, prefill + 8 dense "
        f"+ 8 paged decode steps from bf16 and from int8 caches on the card "
        f"within {compare.worst:.4f} (max |diff| / max |logit|, limit "
        f"{REF_TOL}) of f32 on the CPU")
    _reference_rwkv()
    _reference_hybrid()


class Compare:
    """Logits on the card against the f32 CPU reference: finite, and
    max |diff| / max |reference logit| within ``REF_TOL``."""

    def __init__(self, label: str):
        self.label, self.worst = label, 0.0

    def __call__(self, what, got, ref) -> None:
        import torch
        got = got.float().cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{self.label} {what}: non-finite logits")
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        self.worst = max(self.worst, rel)
        if rel > REF_TOL:
            raise AssertionError(f"{self.label} {what}: rel err {rel} > "
                                 f"{REF_TOL}")


def _reference_decode(model, p_gpu, p_ref, prompt, n, max_len, kv_int8,
                      compare) -> None:
    import torch
    dev = torch.device("cuda", torch.cuda.current_device())
    kind = "int8" if kv_int8 else "bf16"
    lg, cg = model.prefill(p_gpu, torch.as_tensor(prompt, device=dev),
                           max_len=max_len, length=n, kv_int8=kv_int8)
    lr, cr = model.prefill(p_ref, torch.as_tensor(prompt), max_len=max_len,
                           length=n, kv_int8=kv_int8)
    compare(f"{kind} prefill", lg, lr)
    # Paged pools from the same prefill entries (4 blocks of 16 rows,
    # scattered), then teacher-forced decode on both planes.
    bs = 16
    row = np.array([3, 1, 4, 2], np.int32)
    write = np.ones(4, bool)
    pg = model.append_paged(model.init_paged_cache(5, bs, dev, kv_int8),
                            cg, row, write)
    pr = model.append_paged(model.init_paged_cache(5, bs, kv_int8=kv_int8),
                            cr, row, write)
    tbl_g = torch.as_tensor(row[None], device=dev)
    tbl_r = torch.as_tensor(row[None])
    tok = model.sample_greedy(lr)
    for step in range(8):
        pos = n + step
        lg, cg = model.decode_step(p_gpu, tok.to(dev), cg)
        lr, cr = model.decode_step(p_ref, tok, cr)
        compare(f"{kind} decode step {step}", lg, lr)
        plg, _ = model.decode_step_paged(
            p_gpu, tok.to(dev), pg, tbl_g,
            torch.tensor([pos], dtype=torch.int32, device=dev))
        plr, _ = model.decode_step_paged(
            p_ref, tok, pr, tbl_r, torch.tensor([pos], dtype=torch.int32))
        compare(f"{kind} paged decode step {step}", plg, plr)
        tok = model.sample_greedy(lr)


def _reference_rwkv() -> None:
    """A 2-layer RWKV-6 model with head size 64 (4 heads): prefill at the
    prompt's exact length (37 tokens: the chunked WKV-6 kernel) and 8
    decode steps (the step kernel) in bf16 on the card, against f32 on the
    CPU through the plain scan."""
    import torch
    from repro_torch.kernels import wkv6
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="rwkv6-heads", family="rwkv", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                      vocab_size=1024)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    for part in p_cpu["layers"].values():  # the zero-initialised norms
        for key in ("ln", "gn"):
            if key in part:
                part[key].copy_(torch.randn(part[key].shape,
                                            generator=gen) * 0.1)
    dev = torch.device("cuda", torch.cuda.current_device())
    p_gpu = _tree(p_cpu, lambda t: t.to(dev))
    p_ref = _tree(p_cpu, lambda t: t.float())
    rng = np.random.default_rng(SEED + 2)
    prompt = rng.integers(0, cfg.vocab_size, (1, 37)).astype(np.int32)
    compare = Compare("rwkv reference")

    chunked, step = wkv6.wkv6_chunked.launches, wkv6.wkv6_step.launches
    lg, cg = model.prefill(p_gpu, torch.as_tensor(prompt, device=dev))
    lr, cr = model.prefill(p_ref, torch.as_tensor(prompt))
    compare("prefill", lg, lr)
    tok = model.sample_greedy(lr)
    for step_i in range(8):
        lg, cg = model.decode_step(p_gpu, tok.to(dev), cg)
        lr, cr = model.decode_step(p_ref, tok, cr)
        compare(f"decode step {step_i}", lg, lr)
        tok = model.sample_greedy(lr)
    ran = (wkv6.wkv6_chunked.launches - chunked,
           wkv6.wkv6_step.launches - step)
    if ran != (cfg.n_layers, 8 * cfg.n_layers):
        raise AssertionError(f"rwkv reference: (chunked, step) WKV-6 "
                             f"launches {ran}")
    log(f"reference: 2-layer RWKV-6 d=256 (4 heads of 64), prefill of 37 "
        f"tokens (the chunked kernel) + 8 decode steps (the step kernel) "
        f"on the card within {compare.worst:.4f} (limit {REF_TOL}) of f32 "
        f"on the CPU")


def _reference_hybrid() -> None:
    """A 2-layer hybrid with hymba-1.5b's head geometry (d=1600, 25 query
    and 5 kv heads of 64, N=16) and cuts that make the rolled cache work
    (window 1024 -> 64, meta tokens 128 -> 16; d_ff and the vocab cut
    too): a 61-token prompt plus 16 meta rows passes the window at prefill
    (flash with the window, the chunked scan over 77 steps), and 8 decode
    steps (rolled attention, the step scan at S=1) wrap the 64-row cache.
    bf16 on
    the card through the kernels against f32 on the CPU through the plain
    versions."""
    import torch
    from repro_torch.kernels import ssm_scan
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="hymba-heads", family="hybrid", n_layers=2,
                      d_model=1600, n_heads=25, n_kv_heads=5, d_ff=1024,
                      vocab_size=1024, mlp="swiglu", ssm_state=16,
                      sliding_window=64, n_context_tokens=16)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    for key, leaf in p_cpu["layers"].items():  # the zero-initialised norms
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 0.1)
    dev = torch.device("cuda", torch.cuda.current_device())
    p_gpu = _tree(p_cpu, lambda t: t.to(dev))
    p_ref = _tree(p_cpu, lambda t: t.float())
    rng = np.random.default_rng(SEED + 5)
    prompt = rng.integers(0, cfg.vocab_size, (1, 61)).astype(np.int32)
    compare = Compare("hybrid reference")
    max_len = 64
    chunked, step = ssm_scan.ssm_chunked.launches, ssm_scan.ssm_step.launches
    lg, cg = model.prefill(p_gpu, torch.as_tensor(prompt, device=dev),
                           max_len=max_len)
    lr, cr = model.prefill(p_ref, torch.as_tensor(prompt), max_len=max_len)
    compare("prefill", lg, lr)
    if cg["k"].shape[2] != 64 or int(cg["pos"]) != 77:
        raise AssertionError(f"hybrid reference: cache rows "
                             f"{cg['k'].shape[2]}, pos {int(cg['pos'])}")
    tok = model.sample_greedy(lr)
    for i in range(8):
        lg, cg = model.decode_step(p_gpu, tok.to(dev), cg)
        lr, cr = model.decode_step(p_ref, tok, cr)
        compare(f"decode step {i}", lg, lr)
        tok = model.sample_greedy(lr)
    ran = (ssm_scan.ssm_chunked.launches - chunked,
           ssm_scan.ssm_step.launches - step)
    if ran != (cfg.n_layers, 8 * cfg.n_layers):
        raise AssertionError(f"hybrid reference: (chunked, step) scan "
                             f"launches {ran}")
    log(f"reference: 2-layer hybrid d=1600 (25 q / 5 kv heads of 64, N=16; "
        f"cut: window 1024 -> 64, meta 128 -> 16, d_ff 5504 -> 1024, V "
        f"32001 -> 1024), prefill of 61 tokens + 16 meta rows past the "
        f"window + 8 decode steps wrapping the rolled cache on the card "
        f"within {compare.worst:.4f} (limit {REF_TOL}) of f32 on the CPU")


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------------
# 3. full-width serving: qwen2-7b bf16 and int8, continuous and paged;
#    rwkv6-1.6b and hymba-1.5b continuous
# --------------------------------------------------------------------------

HYBRID_PARAMS = 1_351_336_800    # hymba-1.5b, as the JAX package counts
HYBRID_DENSE_BYTES = 361_758_724  # its dense_kv_bytes(8, 1024): rolled
#                                   K/V of 1024 rows + the f32 SSM state
INT8_DENSE_BYTES = 238_551_044   # Model.dense_kv_bytes(8, 1024), int8 KV
BF16_DENSE_BYTES = 469_762_052   # the same in bf16
INT8_BLOCK_BYTES = 465_920       # Model.kv_block_bytes(16), int8 KV
BF16_BLOCK_BYTES = 917_504       # the same in bf16


def serve_phase(rng) -> dict[str, int]:
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.core.resources import Alloc
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    model, params = serve.init_model(ARCH, reduced=False, seed=SEED)
    torch.cuda.synchronize()
    cfg = model.cfg
    log(f"serve: {ARCH} full width ({cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} D={cfg.dh} d_ff={cfg.d_ff} "
        f"V={cfg.vocab_size}), {model.n_params()} params, drawn on the card "
        f"in {time.perf_counter() - t0:.1f}s")
    lens = rng.integers(64, 513, 16)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    alloc = Alloc(sm=0.5, quota_request=0.5, quota_limit=1.0)
    totals = {name: 0 for name in kernels.KERNELS}
    accounting = {
        "dense_kv_bytes(8, 1024)": (model.dense_kv_bytes(8, 1024, False),
                                    model.dense_kv_bytes(8, 1024, True)),
        "kv_block_bytes(16)": (model.kv_block_bytes(16, False),
                               model.kv_block_bytes(16, True))}
    if accounting != {
            "dense_kv_bytes(8, 1024)": (BF16_DENSE_BYTES, INT8_DENSE_BYTES),
            "kv_block_bytes(16)": (BF16_BLOCK_BYTES, INT8_BLOCK_BYTES)}:
        raise AssertionError(f"KV byte accounting (bf16, int8): {accounting}")
    log(f"serve: KV byte accounting (bf16, int8): {accounting}")
    streams = {}
    for mode, int8, kernel in [
            ("continuous", False, "decode_attention"),
            ("paged", False, "paged_decode_attention"),
            ("int8 continuous", True, "decode_attention_quant"),
            ("int8 paged", True, "paged_decode_attention_quant")]:
        streams[mode] = serve_mode(model, params, ARCH, prompts, alloc, mode,
                                   {"flash_attention", kernel}, totals,
                                   int8=int8)
    for a, b in [("continuous", "paged"), ("int8 continuous", "int8 paged")]:
        if streams[a] != streams[b]:
            raise AssertionError(f"{a} and {b} greedy streams differ")
        log(f"serve: {a} and {b} emit identical greedy streams")
    same = [x == y for s8, s16 in zip(streams["int8 continuous"],
                                      streams["continuous"])
            for x, y in zip(s8, s16)]
    log(f"serve: int8 KV streams agree with the bf16 streams on "
        f"{sum(same)}/{len(same)} tokens ({np.mean(same):.3f}; logged, not "
        f"asserted: random weights, near-tie argmaxes flip)")
    profile_window(model, params, prompts[:8], alloc)
    shared_prefix_phase(model, params, alloc, totals, rng)
    chat = shared_prompts(np.random.default_rng(SEED + 1), cfg.vocab_size)
    migration_phase(model, params, alloc, chat)
    release_phase(model, params, alloc, chat)
    fleet_phase(model, params, totals)

    # -- rwkv6-1.6b, the same request mix, after qwen2-7b is freed --------
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, params = serve.init_model(RWKV_ARCH, reduced=False, seed=SEED)
    torch.cuda.synchronize()
    cfg = model.cfg
    log(f"serve: {RWKV_ARCH} full width ({cfg.n_layers}L d={cfg.d_model} "
        f"heads {cfg.d_model // 64}x64 d_ff={cfg.d_ff} V={cfg.vocab_size}), "
        f"{model.n_params()} params, drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    rwkv_prompts = [p % cfg.vocab_size for p in prompts]
    serve_mode(model, params, RWKV_ARCH, rwkv_prompts, alloc, "continuous",
               {"wkv6_chunked", "wkv6_step"}, totals)
    profile_window(model, params, rwkv_prompts[:8], alloc, RWKV_ARCH,
                   "continuous")

    # -- hymba-1.5b, the same request mix, after rwkv6-1.6b is freed ------
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, params = serve.init_model(HYBRID_ARCH, reduced=False, seed=SEED)
    torch.cuda.synchronize()
    cfg = model.cfg
    log(f"serve: {HYBRID_ARCH} full width ({cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} D={cfg.dh} N={cfg.ssm_state} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size}, {cfg.n_context_tokens} meta "
        f"tokens, window {cfg.sliding_window}), {model.n_params()} params, "
        f"drawn on the card in {time.perf_counter() - t0:.1f}s")
    sizes = (model.n_params(), model.dense_kv_bytes(8, 1024))
    if sizes != (HYBRID_PARAMS, HYBRID_DENSE_BYTES):
        raise AssertionError(f"{HYBRID_ARCH} (params, slot-pool bytes): "
                             f"{sizes}")
    hybrid_prompts = [p % cfg.vocab_size for p in prompts]
    serve_mode(model, params, HYBRID_ARCH, hybrid_prompts, alloc,
               "continuous", {"flash_attention", "ssm_chunked", "ssm_step"},
               totals)
    profile_window(model, params, hybrid_prompts[:8], alloc, HYBRID_ARCH,
                   "continuous")
    return totals


EAGER_TOKENS = 8  # the fused=False runs serve this many tokens a request
LABELS = {"_dispatch_round": "decode_round", "_admit": "admission"}
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")  # host calls that put work on the card


def deploy(model, params, arch, alloc, batching, *, int8=False,
           n_instances=2, **kw):
    """A ``ServingEngine`` on the card with ``n_instances`` weight-shared
    instances (``max_batch=8``, ``max_len=1024``, block size 16), the
    int8-KV gate set for the deploy only (an instance reads it once)."""
    import os
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(window=0.2, device="cuda")
    gate = os.environ.pop("REPRO_KV_INT8", None)
    if int8:
        os.environ["REPRO_KV_INT8"] = "1"
    engine.deploy(arch, model, params, alloc, n_instances=n_instances,
                  max_batch=8, max_len=1024, batching=batching,
                  block_size=16, **kw)
    os.environ.pop("REPRO_KV_INT8", None)
    if gate is not None:
        os.environ["REPRO_KV_INT8"] = gate
    return engine


WARM_BUCKETS = (64, 128, 256, 512)  # the buckets of 64-512-token prompts


def warm(engine, arch, prompt) -> dict:
    """Before any timed window, two requests of 3 tokens per instance and
    serve bucket (64, 128, 256 and 512 tokens, cut from ``prompt`` repeated),
    all admitted in one pass: each bucket's first admission runs eagerly
    and its second is captured and replayed (the dense family), the first
    round runs eagerly and the second is captured.  Returns each
    instance's graphs, (round graph, {bucket: prefill graph}); an engine
    without them (a checkout before them, ``--windows``) gets ``None``s."""
    from repro_torch.launch import serve

    n = len(engine.instances)
    serve.drive(engine, arch, [np.resize(prompt, b) for b in WARM_BUCKETS
                               for _ in range(2 * n)], 3)
    graphs = {}
    for k, inst in engine.instances.items():
        rg = getattr(inst, "round_graph", None)
        if rg is not None and (rg.graph is None or rg.captures != 1
                               or inst.rounds != 2):
            raise AssertionError(f"{k}: warm-up left {rg.captures} captures "
                                 f"after {inst.rounds} rounds")
        pg = getattr(inst, "prefill_graphs", None)
        if pg is not None:
            state = {b: (g.graph is not None, g.eager_rounds, g.captures,
                         g.replays) for b, g in pg.by_bucket.items()}
            if state != {b: (True, 1, 1, 1) for b in WARM_BUCKETS}:
                raise AssertionError(f"{k}: warm-up left prefill graphs "
                                     f"(captured, eager, captures, replays) "
                                     f"{state}")
        graphs[k] = (rg and rg.graph,
                     pg and {b: g.graph for b, g in pg.by_bucket.items()})
    return graphs


def same_graphs(engine, graphs, what) -> tuple[int, int]:
    """Fails unless every instance still has the graphs it captured in the
    warm-up, its round's and its prefill buckets', and no other; returns
    the rounds and the prefills replayed since."""
    rounds = prefills = 0
    for k, inst in engine.instances.items():
        rg = getattr(inst, "round_graph", None)
        if rg is not None:
            if rg.graph is not graphs[k][0] or rg.captures != 1:
                raise AssertionError(f"{what}: {k} captured its round again")
            rounds += rg.replays
        pg = getattr(inst, "prefill_graphs", None)
        if pg is not None:
            now = {b: g.graph for b, g in pg.by_bucket.items()}
            if pg.captures != len(WARM_BUCKETS) or now != graphs[k][1]:
                raise AssertionError(f"{what}: {k} captured a prefill again")
            prefills += pg.replays
    return rounds, prefills


def timed_serve(engine, arch, prompts, new_tokens) -> tuple:
    """Warm every instance through its captures, then serve ``prompts``
    with the launch counts and the peak memory set to 0 just before and
    read just after.  Returns (requests, completed, wall s, launch counts,
    telemetry delta per instance, (rounds, prefills) replayed, peak
    bytes allocated and reserved: a graph's memory pool is reserved, and
    a replay allocates nothing)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve

    graphs = warm(engine, arch, prompts[0])
    before = {k: dict(v) for k, v in engine.telemetry().items()}
    rounds0, prefills0 = same_graphs(engine, graphs, arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    reqs, done, wall = serve.drive(engine, arch, prompts, new_tokens)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rounds, prefills = same_graphs(engine, graphs, arch)
    delta = {k: {c: v[c] - before[k][c] for c in v}
             for k, v in engine.telemetry().items()}
    return (reqs, done, wall, counts, delta,
            (rounds - rounds0, prefills - prefills0),
            (torch.cuda.max_memory_allocated(),
             torch.cuda.max_memory_reserved()))


def serve_mode(model, params, arch, prompts, alloc, mode, used, totals, *,
               int8=False, new_tokens=32) -> list:
    """Serve ``prompts`` on two weight-shared instances in ``mode``, each
    through its round graph, captured in a warm-up before the run; the
    launch counts are set to 0 just before the run and read just after
    it.  Checks that every request is served, one host sync per pass, the
    weights stored once, that every round of the run was a replay of the
    graph captured in the warm-up, that the kernels in ``used`` ran and no
    other, each once per layer and prefill (flash, chunked WKV-6, the
    chunked scan) or round (decode, step WKV-6, the step scan), that each
    scan dispatcher launched once per layer and pass of either shape, and
    that a ``fused=False`` engine (the host-argmax reference, eager) on
    the same prompts gives the same greedy streams over its
    ``EAGER_TOKENS`` tokens.  Returns the token streams."""
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.kernels import ssm_scan, wkv6
    from repro_torch.launch import serve

    batching = mode.split()[-1]
    engine = deploy(model, params, arch, alloc, batching, int8=int8)
    insts = list(engine.instances.values())
    if any(i.kv_int8 != int8 for i in insts):
        raise AssertionError(f"{arch} {mode}: instances not int8={int8}")
    if batching == "paged" and any(
            i.allocator.block_bytes != model.kv_block_bytes(16, int8)
            for i in insts):
        raise AssertionError(f"{arch} {mode}: admission block bytes")
    wbytes = pytree_nbytes(params)
    if engine.memory_bytes() != wbytes:
        raise AssertionError(
            f"{arch} {mode}: store holds {engine.memory_bytes()} bytes for "
            f"two instances, expected one copy of {wbytes}")
    reqs, done, wall, counts, delta, (replayed, pre_replayed), peak = \
        timed_serve(engine, arch, prompts, new_tokens)
    if done != len(prompts) or not all(
            r.done and len(r.tokens_out) == new_tokens for r in reqs):
        raise AssertionError(f"{arch} {mode}: served {done}/{len(prompts)}")
    passes = {k: v["steps"] for k, v in delta.items()}
    syncs = {k: v["syncs"] for k, v in delta.items()}
    if passes != syncs:
        raise AssertionError(f"{arch} {mode}: syncs {syncs} != passes "
                             f"{passes}")
    if any(counts[k] == 0 for k in used) or any(
            counts[k] != 0 for k in counts if k not in used):
        raise AssertionError(f"{arch} {mode}: kernel launches {counts}")
    prefills = sum(v["prefills"] for v in delta.values())
    rounds = sum(v["rounds"] for v in delta.values())
    if replayed != rounds:
        raise AssertionError(f"{arch} {mode}: {replayed} of {rounds} rounds "
                             f"replayed")
    graphed = model.supports_bucketed_prefill()  # else exact-length, eager
    if pre_replayed != (prefills if graphed else 0):
        raise AssertionError(f"{arch} {mode}: {pre_replayed} of {prefills} "
                             f"prefills replayed")
    for k in used:  # one launch per layer and prefill, or round
        per = prefills if k in {"flash_attention", "wkv6_chunked",
                                "ssm_chunked"} else rounds
        if counts[k] != model.cfg.n_layers * per:
            raise AssertionError(
                f"{arch} {mode}: {counts[k]} {k} launches for {prefills} "
                f"prefills and {rounds} rounds of {model.cfg.n_layers} "
                f"layers")
    for scan, pair in ((wkv6.wkv6_scan, ("wkv6_chunked", "wkv6_step")),
                       (ssm_scan.ssm_scan, ("ssm_chunked", "ssm_step"))):
        if scan.launches != sum(counts[k] for k in pair):
            raise AssertionError(f"{arch} {mode}: {scan.__name__} launched "
                                 f"{scan.launches} times, its kernels "
                                 f"{[counts[k] for k in pair]}")
    if "ssm_chunked" in used:
        log(f"serve {arch} {mode}: scan launches by kernel: ssm_chunked "
            f"{counts['ssm_chunked']} = {model.cfg.n_layers} layers x "
            f"{prefills} prefills, ssm_step {counts['ssm_step']} = "
            f"{model.cfg.n_layers} layers x {rounds} rounds")
    vocab = model.cfg.vocab_size
    for r in reqs:
        tok = np.asarray(r.tokens_out)
        if tok.min() < 0 or tok.max() >= vocab:
            raise AssertionError(f"{arch} {mode}: token out of vocab")
    lat = np.array([r.finished_at - r.submitted_at for r in reqs])
    n_tok = sum(len(r.tokens_out) for r in reqs)
    log(f"serve {arch} {mode}: {done} requests, {n_tok} tokens in "
        f"{wall:.3f}s = {n_tok / wall:.1f} tokens/s; latency "
        f"p50={np.percentile(lat, 50):.3f}s p99={np.percentile(lat, 99):.3f}s;"
        f" passes {passes}; syncs {syncs} (1 per pass); prefills "
        f"{prefills}, of them replayed from the warm-up's graphs "
        f"{pre_replayed} (1 capture per instance and bucket, before the "
        f"run{'' if graphed else '; exact-length prefill, eager'}); rounds "
        f"{rounds}, of them replayed {replayed} (1 capture per instance, "
        f"before the run); "
        f"launches {counts}; peak device memory allocated {peak[0]}, "
        f"reserved {peak[1]} bytes; weights "
        f"stored once: {engine.memory_bytes()} bytes for 2 instances")
    for k in totals:
        totals[k] += counts[k]
    streams = [list(r.tokens_out) for r in reqs]
    del engine
    ref = deploy(model, params, arch, alloc, batching, int8=int8,
                 fused=False)
    host, done, _ = serve.drive(ref, arch, prompts, EAGER_TOKENS)
    if done != len(prompts) or [r.tokens_out for r in host] != [
            s[:EAGER_TOKENS] for s in streams]:
        raise AssertionError(f"{arch} {mode}: the graph's streams differ "
                             f"from fused=False's")
    log(f"serve {arch} {mode}: the graph-backed rounds' greedy streams equal "
        f"a fused=False engine's (host argmax, eager) over their first "
        f"{EAGER_TOKENS} tokens, {len(prompts)} requests")
    if mode == "paged":
        logit_check(model, params, arch, prompts[:8], alloc)
    if graphed:
        prefill_check(model, params, arch, prompts[:2], alloc, batching,
                      int8)
    return streams


def prefill_check(model, params, arch, prompts, alloc, batching, int8
                  ) -> None:
    """One admission replayed from its bucket's graph against the eager
    admission body on the same argument buffer and from the same state:
    the logits row, every pool leaf, the slot tokens and the pending
    tokens must agree bit for bit, paged pools in every block but the
    sink (it takes every block the admission must not write, and which of
    those lands last is not fixed).  The instance admits ``prompts`` (one
    bucket: the first eagerly, the second captured and replayed); the
    compared admission re-admits the second into its own slot."""
    import functools
    import torch

    bucket = 1 << (len(prompts[1]) - 1).bit_length()
    prompts = [np.resize(prompts[0], len(prompts[1])), prompts[1]]
    engine = deploy(model, params, arch, alloc, batching, int8=int8,
                    n_instances=1)
    for p in prompts:
        engine.submit(arch, p, max_new_tokens=8)
    (inst,) = engine.instances.values()
    inst.dispatch_step()  # both admissions, then the round; no sync
    graph = inst.prefill_graphs.by_bucket[bucket]
    if (graph.eager_rounds, graph.captures, graph.replays) != (1, 1, 1):
        raise AssertionError(f"prefill check: bucket {bucket} graph "
                             f"{graph.eager_rounds, graph.captures}")
    live = {"slot tokens": inst._slot_tok_dev,
            "pending tokens": inst._pending_dev, **inst.cache}
    start = {k: v.clone() for k, v in live.items()}
    body = functools.partial(inst._admission_body, bucket, True)
    replayed = inst.prefill_graphs.run(bucket, body).clone()
    after = {k: v.clone() for k, v in live.items()}
    for k, v in start.items():
        live[k].copy_(v)
    eager = body()
    torch.cuda.synchronize()
    if batching == "paged":  # the sink block is the pools' last
        live = {k: v if "tokens" in k else v[:, :-1] for k, v in live.items()}
        after = {k: v if "tokens" in k else v[:, :-1]
                 for k, v in after.items()}
    checks = {"logits": torch.equal(replayed, eager),
              **{k: torch.equal(after[k], v) for k, v in live.items()}}
    if not all(checks.values()) or graph.replays != 2:
        raise AssertionError(f"prefill check: replay != eager: {checks}")
    log(f"prefill check {arch} {'int8 ' if int8 else ''}{batching}: a "
        f"{len(prompts[1])}-token admission replayed from the bucket-"
        f"{bucket} graph equals the eager admission bit for bit (logits "
        f"{tuple(eager.shape)}, {len(live) - 2} pool leaves"
        f"{' but the sink block' if batching == 'paged' else ''}, slot and "
        f"pending tokens)")


def logit_check(model, params, arch, prompts, alloc) -> None:
    """One paged round with every slot live: the paged decode step
    captured as a graph over one copy of an instance's pools, tables,
    positions and tokens, replayed, against the eager
    ``decode_step_paged`` on a second copy (logits and pools bit for
    bit); then the instance's own replayed round must land the eager
    logits' greedy tokens and advanced positions, and its pools must equal
    the eager copy's."""
    import torch
    from repro_torch.serving.graphs import RoundGraph

    engine = deploy(model, params, arch, alloc, "paged", n_instances=1)
    for p in prompts:
        engine.submit(arch, p, max_new_tokens=8)
    (inst,) = engine.instances.values()
    for _ in range(3):  # admission + eager round, capture, replay
        inst.run_step()
    if (inst.n_active() != inst.max_batch  # no free slot: no mask needed
            or inst.round_graph.replays != 2):
        raise AssertionError(f"logit check: {inst.n_active()} live slots, "
                             f"{inst.round_graph.replays} replays")

    def state():
        return (inst._slot_tok_dev.clone(),
                {k: v.clone() for k, v in inst.cache.items()},
                inst._pos_dev.clone())

    tables, active = inst._tables_dev.clone(), inst._active_dev.clone()
    g_tok, g_cache, g_pos = state()
    e_tok, e_cache, e_pos = state()
    graph = RoundGraph("cuda")
    graph.capture(lambda: model.decode_step_paged(params, g_tok, g_cache,
                                                  tables, g_pos)[0])
    g_logits = graph.replay()
    e_logits, _ = model.decode_step_paged(params, e_tok, e_cache, tables,
                                          e_pos)
    inst.dispatch_step()  # the instance's own round: a replay
    torch.cuda.synchronize()
    checks = {
        "graph logits": torch.equal(g_logits, e_logits),
        "graph pools": all(torch.equal(g_cache[k], e_cache[k])
                           for k in e_cache),
        "round tokens": torch.equal(inst._slot_tok_dev,
                                    model.sample_greedy(e_logits)),
        "round positions": torch.equal(inst._pos_dev, e_pos + active),
        "round pools": all(torch.equal(inst.cache[k], e_cache[k])
                           for k in e_cache)}
    if not all(checks.values()) or inst.round_graph.replays != 3:
        raise AssertionError(f"logit check: graph != eager: {checks}")
    log(f"logit check {arch} paged ({len(prompts)} live slots): the paged "
        f"decode step replayed as a graph over a copy of the pools equals "
        f"the eager decode_step_paged bit for bit (logits "
        f"{tuple(g_logits.shape)}, pools), and the instance's replayed "
        f"round lands its greedy tokens, positions and pools")


# --------------------------------------------------------------------------
# 4. qwen2-7b prefix sharing with copy-on-write, migration and release
# --------------------------------------------------------------------------

SYSTEM_TOKENS = 256   # the system prompt every request shares: 16 blocks
SHARED_REQUESTS = 16  # per instance, two waves of max_batch=8
PAIRS = ((1, 5), (9, 13))  # per instance: exact duplicates, one pair a wave
MIGRATION_TOKENS = 16


def shared_prompts(rng, vocab: int, n_instances: int = 2) -> list:
    """The chat function's traffic: each request is one 256-token system
    prompt and a unique suffix of 16-240 tokens (every prompt in bucket
    512), but for two pairs of exact duplicates per instance whose length
    is not a multiple of 16.  Submitted in order, request i lands on
    instance i % n_instances (JSQ over equal loads), so each instance gets
    ``SHARED_REQUESTS``, and each pair falls in one wave."""
    system = rng.integers(0, vocab, SYSTEM_TOKENS)
    per = []
    for _ in range(n_instances):
        mine = [np.concatenate([system, rng.integers(
            0, vocab, int(rng.integers(16, 241)))]).astype(np.int32)
            for _ in range(SHARED_REQUESTS)]
        for a, b in PAIRS:
            n = int(rng.integers(1, 15)) * 16 + int(rng.integers(1, 16))
            mine[a] = np.concatenate([system, rng.integers(
                0, vocab, n)]).astype(np.int32)
            mine[b] = mine[a].copy()
        per.append(mine)
    return [per[i % n_instances][i // n_instances]
            for i in range(n_instances * SHARED_REQUESTS)]


def replay_sharing(waves: list, block_size: int, n_blocks: int) -> tuple:
    """A host replay of the paged admission plan: one instance's waves in
    order, each a list of (prompt, new tokens) admitted in one pass into
    slots 0.., decoded together to the end and released, as the engine
    runs them when a wave fills ``max_batch`` and its requests ask for
    equal tokens.  It makes the engine's calls on a fresh allocator
    (digests, ``match_prefix``, ``allocate_shared``, ``register_prefix``,
    one ``writable_block`` a slot a round).  Returns (sharing hits, COW
    copies) per wave and the allocator's high watermark in blocks."""
    from repro_torch.serving.paging import (KVPageAllocator, PageTable,
                                            prompt_digests)

    alloc = KVPageAllocator(n_blocks, block_size)
    pages = PageTable(alloc)
    out = []
    for wave in waves:
        hits = cow = 0
        pos = []
        for slot, (prompt, new) in enumerate(wave):
            full, tail = prompt_digests(prompt, block_size)
            shared, tail_block = pages.match_prefix(full, tail)
            both = shared + ([tail_block] if tail_block is not None else [])
            rows = len(prompt) + new - 1
            if both:
                pages.allocate_shared(slot, rows, both,
                                      tail_shared=tail_block is not None)
                hits += len(both)
            else:
                pages.allocate(slot, rows)
            pages.register_prefix(slot, full, tail)
            pos.append(len(prompt))
        for _ in range(wave[0][1] - 1):
            for slot in range(len(wave)):
                cow += pages.writable_block(slot, pos[slot])[1] is not None
                pos[slot] += 1
        for slot in range(len(wave)):
            pages.release(slot)
        out.append((hits, cow))
    return out, alloc.high_watermark


def predicted_sharing(prompts, new_tokens, n_instances=2) -> tuple:
    """``replay_sharing`` of each instance's warm-up wave (``warm``: two
    3-token requests of every serve bucket, cut from the first prompt)
    and its timed waves.  Returns the timed run's (hits, COW copies)
    summed over instances and each instance's high watermark."""
    warm_wave = [(np.resize(prompts[0], b), 3) for b in WARM_BUCKETS
                 for _ in range(2)]
    hits = cow = 0
    marks = []
    for i in range(n_instances):
        mine = [(p, new_tokens) for p in prompts[i::n_instances]]
        waves = [warm_wave] + [mine[w:w + 8] for w in range(0, len(mine), 8)]
        per_wave, mark = replay_sharing(waves, 16, 8 * 1024 // 16)
        hits += sum(h for h, _ in per_wave[1:])
        cow += sum(c for _, c in per_wave[1:])
        marks.append(mark)
    return hits, cow, marks


def shared_prefix_phase(model, params, alloc, totals, rng) -> None:
    """qwen2-7b at full width, paged with prefix sharing (the default),
    from bf16 and then int8 KV, two weight-shared instances, the chat
    traffic of ``shared_prompts``, 32 new tokens a request: sharing hits
    and COW copies equal to ``predicted_sharing``'s, every timed round and
    prefill a replay of the warm-up's graphs, ``kv_bytes_saved() > 0``
    while the requests run, streams equal to an unshared paged engine's
    and a continuous engine's, and an allocator high watermark below the
    unshared run's; one COW pass's launches counted by the profiler."""
    from repro_torch.launch import serve

    vocab = model.cfg.vocab_size
    prompts = shared_prompts(rng, vocab)
    want_hits, want_cow, want_marks = predicted_sharing(prompts, 32)
    for int8, kernel in ((False, "paged_decode_attention"),
                         (True, "paged_decode_attention_quant")):
        kv = "int8" if int8 else "bf16"
        runs = {}
        for mode, kw in (("shared", {}), ("unshared",
                                           {"prefix_sharing": False})):
            engine = deploy(model, params, ARCH, alloc, "paged", int8=int8,
                            **kw)
            saved = []  # bytes saved, read at every grant of the run
            engine.scheduler.on_grant = (
                lambda _, saved=saved, engine=engine:
                saved.append(engine.kv_bytes_saved()))
            reqs, done, wall, counts, delta, replayed, _ = timed_serve(
                engine, ARCH, prompts, 32)
            engine.scheduler.on_grant = None
            rounds = sum(v["rounds"] for v in delta.values())
            prefills = sum(v["prefills"] for v in delta.values())
            if done != len(prompts) or replayed != (rounds, prefills):
                raise AssertionError(
                    f"shared-prefix {kv} {mode}: served {done}, replayed "
                    f"{replayed} of {rounds} rounds and {prefills} prefills")
            if counts["flash_attention"] != model.cfg.n_layers * prefills or \
                    counts[kernel] != model.cfg.n_layers * rounds:
                raise AssertionError(f"shared-prefix {kv} {mode}: launches "
                                     f"{counts}")
            n_tok = sum(len(r.tokens_out) for r in reqs)
            marks = [i.allocator.high_watermark
                     for i in engine.instances.values()]
            runs[mode] = dict(
                streams=[list(r.tokens_out) for r in reqs],
                hits=sum(v["shared_hits"] for v in delta.values()),
                cow=sum(v["cow"] for v in delta.values()), marks=marks,
                saved=max(saved), rate=n_tok / wall, rounds=rounds)
            if mode == "shared":
                for k in totals:
                    totals[k] += counts[k]
            log(f"shared-prefix {kv} {mode}: {done} requests, {n_tok} tokens "
                f"in {wall:.3f}s = {n_tok / wall:.1f} tokens/s (logged, not "
                f"asserted); sharing hits {runs[mode]['hits']}, COW copies "
                f"{runs[mode]['cow']}; allocator high watermark {marks} "
                f"blocks of {engine.instances[ARCH + '/0']._block_bytes} "
                f"bytes; kv_bytes_saved peak {max(saved)}; rounds {rounds} "
                f"and prefills {prefills}, all replays of the warm-up's "
                f"graphs; launches {counts}")
            del engine
        engine = deploy(model, params, ARCH, alloc, "continuous", int8=int8)
        reqs, done, _ = serve.drive(engine, ARCH, prompts, 32)
        del engine
        shared, unshared = runs["shared"], runs["unshared"]
        checks = {
            "hits as predicted": (shared["hits"], want_hits),
            "COW as predicted": (shared["cow"], want_cow),
            "high watermark as predicted": (shared["marks"], want_marks)}
        bad = {k: v for k, v in checks.items() if v[0] != v[1]}
        if (bad or not want_hits or not want_cow or unshared["hits"]
                or unshared["cow"] or not shared["saved"] > 0
                or not max(shared["marks"]) < min(unshared["marks"])):
            raise AssertionError(f"shared-prefix {kv}: {bad or checks}; "
                                 f"unshared {unshared['hits']} hits "
                                 f"{unshared['cow']} COW, marks "
                                 f"{unshared['marks']}, saved "
                                 f"{shared['saved']}")
        if not (shared["streams"] == unshared["streams"]
                == [list(r.tokens_out) for r in reqs]) or done != len(reqs):
            raise AssertionError(f"shared-prefix {kv}: streams differ from "
                                 f"the unshared paged or continuous run's")
        log(f"shared-prefix {kv}: hits {shared['hits']} and COW copies "
            f"{shared['cow']} as the host replay of the admission plan "
            f"predicts; high watermark {shared['marks']} blocks (predicted "
            f"{want_marks}) against unshared {unshared['marks']}; streams "
            f"equal the unshared paged and the continuous engines' "
            f"({len(reqs)} requests); tokens/s shared "
            f"{shared['rate']:.1f}, unshared {unshared['rate']:.1f}")
        cow_launches(model, params, alloc, prompts, int8)


def cow_launches(model, params, alloc, prompts, int8) -> None:
    """Host launch calls inside ``_cow_round`` per pass (profiler), on one
    instance (its graphs captured first) admitting an exact-duplicate pair
    and one other prompt: the COW pass pays one copy a pool leaf (2 bf16,
    4 int8), the others none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    engine = deploy(model, params, ARCH, alloc, "paged", int8=int8,
                    n_instances=1)
    warm(engine, ARCH, prompts[0])  # no capture under the profiler
    (inst,) = engine.instances.values()
    pair = prompts[2 * PAIRS[0][0]]
    for p in (pair, pair, prompts[0]):
        engine.submit(ARCH, p, max_new_tokens=4)
    cow_round = inst._cow_round

    def labelled():
        with record_function("cow_round"):
            cow_round()
    inst._cow_round = labelled
    per_pass = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            inst.run_step()
            torch.cuda.synchronize()
        events = prof.events()
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == "cow_round" and e.device_type == DeviceType.CPU]
        per_pass.append(sum(1 for e in events if e.name in LAUNCH_CALLS
                            and any(a <= e.time_range.start <= b
                                    for a, b in spans)))
    del inst._cow_round  # the wrapper holds the instance
    leaves = len(inst.cache)
    if inst.cow_count != 1 or per_pass != [leaves, 0, 0]:
        raise AssertionError(f"COW launches per pass {per_pass}, "
                             f"{inst.cow_count} copies, {leaves} leaves")
    log(f"COW launches ({'int8' if int8 else 'bf16'}): host launch calls "
        f"inside the COW step per pass {per_pass} (1 copy, one launch per "
        f"pool leaf; passes without a COW pay none)")


def migration_phase(model, params, alloc, prompts) -> None:
    """Two single-instance engines of qwen2-7b, paged with sharing and
    then continuous, each through its graphs' capture (``warm``): after
    two passes of 8 requests on one, every occupied slot is exported and
    imported into the other.  The streams must equal an unmigrated
    engine's, and the target's later rounds must be replays of its
    warm-up's graph; each run's decode kernel counted from 0."""
    from repro_torch import kernels
    from repro_torch.launch import serve

    prompts = prompts[0:16:2][:8]  # one instance's first wave, a pair in it
    for batching, kernel in (("paged", "paged_decode_attention"),
                             ("continuous", "decode_attention")):
        ref = deploy(model, params, ARCH, alloc, batching, n_instances=1)
        stayed, _, _ = serve.drive(ref, ARCH, prompts, MIGRATION_TOKENS)
        del ref
        src = deploy(model, params, ARCH, alloc, batching, n_instances=1)
        dst = deploy(model, params, ARCH, alloc, batching, n_instances=1)
        graphs = warm(dst, ARCH, prompts[0])
        warm(src, ARCH, prompts[0])
        (sid, inst), = src.instances.items()
        (tgt,) = dst.instances.values()
        reqs = [src.submit(ARCH, p, max_new_tokens=MIGRATION_TOKENS)
                for p in prompts]
        inst.run_step()
        inst.run_step()
        hits0, replays0, rounds0 = (tgt.shared_block_hits,
                                    tgt.round_graph.replays, tgt.rounds)
        moved = 0
        for slot in range(inst.max_batch):
            if inst.slots[slot] is None:
                continue
            tgt.import_slot(slot, *inst.export_slot(slot))
            inst.slots[slot] = None
            if batching == "paged":
                inst._release_paged(slot)
            moved += 1
        tgt.queue.extend(inst.queue)
        inst.queue.clear()
        src.retire(sid)
        del inst
        kernels.reset_launch_counts()
        dst.pump(budget_s=600.0)
        counts = kernels.launch_counts()
        same_graphs(dst, graphs, f"migration {batching}")
        rounds = tgt.rounds - rounds0
        if (moved != len(prompts) or src.instances or not all(
                r.done for r in reqs)
                or [r.tokens_out for r in reqs]
                != [r.tokens_out for r in stayed]
                or tgt.round_graph.replays - replays0 != rounds
                or counts[kernel] != model.cfg.n_layers * rounds):
            raise AssertionError(
                f"migration {batching}: moved {moved}, rounds {rounds}, "
                f"replays {tgt.round_graph.replays - replays0}, launches "
                f"{counts}")
        log(f"migration {batching}: {moved} slots exported after 2 passes "
            f"and imported into an instance with captured graphs; its "
            f"{rounds} later rounds all replays ({kernel} {counts[kernel]} "
            f"launches); streams equal the unmigrated engine's over "
            f"{MIGRATION_TOKENS} tokens; sharing hits on import "
            f"{tgt.shared_block_hits - hits0}")
        del src, dst, tgt


def release_phase(model, params, alloc, prompts) -> None:
    """Two paged qwen2-7b instances through their captures; the first is
    retired mid-decode and drained by the pump (it closes), then the node
    fails: after each, with ``gc.collect()`` and ``empty_cache()``, the
    reserved device memory must fall by at least the KV pool of the
    instance that went."""
    import gc
    import torch

    def reserved():
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    reserved()
    engine = deploy(model, params, ARCH, alloc, "paged")
    warm(engine, ARCH, prompts[0])
    pools = {k: sum(v.numel() * v.element_size() for v in i.cache.values())
             for k, i in engine.instances.items()}
    for p in prompts[:4]:
        engine.submit(ARCH, p, max_new_tokens=8)
    first = ARCH + "/0"
    engine.instances[first].run_step()
    r0 = reserved()
    strays = engine.retire(first, strip_queue=False)
    engine.pump(budget_s=600.0)
    if strays or first in engine.instances or engine.has_work():
        raise AssertionError("release: the retired instance did not drain")
    r1 = reserved()
    engine.fail()
    r2 = reserved()
    fell = (r0 - r1, r1 - r2)
    if not (fell[0] >= pools[first] and fell[1] >= pools[ARCH + "/1"]):
        raise AssertionError(f"release: reserved fell by {fell} bytes, KV "
                             f"pools {pools}")
    log(f"release: reserved device memory fell by {fell[0]} bytes after "
        f"retire drained and closed an instance, by {fell[1]} after the "
        f"node failed (KV pools {pools} bytes; the rest is the instances' "
        f"graph pools and transients)")


FLEET_TICKS = (0.5, 2.5, 2.5, 0.5, 0.5, 0.5)  # target rps / T of one pod
FLEET_REQUESTS = (4, 12, 12, 4, 4, 4)          # requests submitted a tick
FLEET_FAIL_TICK = 4   # node 1, which then holds the one survivor, fails
FLEET_TOKENS = 16     # new tokens a request


def instance_reserved(inst) -> int:
    """Device bytes reserved in an instance's own memory pools
    (``FunctionInstance.pool_ids``)."""
    import torch
    pools = inst.pool_ids()
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) in pools)


def host_mem_available() -> int:
    """The host's MemAvailable in bytes (Linux ``/proc/meminfo``)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def fleet_phase(model, params, totals, device="cuda") -> None:
    """The fleet above the engine, at full width: the FaST-Profiler's
    table over sm {0.25, 0.5} x quota {0.4, 0.8} (paged, 8 x 1024, the
    window sized from a measured step to hold ``STEPS_PER_WINDOW`` at
    the lowest quota),
    then a ``FunctionSpec`` from it
    reconciled by ``ControlPlane(LiveBackend(ClusterFrontend))`` over two
    nodes on the card with a ``FleetModelStore`` (host budget: one staged
    copy).  The ramp scales 1 -> 3 -> 1 instances, node 1 fails at one
    tick and the reconciler re-places; every tick submits 64-512-token
    prompts and pumps.  Fails on a dropped request, a first token that
    differs from a bare engine's prefill argmax, or a decision sequence
    that differs from the port's simulator replay.  Launch counts are
    set to 0 just before the profiler and read after the fleet's last
    pump (the bare engine's reference run is outside)."""
    import dataclasses
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.control import (ControlPlane, FunctionSpec,
                                     LiveBackend, SimBackend,
                                     decision_signature, ramp)
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.core.profiler import (STEPS_PER_WINDOW,
                                           measure_engine_profile)
    from repro_torch.core.resources import Alloc
    from repro_torch.core.workload import ServiceCurve
    from repro_torch.launch import serve
    from repro_torch.serving import ClusterFrontend, FleetModelStore

    t_phase = time.perf_counter()
    cfg, fn = model.cfg, ARCH

    def reserved():
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    reserved()
    rng = np.random.default_rng(SEED)
    ticks = [[rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
              for n in rng.integers(64, 513, k)] for k in FLEET_REQUESTS]
    kv_bytes = model.kv_cache_bytes(batching="paged", max_batch=8,
                                    max_len=1024, block_size=16,
                                    kv_int8=False)

    # -- the bare engine: the first-token reference and the measured
    # per-instance footprint beside its KV pool --------------------------
    bare = deploy(model, params, fn, Alloc(sm=1.0, quota_request=1.0,
                                           quota_limit=1.0), "paged",
                  n_instances=1)
    warm(bare, fn, ticks[0][0])
    (inst,) = bare.instances.values()
    framework = instance_reserved(inst) - kv_bytes
    ref, done, _ = serve.drive(bare, fn, [p for t in ticks for p in t],
                               FLEET_TOKENS)
    if done != sum(FLEET_REQUESTS):
        raise AssertionError(f"fleet: the bare engine served {done}")
    ref = [list(r.tokens_out) for r in ref]
    log(f"fleet: bare engine instance reserves {framework + kv_bytes} "
        f"bytes in its pools after warming every bucket: KV charge "
        f"{kv_bytes} + measured framework_bytes {framework} (the JAX "
        f"default is 67108864)")
    del bare, inst
    reserved()

    # -- the FaST-Profiler on the live instance --------------------------
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    points = measure_engine_profile(
        model, params, spatial=(0.25, 0.5), temporal=(0.4, 0.8),
        max_batch=8, max_len=1024, batching="paged", prompt_len=256,
        new_tokens=FLEET_TOKENS, window=0.2, n_windows=3,
        kv_budget_bytes=kv_bytes,
        kv_block_bytes=model.kv_block_bytes(16, False), device=device)
    log(f"fleet: profile (8 requests of 256 + {FLEET_TOKENS} tokens a "
        f"step, paged, 3 windows of at least {STEPS_PER_WINDOW} steps at "
        f"the lowest quota) in {time.perf_counter() - t0:.1f}s:")
    for p in points:
        log(f"fleet: profile sm={p.sm:.2f} quota={p.quota:.1f} "
            f"T={p.throughput:.3f} req/s p99={p.p99_latency:.4f}s "
            f"kv_blocks={p.kv_blocks}")
    by = {(p.sm, p.quota): p for p in points}
    for sm in (0.25, 0.5):
        log(f"fleet: profile sm={sm}: T(quota 0.8) / T(quota 0.4) = "
            f"{by[sm, 0.8].throughput / by[sm, 0.4].throughput:.3f} "
            f"(temporal proportionality would give 2)")
    if any(p.throughput <= 0 or p.kv_blocks != 512 for p in points):
        raise AssertionError(f"fleet: profile {points}")

    # -- the fleet -----------------------------------------------------------
    # The scheduler's point: sm 0.5 x quota 0.8 fills a node with two
    # rectangles, so three instances span both nodes.  (The SM share is
    # accounting only on the card: sm 0.25's row measures the same
    # device and would win RPR by its rectangle alone.)
    point = by[0.5, 0.8]
    t_pod = point.throughput
    wbytes = pytree_nbytes(params)
    free, total = torch.cuda.mem_get_info()
    mem_bytes = free // 2
    spec = FunctionSpec(
        name=fn, profile=(point,), target_rps=ramp(
            [(float(i), r * t_pod) for i, r in enumerate(FLEET_TICKS)]),
        headroom=1.0, min_instances=1, max_instances=3,
        model_factory=lambda: (model, params), max_batch=8, max_len=1024,
        batching="paged", block_size=16, framework_bytes=framework,
        curve=ServiceCurve(name=fn, r_max=t_pod, sm_sat=0.5, p=1.0,
                           weight_bytes=wbytes,
                           framework_bytes=framework + kv_bytes))
    alg1 = dataclasses.replace(spec, profile=tuple(points)).best_point()
    log(f"fleet: Alg. 1 over the whole table would take (sm={alg1.sm}, "
        f"quota={alg1.quota}) at RPR {alg1.rpr:.3f}; the spec takes "
        f"(sm={point.sm}, quota={point.quota}) at RPR {point.rpr:.3f} by "
        f"hand, so that three instances span both nodes")
    store = FleetModelStore(host_budget_bytes=wbytes * 3 // 2)
    fe = ClusterFrontend(n_nodes=2, mem_bytes=mem_bytes, window=0.2,
                         model_store=store, device=device)
    pinned = 2 * (1 << (wbytes - 1).bit_length())
    avail = host_mem_available()
    log(f"fleet: card free {free} of {total} bytes, mem_bytes {mem_bytes} "
        f"a node; host MemAvailable {avail} bytes, about to pin up to "
        f"{pinned} (the cold stage and one peer copy of {wbytes} weight "
        f"bytes, each in one power-of-two pinned block)")
    if avail < pinned + (8 << 30):
        raise AssertionError(f"fleet: the host cannot pin {pinned} bytes "
                             f"({avail} available)")
    live = ControlPlane(LiveBackend(fe))
    reqs, tokens, pump_s, charges, returned = [], 0, 0.0, {}, {}

    def pump() -> float:
        nonlocal pump_s
        t0 = time.perf_counter()
        fe.pump(budget_s=600.0)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        pump_s += took
        if fe.has_work():
            raise AssertionError("fleet: the pump left work behind")
        return took

    def submit(prompts):
        reqs.extend(fe.submit(fn, p, max_new_tokens=FLEET_TOKENS)
                    for p in prompts)

    live.register(spec)
    for tick, prompts in enumerate(ticks):
        if tick == FLEET_FAIL_TICK:
            submit(prompts)
            for _ in range(3):
                fe.pump(budget_s=0.01)  # a few passes: mid-decode
            if fe.nodes_for(fn) != [1] or not fe.inflight(fn):
                raise AssertionError(f"fleet: before the failure: nodes "
                                     f"{fe.nodes_for(fn)}, inflight "
                                     f"{fe.inflight(fn)}")
            r0 = reserved()
            lost = fe.fail_node(1)
            returned["fail_node(1)"] = r0 - reserved()
            log(f"fleet: t={tick} fail_node(1): {lost} instance lost, "
                f"{len(fe._pending.get(fn, []))} requests parked")
        if tick == 3:
            r0 = reserved()
        live.reconcile(now=float(tick))
        if tick == 3:
            returned["scale-down"] = r0 - reserved()
        if tick != FLEET_FAIL_TICK:
            submit(prompts)
        took = pump()
        fe.cold_start_events()  # TTFTs resolve while their instances live
        if tick == 2:  # the fleet at its peak, every instance warm
            # (a comprehension: no variable outlives it to hold an
            # instance, and its weights, past the instance's node)
            charges = {f"{node}:{k}": (framework + kv_bytes,
                                       instance_reserved(inst))
                       for node, eng in enumerate(fe.engines)
                       for k, inst in eng.instances.items()}
            for node, eng in enumerate(fe.engines):
                if eng.memory_bytes() > mem_bytes:
                    raise AssertionError(f"fleet: node {node} holds "
                                         f"{eng.memory_bytes()} bytes")
        nodes = [sorted(k for k in eng.instances) for eng in fe.engines]
        captures = sum(v["captures"] + v["prefill_captures"]
                       for eng in fe.engines
                       for v in eng.telemetry().values())
        log(f"fleet: t={tick} target {FLEET_TICKS[tick]:.1f} T = "
            f"{FLEET_TICKS[tick] * t_pod:.3f} req/s, instances "
            f"{live.instances(fn)}, placements per node {nodes}, weights "
            f"on the card {fe.memory_bytes()} bytes; {len(prompts)} "
            f"requests pumped in {took:.3f}s, graph captures so far by "
            f"the live instances {captures}")
    counts = kernels.launch_counts()
    used = {"flash_attention", "paged_decode_attention"}
    if any(counts[k] == 0 for k in used) or any(
            counts[k] for k in counts if k not in used):
        raise AssertionError(f"fleet: kernel launches {counts}")
    for k in totals:
        totals[k] += counts[k]
    log(f"fleet: kernel launches (profiler and fleet) {counts}")

    # -- checks ----------------------------------------------------------------
    dropped = [r for r in reqs if not r.done or r.outcome is not None
               or len(r.tokens_out) != FLEET_TOKENS]
    if dropped or fe.shed or fe.lost or fe.rejected:
        raise AssertionError(f"fleet: {len(dropped)} requests dropped "
                             f"(shed {fe.shed}, lost {fe.lost}, rejected "
                             f"{fe.rejected})")
    firsts = sum(r.tokens_out[0] == want[0] for r, want in zip(reqs, ref))
    if firsts != len(reqs):
        raise AssertionError(f"fleet: {len(reqs) - firsts} first tokens "
                             f"differ from the bare engine's")
    same = sum(list(r.tokens_out) == want for r, want in zip(reqs, ref))
    for d in live.log:
        log(f"fleet: decision {'up' if d.direction > 0 else 'down'} at "
            f"(sm={d.point.sm}, quota={d.point.quota}) pod {d.pod_id}")
    cluster = Cluster(n_nodes=2, sharing=True, mem_bytes=mem_bytes)
    sim = ControlPlane(SimBackend(cluster))
    sim.register(spec)
    for tick in range(len(ticks)):
        if tick == FLEET_FAIL_TICK:
            cluster.fail_node(1)
        sim.reconcile(now=float(tick))
    got, want = decision_signature(live.log), decision_signature(sim.log)
    if got != want or not got:
        raise AssertionError(f"fleet: live decisions {got} != the "
                             f"simulator's {want}")
    for e in fe.cold_start_events():
        log(f"fleet: cold start node {e.node} tier {e.tier} ({e.mode}"
            f"{'' if e.peer is None else f', from node {e.peer}'}): "
            f"{e.nbytes} bytes, upload call {e.upload_s:.4f}s, TTFT "
            f"{'none' if e.ttft_s is None else f'{e.ttft_s:.3f}s'}")
    for handle, (charge, measured) in charges.items():
        log(f"fleet: instance {handle}: admission charge {charge} bytes "
            f"(framework {framework} + KV {kv_bytes}), reserved in its "
            f"pools {measured} bytes, gap {measured - charge}")
    n_tok = sum(len(r.tokens_out) for r in reqs)
    log(f"fleet: {len(reqs)} requests, {n_tok} tokens in {pump_s:.3f}s of "
        f"pumping = {n_tok / pump_s:.1f} tokens/s; zero dropped; first "
        f"tokens equal the bare engine's prefill argmax {firsts}/"
        f"{len(reqs)}; whole greedy streams equal the bare engine's "
        f"{same}/{len(reqs)} (logged, not asserted: other batches); "
        f"reserved bytes returned {returned}; decision_signature equals "
        f"the simulator replay's ({len(got)} decisions); store "
        f"{store.telemetry()}; phase {time.perf_counter() - t_phase:.1f}s")
    del fe, live, store, reqs
    reserved()
    torch._C._host_emptyCache()  # the pinned staging buffers


def profile_window(model, params, prompts, alloc, arch=ARCH,
                   batching="paged") -> None:
    """Where a serve pass spends its time: device time by kernel (the
    copy kernels, casts included, also summed), the device's busy share of
    the wall time, and the host's launch calls a decode round and an
    admission make (a graph replay is one, an admission's argument copy
    one more), from ``torch.profiler`` over 8 requests x 8 tokens on one
    instance (after a warm-up that captures its round and, dense, its
    prefill buckets).  Runs on an engine without graphs too
    (``--windows``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch import serve

    engine = deploy(model, params, arch, alloc, batching, n_instances=1)
    graphs = warm(engine, arch, prompts[0])
    replayed0 = same_graphs(engine, graphs, arch)
    (inst,) = engine.instances.values()
    cls = type(inst)
    # ``_admit`` spans a pass's admissions, in older checkouts too.
    plain = {name: getattr(cls, name) for name in LABELS}

    def labelled(name):
        def run(self, *args):
            with record_function(LABELS[name]):
                return plain[name](self, *args)
        return run

    rounds0, prefills0 = inst.rounds, inst.prefills
    torch.cuda.synchronize()
    for name in LABELS:
        setattr(cls, name, labelled(name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, wall = serve.drive(engine, arch, prompts, 8)
            torch.cuda.synchronize()
    finally:
        for name, fn in plain.items():
            setattr(cls, name, fn)
    rounds, prefills = inst.rounds - rounds0, inst.prefills - prefills0
    replayed = [b - a for a, b in zip(replayed0,
                                      same_graphs(engine, graphs, arch))]
    from torch.autograd import DeviceType

    events = prof.events()
    calls = [e.time_range.start for e in events if e.name in LAUNCH_CALLS]
    inside = {}
    for label in LABELS.values():
        # The label's host spans (the profiler mirrors it on the device's
        # timeline too, as an annotation kept out of every count here).
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in events if e.name == label
                       and e.device_type == DeviceType.CPU)
        starts = [s for s, _ in spans]
        n = 0
        for t in calls:
            i = bisect.bisect_right(starts, t) - 1
            n += i >= 0 and t <= spans[i][1]
        inside[label] = (n, len(spans))
    (in_rounds, n_spans), (in_admit, _) = (inside["decode_round"],
                                           inside["admission"])
    launch_text = (f"host launch calls {len(calls)}, in rounds "
                   f"{in_rounds} = {in_rounds / max(n_spans, 1):.1f} per "
                   f"round, in admissions {in_admit} = "
                   f"{in_admit / max(prefills, 1):.1f} per prefill"
                   if calls else
                   "host launch calls not measured (no runtime events)")
    # Device-side (kernel) events only: the CPU-side op events carry the
    # same device time again as their children's.
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0
            and e.key not in LABELS.values()]
    log(f"profile {arch}: rounds {rounds} ({n_spans} profiled), replayed "
        f"{replayed[0]}; prefills {prefills}, replayed {replayed[1]}; "
        f"{launch_text}")
    if not rows:
        log("profile: the profiler recorded no device time (not measured)")
        return
    busy_us = sum(t for t, _, _ in rows)
    groups = {"port kernels": 0.0, "cuBLAS matmuls": 0.0,
              "other torch kernels": 0.0}
    for t, _, key in rows:
        if _port_name(key):
            groups["port kernels"] += t
        elif any(k in key for k in ("nvjet", "gemm", "cutlass", "xmma")):
            groups["cuBLAS matmuls"] += t
        else:
            groups["other torch kernels"] += t
    log(f"profile {arch}: 8 requests x 8 tokens, {batching}, 1 instance: "
        f"wall {wall * 1e3:.1f} ms (profiler on), device busy "
        f"{busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.3f} of wall, "
        f"{sum(n for _, n, _ in rows)} kernel launches")
    for name, t in groups.items():
        log(f"profile: {t / 1e3:9.3f} ms  {name}")
    port = {}
    for t, n, key in rows:
        name = _port_name(key)
        if name:
            pt, pn = port.get(name, (0.0, 0))
            port[name] = (pt + t / 1e3, pn + n)
    log("profile: port kernels by name: " + "; ".join(
        f"{name} {t:.3f} ms over {n} launches"
        for name, (t, n) in sorted(port.items())))
    copies = [(t, n, key) for t, n, key in rows
              if "copy" in key.lower() or "memcpy" in key.lower()]
    memcpy = [(t, n) for t, n, key in copies if "memcpy" in key.lower()]
    log(f"profile {arch}: copy kernels (casts and copies): "
        f"{sum(n for _, n, _ in copies)} launches, "
        f"{sum(t for t, _, _ in copies) / 1e3:.3f} ms, of which memcpy "
        f"{sum(n for _, n in memcpy)} launches, "
        f"{sum(t for t, _ in memcpy) / 1e3:.3f} ms; by kernel: "
        + "; ".join(f"{n} x {key[:70]} {t / 1e3:.3f} ms"
                    for t, n, key in sorted(copies, reverse=True)))
    for t, n, key in sorted(rows, reverse=True)[:10]:
        log(f"profile: {t / 1e3:9.3f} ms  {n:6d} calls  {key[:90]}")


TENSOR_CORE_KERNELS = ("flash_kernel", "decode_bf16_kernel",
                       "paged_decode_bf16_kernel", "decode_q8_kernel",
                       "paged_decode_q8_kernel")
KERNEL_NAMES = TENSOR_CORE_KERNELS + ("combine_kernel", "wkv6_kernel",
                                      "wkv6_chunked_kernel",
                                      "ssm_scan_kernel",
                                      "ssm_chunked_kernel")


def step_kernel_builds() -> list[str]:
    """The scan's step kernel at each state size: it must not spill
    either."""
    from repro_torch.kernels.ssm_scan import STATE_SIZES
    return [f"ssm_scan_kernel<{n}>" for n in STATE_SIZES]


def tensor_core_builds() -> list[str]:
    """Every built kernel that must run on the tensor cores without
    spilling: the attention kernels at each head dim, chunked WKV-6, and
    the chunked scan at each state size."""
    from repro_torch.kernels.build import HEAD_DIMS
    from repro_torch.kernels.ssm_scan import STATE_SIZES
    return [f"{k}<{d}>" for k in TENSOR_CORE_KERNELS for d in HEAD_DIMS] \
        + ["wkv6_chunked_kernel"] \
        + [f"ssm_chunked_kernel<{n}>" for n in STATE_SIZES]


def _short(mangled: str) -> str:
    """A kernel's readable name (with D) from its mangled one, where an
    identifier is written as its length and its characters."""
    import re
    for name in KERNEL_NAMES:
        tag = f"{len(name)}{name}"
        i = mangled.find(tag)
        if i >= 0:
            m = re.match(r"ILi(\d+)E", mangled[i + len(tag):])
            return f"{name}<{m.group(1)}>" if m else name
    return mangled[:60]


def ptxas_report(text: str) -> None:
    """Registers, shared memory and spills of every kernel, from the
    ``-Xptxas -v`` report the build keeps; the tensor-core kernels
    (``tensor_core_builds``) and the step kernel must not spill."""
    import re
    name, spills = None, {}
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _short(m.group(1))
        elif name and ("spill" in line or "Used" in line):
            log(f"ptxas {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills[name] = int(m.group(1)) + int(m.group(2))
    for name in tensor_core_builds() + step_kernel_builds():
        if name not in spills:
            raise AssertionError(f"{name}: not in the ptxas report")
        if spills[name]:
            raise AssertionError(f"{name} spills {spills[name]} bytes")


def hmma_report(lib) -> None:
    """Tensor-core instructions (HMMA) in the SASS of each kernel, by the
    toolkit's cuobjdump; the tensor-core kernels (``tensor_core_builds``)
    must hold some, and the step kernel passes ``step_kernel_sass``."""
    import re
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        raise AssertionError(f"{tool} not found: the SASS checks cannot "
                             f"run")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, lines, name = {}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _short(m.group(1))
            counts[name], lines[name] = 0, []
        elif name:
            counts[name] += "HMMA" in line
            lines[name].append(line)
    log(f"SASS HMMA instructions per kernel: {counts}")
    for name in tensor_core_builds():
        if counts.get(name, 0) == 0:
            raise AssertionError(f"{name} has no HMMA instruction in its "
                                 f"SASS")
    for name in step_kernel_builds():
        step_kernel_sass(name, lines.get(name, []))


def step_kernel_sass(name: str, lines: list[str]) -> None:
    """The step kernel moves the state in one 16-byte load and one 16-byte
    store a thread, reads it by a coherent load (its state may be written
    in place, so never through the non-coherent path, ``.CONSTANT``), and
    has no barrier and no shared memory."""
    import re
    ops = [m.group(1) for line in lines
           for m in [re.search(r"\b((?:LDG|STG|LDS|STS|BAR)\S*)", line)] if m]
    wide_loads = [op for op in ops if op.startswith("LDG") and ".128" in op]
    wide_stores = [op for op in ops if op.startswith("STG") and ".128" in op]
    shared = [op for op in ops if op.startswith(("LDS", "STS", "BAR"))]
    log(f"SASS {name}: 16-byte loads {wide_loads}, 16-byte stores "
        f"{wide_stores}, shared memory and barriers {shared}")
    if len(wide_loads) != 1 or len(wide_stores) != 1 or shared or any(
            "CONSTANT" in op for op in wide_loads):
        raise AssertionError(f"{name}: the state is not moved by one "
                             f"coherent 16-byte load and store, or the "
                             f"kernel stages through shared memory")


def windows_phase(checkout: Path) -> None:
    """``--windows CHECKOUT``: only the serve runs' tokens/s (the serve
    phase's six modes and request mix, each through ``timed_serve``) and
    the three profile windows, with ``src/repro_torch`` of CHECKOUT; an
    older checkout, without round graphs, serves eagerly.  Run it on two
    checkouts in turns (parent, change, change, parent) in one call to
    compare them."""
    import gc
    import torch
    from repro_torch.core.resources import Alloc
    from repro_torch.launch import serve

    log(f"windows of {checkout}")
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, 16)
    alloc = Alloc(sm=0.5, quota_request=0.5, quota_limit=1.0)
    for arch, modes, window in (
            (ARCH, ("continuous", "paged", "int8 continuous", "int8 paged"),
             "paged"),
            (RWKV_ARCH, ("continuous",), "continuous"),
            (HYBRID_ARCH, ("continuous",), "continuous")):
        model, params = serve.init_model(arch, reduced=False, seed=SEED)
        prompts = [rng.integers(0, model.cfg.vocab_size, int(n)).astype(
            np.int32) for n in lens]
        for mode in modes:
            engine = deploy(model, params, arch, alloc, mode.split()[-1],
                            int8=mode.startswith("int8"))
            reqs, done, wall, _, delta, (replayed, pre_replayed), peak = \
                timed_serve(engine, arch, prompts, 32)
            passes = sum(v["steps"] for v in delta.values())
            syncs = sum(v["syncs"] for v in delta.values())
            n_tok = sum(len(r.tokens_out) for r in reqs)
            if done != len(prompts) or syncs != passes:
                raise AssertionError(f"windows {arch} {mode}: served {done}, "
                                     f"syncs {syncs}, passes {passes}")
            log(f"windows {arch} {mode}: {n_tok} tokens in {wall:.3f}s = "
                f"{n_tok / wall:.1f} tokens/s; passes {passes}, rounds "
                f"{sum(v['rounds'] for v in delta.values())}, replayed "
                f"{replayed}; prefills "
                f"{sum(v['prefills'] for v in delta.values())}, replayed "
                f"{pre_replayed}; peak device memory allocated {peak[0]}, "
                f"reserved {peak[1]} bytes")
            del engine
        profile_window(model, params, prompts[:8], alloc, arch, window)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", metavar="CHECKOUT", type=Path,
                    help="only the serve runs' tokens/s and the profile "
                         "windows, with src/repro_torch of CHECKOUT")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: no CUDA device", file=sys.stderr)
        return 2
    src = (args.windows or ROOT).resolve() / "src"
    sys.path.insert(0, str(src))
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"[chip_smoke] FAIL: {src}/repro_torch not found",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    if args.windows:
        windows_phase(args.windows.resolve())
        return 0
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s: {lib}")
    ptxas_report((lib.parent / "ptxas.log").read_text())
    hmma_report(lib)
    rng = np.random.default_rng(SEED)
    results = kernel_phase(rng)
    reference_phase(rng)
    reduced_serve()
    launches = serve_phase(rng)
    extra = ("shape", "device_ms", "library_device_ms")  # logged above
    listing = [dict(name=name, launches=launches[name],
                    **{k: v for k, v in r.items() if k not in extra})
               for name, r in results.items()]
    print(json.dumps({"kernels": listing}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
