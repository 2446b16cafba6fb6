#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, logs each
kernel's registers and spills from the ptxas report and, by the
toolkit's ``cuobjdump`` (the smoke fails without it), the tensor-core
instructions in each kernel's SASS (HGMMA, the warpgroup products, in
flash; HMMA, mma.sync's, in the others), failing if flash or any decode
kernel, at any head dim they are built for (16, 32, 64, 128), chunked
WKV-6 or the chunked selective scan (N = 16 and 8) holds none of its
kind or spills, if flash or any decode kernel holds no TMA load
(UTMALDG), or if the scan's
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
   beside SDPA; bf16 and int8 dense and paged decode one kernel a call;
   bf16
   paged decode at pages of 8, 16 and 32 rows and int8 at 8, 16, 32 and
   64, bit-equal to dense, and blind to NaN in pages no table entry
   names; all four decode kernels also
   at starcoder2-15b's 12 query heads per kv head; flash at gemma3-27b's
   prefill geometry (1920 rows, 32 query heads over 16 kv heads of 128,
   its window of 1024 and none), at starcoder2-15b's (512 rows, 48
   over 4) and at mixtral-8x7b's past its window (4160 rows, 32 over 8,
   window 4096; V of the 64 keys its last rows leave out set to
   ``WINDOW_V``, so that each of rows 4096-4159 must lie within the
   tolerance of the windowed plain version and outside it of the
   windowless one), and bf16 dense decode at starcoder2's round (G = 12) and at
   gemma3's global layers (G = 2, S = 2048), each timed beside SDPA and
   the bound; flash with ``causal=False`` at seamless-m4t-large-v2's
   encoder (1024 rows, 16 heads of 64) and cross prefill (512 over 1024
   rows) and at llama-3.2-vision-11b's cross prefill (512 over 1600 rows,
   32 q / 8 kv of 128), and the decode kernel with every row at
   ``cache_len = S`` (S=1024, G=1, D=64; S=1600, G=4, D=128), each timed
   beside SDPA with no mask; flash and the four
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
   run prefill and decode, and so do a 2-layer GELU model with biases and
   starcoder2-15b's heads (48 q / 4 kv of 128; bf16 and int8, dense and
   paged) and a 6-layer GeGLU model on dual caches with gemma3-27b's
   heads (32 q / 16 kv of 128, q_dim != d_model, tied and scaled
   embeddings, 5 local layers of window 64 and 1 global; a 150-token
   prompt), on the card through
   the kernels, against the same weights in f32 on the CPU through the
   plain versions; a 2-layer MoE model of qwen2-moe-a2.7b's widths (60
   experts top-4 of d_ff 1408, 4 shared, an f32 router) has its expert
   block held layer by layer from identical inputs (routing equal where
   the top-k gate margin exceeds 1e-4, outputs within 2e-2 where routing
   agrees, ``dest``/``keep`` equal at an overflowing 512-token shape), and
   so has a 2-layer model of mixtral-8x7b's widths (8 experts of d_ff
   14336 top-2, window 4096, decoding on its rolled cache); a
   2 + 2-layer encoder-decoder at seamless-m4t-large-v2's widths (a
   1024-frame context) and one vision group (2 self + 1 gated cross
   layer) at llama-3.2-vision-11b's heads (a 1600-row context), gates,
   norms and biases filled, run prefill and 8 decode steps against f32 on
   the CPU;
   then ``serve.main --reduced`` serves qwen2-7b's, starcoder2-15b's,
   gemma3-27b's and hymba-1.5b's reduced configs (head dim 16) on the
   card, and qwen2-moe-a2.7b's and mixtral-8x7b's (24-token prompts, past
   mixtral's window of 16), and seamless-m4t-large-v2's and
   llama-3.2-vision-11b's reduced configs through ``ContextLoop``, the
   model-level continuous loop those families are served by (their
   prefill needs a context, which no engine request carries);
3. serve phase — full-width qwen2-7b (28 layers, d=3584; random bf16
   weights from a seed) on one ``ServingEngine``, two instances sharing
   one weight copy, continuous then paged (block size 16), with bf16 and
   then with int8 KV, 16 requests of 64-512 prompt tokens and 32 new
   tokens each; then, after phases 4-6 on qwen2-7b and with it freed,
   full-width starcoder2-15b (40 layers, d=6144, GELU
   with biases) in the same four modes on the same mix; then full-width
   gemma3-27b (62 layers, d=5376, 52 local layers of window 1024 and 10
   global on dual caches) continuous at ``max_len=2048``, 8 prompts of
   64-512 and 8 of 1100-1900 tokens, with its param count and slot-pool
   bytes against the constants reckoned from JAX's layout, one round
   replayed == the eager round bit for bit (tokens, positions, rolled and
   global leaves), the round's and the rolled decode attention's device
   time, and a sampled check; then full-width qwen2-moe-a2.7b (24
   layers, d=2048, 60 routed experts top-4 and 4 shared) in qwen2-7b's
   four modes with its params, weight bytes and slot-pool bytes against
   JAX's, one round replayed == eager, the round's device time beside the
   bytes of every weight it reads, of the experts and of the active
   weights, split into the expert FFN, the dispatch and the rest, a
   profile window, speculation (the 2-layer draft of views against an
   agreeing target, whose routed and shared ``w_down`` of layers 2-23 are
   zeroed, and the unmodified one) and sampled checks, continuous and
   paged; then mixtral-8x7b's full widths (d=4096, 8 experts of d_ff
   14336 top-2, window 4096) at 8 of its 32 layers, whose 93.4 GB no
   card holds (its sizes reckoned on the meta device against JAX's):
   continuous on two instances, one round replayed == eager with its
   split, a profile window, one instance at ``max_len=4352`` serving two
   4160-token prompts past the window against the plain versions on the
   card, and 1-, 2- and 4-member pods (``mixtral_phase``; all 32 layers
   as a pod over two cards: ``scripts/mixtral_pod_cards.py``); then
   full-width seamless-m4t-large-v2 (24 encoder and 24
   decoder layers, d=1024) and llama-3.2-vision-11b (40 self layers and
   8 gated cross layers, d=4096) through ``ContextLoop``: 16 requests of
   the mix, each with its own random context, 32 tokens each on 8 slots,
   every round a graph replay, with their params and slot-pool bytes
   against JAX's, each first token the greedy pick of its prefill, one
   round replayed == eager bit for bit (tokens, positions, ``k``, ``v``,
   ``cross_k``, ``cross_v``), the round's device time beside the bytes
   it reads, prefill ms by length, two requests alone at batch 1 against
   the pool's streams and a profile window; then full-width rwkv6-1.6b
   (24 layers, d=2048) and
   full-width hymba-1.5b (32 layers, d=1600, 128 meta tokens, window
   1024) continuous with the same mix.  Each instance's fused decode
   round is a CUDA graph (``serving/graphs.py``), and so is each of its
   dense full-cache admissions, one graph per prompt bucket (64, 128, 256,
   512);
   all are captured in a warm-up before the run (two admissions of every
   bucket per instance) and replayed in every round and every bucketed
   admission of it, never captured again (gemma3, rwkv6 and hymba prefill
   eagerly, at the exact length); a ``fused=False`` engine (the
   host-argmax reference, eager) must give the same greedy streams on the
   same prompts, one qwen2-7b paged decode step replayed over a copy of
   the pools must equal the eager ``decode_step_paged`` bit for bit
   (logits, pools), as must the instance's own replayed round (tokens,
   positions, pools), and in each qwen2-7b and starcoder2-15b mode a
   replayed admission must
   equal the eager admission body bit for bit (logits, pools, slot and
   pending tokens).  Launch counts are set to 0 just before each mode and
   read just after it, and each phase logs its seconds.  Each model's
   profile window logs its wall, device
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
   and the reserved bytes returned at scale-down and at the failure;
6. speculation and sampling phase — qwen2-7b at full width speculating
   with k = 4 (two weight-shared instances, the serve mix, continuous
   then paged) against two 2-layer drafts whose leaves are views of the
   target's: with a target whose layers 2-27 add nothing (copies of
   ``layers/attn/wo`` and ``layers/mlp/w_down`` zeroed past layer 1),
   which the draft agrees with, and with the unmodified target, which it
   does not; beside a spec-off run of the first.  Every timed round and
   admission is a replay, one sync a pass, exactly 32 tokens a request,
   flash launched (28 + 2) times a prefill and the decode kernel 2 x 5
   times a round (the draft's steps; the verify attention is plain
   torch), the agreeing acceptance above the disagreeing one; one round
   replayed over copies of the state equals the eager round body bit for
   bit (out, n_emit, slot tokens, positions, key, target and draft
   pools), and ``verify_step``'s logits at every window position are
   within ``REF_TOL`` of 5 sequential ``decode_step`` logits.  It logs
   acceptances, tokens per verify round, tokens/s of the three runs, how
   many greedy streams equal spec-off ones, the verify attention's device
   time a round and a profile window of the agreeing runs.  Then sampled
   runs (temperature 0.8, top-k 50, top-p 0.9, seed 5; 4 requests each):
   qwen2-7b continuous and paged here, rwkv6-1.6b and hymba-1.5b after
   their serve modes, each through the graphs equal to a ``fused=False``
   engine bit for bit, one sync a pass;
7. sharded pods phase — qwen2-7b's full widths at ``POD_LAYERS`` = 7 of
   its 28 layers through
   ``ClusterFrontend(n_nodes=4)`` with a ``FleetModelStore`` (the weights
   staged once; a pod's members on one card share one upload of each
   leaf and take their slices from it on the card) as
   one instance and as 2- and 4-member pods whose members share the card
   (and, on a machine with two cards or more, a 2-member pod spanning
   two, which runs eagerly), 16 requests x 32 tokens, continuous and
   then paged (16-row pages; one page table for every member, each
   holding its kv heads of every page): every timed round and admission
   a replay,
   each kernel launched once a layer, member and prefill or round, first
   tokens equal to one instance's (a bf16 token may flip only where the
   one-instance logits' top two lie within twice the pod's deviation
   from them or two bf16 steps of each other), a round's logits over 8
   live slots (fed one instance's tokens; paged, over 8 slots' pages)
   within ``REF_TOL`` of one instance's of the same batching, one
   replayed round equal to its eager body bit for bit (tokens, every
   member's ``k`` and ``v`` and, continuous, ``pos``; paged, every
   member's pages and the page tables, positions and active mask);
   per-member weight and KV bytes beside one instance's, tokens/s, a
   replayed round's device time, kernels and host launch calls; after
   the continuous 2-member pod, a secondary member fails and the
   stranded request finishes on a one-instance replacement with the
   one-instance stream.  Then the same runs from int8 KV (no failure):
   the int8 dense and paged kernels once a layer, member and round.
   After the gemma3-27b phase its widths at 12 of its 62 layers (10
   local and 2 global; staged on the host, the full tree freed) serve
   the gemma3 phase's 16 prompts (8 past the window), continuous at
   ``max_len=2048``, and after the qwen2-moe-a2.7b phase its widths at 6
   of its 24 layers serve the mix continuous and paged, each on one
   instance and as
   2- and 4-member pods held as above (the replayed round over every
   member's rolled, global, int8 or paged leaves; the decode kernel on
   gemma3's global layers only), and after their serve modes rwkv6-1.6b
   (its 32-head state split by head at 2 and 4 members) and hymba-1.5b
   (its pools whole on every member: 5 kv and 25 SSM heads divide
   neither) serve the mix continuous on one instance and as 2- and
   4-member pods, each member's weight and state bytes equal to JAX's
   ``per_device_bytes``, chunked WKV-6 (rwkv) or windowed flash and the
   chunked scan (hymba) once a layer a member at each prefill, step
   WKV-6 or the step scan once a layer a member each round, the
   replayed round over every member's ``wkv``, ``tm_x``, ``cm_x`` or
   ``k``, ``v``, ``ssm``; each member's weight bytes below one
   instance's, and for the moe
   pods every member routing every token-layer of the prefills and a
   round to the same experts, equal to one instance's wherever its
   top-k gate margin exceeds 1e-4 (a member's decode kernels split S as
   one device's: ``member_split_check`` in the kernel phase holds each
   member's heads to the whole launch's bit for bit).  Before it, the
   reduced configs (qwen2-7b's smoke cut, head dim 16, bf16 and int8
   KV; a 2-layer model of qwen2-7b's heads, 7 q over 1 kv of 128, whose
   kv head does not divide a pod; gemma3-27b's and mixtral-8x7b's cuts
   on their windowed caches, continuous; qwen2-moe-a2.7b's) serve the
   same greedy and sampled streams at 1, 2 and 4 members, continuous
   and paged, and so do rwkv6-1.6b's and hymba-1.5b's cuts and a hymba
   cut with 5 q over 1 kv head at d=80, continuous, with bf16 weights
   (the attention kernels take bf16 only;
   the check holds exactly because at these shapes cuBLAS's products
   over a member's columns came out bit-equal to the full product's,
   ``scripts/pod_exactness_probe.py``).  The kernel phase holds
   flash, dense and paged decode at the members' geometries (14 q over 2
   kv heads, 7 over 1, of 128), int8 decode at 14 over 2, windowed flash
   at a 4-member gemma3-27b pod's (8 over 4, window 1024), decode at
   a 4-member qwen2-moe-a2.7b pod's (4 over 4) and both WKV-6 kernels at
   a 2- and a 4-member rwkv6-1.6b pod's (16 and 8 heads of 64), and
   holds each member's heads of flash (14/2 and 7/1 of 28/4 at 512
   rows; 16/8 and 8/4 of 32/16 at 1920 rows, window 1024), the four
   decode kernels, both WKV-6 kernels and both scan kernels to the whole
   launch's bit for bit;
8. training phase (last) — the autograd Functions of flash, WKV-6 and the
   selective scan (kernel forward, plain backward) at the trained shapes:
   their input gradients against autograd of the plain versions on the
   card within 2e-2 (flash causal at qwen2-7b's 4 x 512 rows, windowed
   at hymba's 4 x 640 with windows 1024 and 33, not causal at seamless's
   encoder, 4 x 1024 frames; WKV-6 at rwkv6-1.6b's 4 x 512, 4 x 16 and
   4 x 1 tokens; the scan at hymba's 4 x 640 rows, N = 16), each beside
   its kernel forward's, plain backward's and (flash) SDPA's forward +
   backward time and the bound for forward + backward; a 2-layer model
   of qwen2-7b's heads (28 q / 4 kv of 128, qkv bias) whose step-0 loss
   and every leaf's gradient on the card are held against the same
   weights in f32 on the CPU; then qwen2-7b's widths (d=3584, d_ff 18944,
   V=152064) with the depth cut to the most layers whose training state
   fits the card (``train_layers``), rwkv6-1.6b and hymba-1.5b whole,
   random bf16 weights from the seed: the step-0 loss and ``grad_norm``
   through the kernels against the plain path on the card within 2e-2
   (rwkv6's norm logged only: its gradient at random weights amplifies
   rounding about 1e9-fold; a witness holds its backward instead:
   ``Wkv6ScanFn`` at the model's first and last layers' own inputs
   against the loop, and in f64 the chunked algorithm against the loop
   over the first ``WITNESS_LAYERS`` layers, every leaf), then 5 steps
   of 4 x 512
   tokens of the training stream with remat and bf16 gradients, the
   counts of that run (each family's kernels must run), steps/s,
   tokens/s, peak memory and a profiled step's device time split into
   the forward kernels, the plain backward, the update, the matmuls and
   the rest; last ``launch.train --preset 100m --steps 300``, whose mean
   loss over the last 5 steps must fall below 0.8 of the first 5's.

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero, and so does a machine without a card.

Usage:  python3 chip_smoke.py
        python3 chip_smoke.py --witness-layers 24  (the f64 witness over
                                                    all of rwkv6's layers)
        python3 chip_smoke.py --windows CHECKOUT   (see ``windows_phase``)
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# The card's dense bf16 FLOP/s and HBM bytes/s: read from the port's
# ``launch/mesh.py`` (the H100 SXM data sheet) by ``load_rates`` once the
# port is on the path.
PEAK_FLOPS = PEAK_BYTES = None
TOL = 2e-2            # bf16 kernel vs plain version (tests/test_kernels.py)
REF_TOL = 5e-2        # bf16 model on the card vs f32 model on the CPU,
#                       as max |diff| / max |reference logit|
SLOT_TOL = 3e-2       # a pool slot vs its request alone at batch 1 on the
#                       card, the same measure (context_slots): a little
#                       above what sound full-width runs read (PERF.md)
L2_BYTES = 50e6       # timed inputs rotate over copies exceeding 2x L2
WINDOW_V = 64.0       # V of the keys a windowed prefill's last rows leave
#                       out (window_inputs): without the window, every row
#                       past it moves beyond TOL
SEED = 0
ARCH = "qwen2-7b"
MOE_ARCH = "qwen2-moe-a2.7b"
STARCODER_ARCH = "starcoder2-15b"
GEMMA_ARCH = "gemma3-27b"
MIXTRAL_ARCH = "mixtral-8x7b"
RWKV_ARCH = "rwkv6-1.6b"
HYBRID_ARCH = "hymba-1.5b"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def load_rates() -> None:
    global PEAK_FLOPS, PEAK_BYTES
    from repro_torch.launch import mesh
    PEAK_FLOPS, PEAK_BYTES = mesh.PEAK_FLOPS_BF16, mesh.HBM_BW


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


def device_ms(calls, iters: int = 30, label: str = "",
              one_kernel: str = "") -> float:
    """Mean device time per call of the kernels ``calls`` launch, from
    ``torch.profiler``'s kernel records: unlike ``time_ms`` it leaves out
    the host's dispatch, which bounds ``time_ms`` when a call's kernels
    finish before Python dispatches the next call.  With a ``label``,
    logs the time per call of each CUDA kernel the calls launch; with
    ``one_kernel``, fails unless each call ran that one port kernel and
    nothing else (where the profile holds records at all)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    totals = device_totals(raw_events(prof, host=False))
    rows = [(us / 1e3 / iters, key) for key, (us, _) in totals.items()]
    if label:
        log(f"device ms per call of {label} by kernel: " + "; ".join(
            f"{_port_name(key) or key[:50]} {t:.5f}" for t, key in rows))
    ran = {_port_name(key) or key: n for key, (_, n) in totals.items()}
    if one_kernel and ran and (len(ran) != 1
                               or ran.get(one_kernel) != iters):
        raise AssertionError(f"{label or one_kernel}: {iters} calls ran "
                             f"{ran}, not one {one_kernel} each")
    return sum(t for t, _ in rows)


def raw_events(prof, host: bool = True) -> list[tuple[str, bool, int, int]]:
    """The profiler's raw records, the device's and (``host``) the
    host's, as (name, on the device, start ns, end ns).  Building its
    event list (``prof.events()``, ``key_averages()``) for a serve window
    of a few hundred thousand records takes longer than the window."""
    from torch.autograd import DeviceType

    def ns(e, what):
        if hasattr(e, f"{what}_ns"):
            return getattr(e, f"{what}_ns")()
        return getattr(e, f"{what}_us")() * 1000

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != DeviceType.CPU
        if on_device or host:
            start = ns(e, "start")
            out.append((e.name(), on_device, start,
                        start + ns(e, "duration")))
    return out


def device_totals(events, skip=()) -> dict[str, tuple[float, int]]:
    """{name: (µs, records)} of the device records of ``raw_events`` with
    a duration (the kernels, copies and sets), by name in order of first
    appearance, leaving out the names in ``skip``."""
    rows = {}
    for name, on_device, start, end in events:
        if on_device and end > start and name not in skip:
            us, n = rows.get(name, (0.0, 0))
            rows[name] = (us + (end - start) / 1e3, n + 1)
    return rows


def kernel_times(calls, plain, library=None, plain_iters: int = 30,
                 label: str = "", one_kernel: str = "") -> dict:
    """The kernel's and the library call's times by CUDA events and by
    device time (split by CUDA kernel in the log where ``label`` names
    the calls; ``one_kernel``: see ``device_ms``), and the plain
    version's by CUDA events."""
    return dict(ms=time_ms(calls), device_ms=device_ms(
                    calls, label=label, one_kernel=one_kernel),
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
    flash_dense_configs(dev)
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
             for i in range(n)], label="bf16 dense decode",
            one_kernel="decode_bf16_kernel<128>"))

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
    # Pages no table entry names (each sequence's pages past its length)
    # may hold anything: NaN there changes no bit.
    named = set(tables_np[tables_np > 0].tolist())
    unnamed = torch.as_tensor([p for p in range(1, n_blocks)
                               if p not in named], device=dev)
    poisoned = [x.clone() for x in (kp, vp)]
    for x in poisoned:
        x[unnamed] = float("nan")
    if not torch.equal(da.paged_decode_attention(q, *poisoned, tables, lens),
                       paged_out):
        raise AssertionError("paged decode read a page no table entry "
                             "names")
    log(f"decode: NaN in the {len(unnamed)} pages no table entry names "
        f"changes no bit of the paged output")
    del poisoned
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
            label="bf16 paged decode",
            one_kernel="paged_decode_bf16_kernel<128>"))
    out.update(int8_kernels(q, kc, vc, lens_np, tables_np))
    decode_geometries(dev)
    decode_dense_configs(dev)
    member_geometries(dev)
    context_attention(dev)
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
             for x in leaves], label="int8 dense decode",
            one_kernel="decode_q8_kernel<128>"))

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
            label="int8 paged decode",
            one_kernel="paged_decode_q8_kernel<128>"))
    return out


def decode_geometries(dev) -> None:
    """All four decode kernels at starcoder2-15b's attention geometry (48
    query heads over 4 kv heads of 128: G = 12) and at qwen2-moe-a2.7b's
    (16 over 16 of 128: G = 1), B=8, S=1024, mixed cache_len, against
    their plain versions; each paged kernel (pages of 16 rows) bit-equal
    to its dense one."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.attention import kv_quantize

    rng = np.random.default_rng(SEED + 8)
    b, s, d = 8, 1024, 128

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)

    for arch, h, kv in ((STARCODER_ARCH, 48, 4), (MOE_ARCH, 16, 16)):
        g = h // kv
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
                errs[f"{name} {label}"] = close(
                    f"{name} {label} decode G={g}", outs[-1], plain(*args))
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"{name} paged and dense decode differ "
                                     f"at G={g} on identical K/V")
        log(f"decode at {arch}'s G={g} (B={b} S={s} H={h} K={kv} D={d}): "
            f"max_abs_err {errs}; paged == dense, bit for bit, in bf16 and "
            f"int8")


def wkv6_cost(b, s, h):
    """(operations, bytes) of WKV-6 over (B, S, H) heads of 64: r, k, v, w
    read and out written (bf16), u read, the state read and written
    (f32); 5 D^2 operations a step and head, as the recurrence is
    written."""
    seq = b * s * h * 64
    return 5 * seq * 64, 5 * seq * 2 + 2 * b * h * 64 * 64 * 4 + h * 128


def wkv6_inputs(rng, dev, b, s, h, state_scale, decay="mild"):
    """r, k, v, w, u, state of WKV-6 on the card (heads of 64): w in log
    space, mild (-exp(0.3 n) - 0.01), strong (-exp(n + 2): a chunk's
    decay reaches hundreds) or weak (-1e-3)."""
    import torch

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
    r, k, v = (rand(b, s, h, 64).to(torch.bfloat16) for _ in range(3))
    n = rand(b, s, h, 64)
    w = {"mild": -torch.exp(n * 0.3) - 0.01, "strong": -torch.exp(n + 2),
         "weak": torch.full_like(n, -1e-3)}[decay].to(torch.bfloat16)
    return r, k, v, w, rand(h, 64).to(torch.bfloat16), \
        rand(b, h, 64, 64) * state_scale


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

    def inputs(*shape):
        return wkv6_inputs(rng, dev, *shape)

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
    flops, io = wkv6_cost(b, s, h)
    n = copies_for(io)
    sets = [[x.clone() for x in main] for _ in range(n)]
    bnd, by = bound(flops, io)
    dflops, dio = wkv6_cost(8, 1, h)
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
    qwen2-7b's, starcoder2-15b's, gemma3-27b's and hymba-1.5b's reduced
    configs (head dim 16; gemma3's 16-token prompts pass its window of 8;
    hymba's SSM state 8, its 20-row prefills through the chunked scan)
    through ``serve.main``, then qwen2-moe-a2.7b's and mixtral-8x7b's
    (24-token prompts, past mixtral's window of 16), with their launch
    counts."""
    import contextlib
    import io
    import re
    from repro_torch import kernels
    from repro_torch.launch import serve

    for archs, extra, used in (
            (("qwen2-7b", "starcoder2-15b", "gemma3-27b", "hymba-1.5b"), [],
             ("flash_attention", "decode_attention", "ssm_chunked",
              "ssm_step")),
            (("qwen2-moe-a2.7b", "mixtral-8x7b"), ["--prompt-len", "24"],
             ("flash_attention", "decode_attention"))):
        kernels.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--reduced", *[a for arch in archs
                                       for a in ("--arch", arch)],
                        "--requests", "8", "--max-new-tokens", "8", *extra])
        counts = kernels.launch_counts()
        text = buf.getvalue()
        m = re.search(r"completed (\d+)/(\d+) requests", text)
        if not m or m.group(1) != m.group(2) or m.group(2) != "8":
            raise AssertionError(f"reduced serve: {text[-2000:]}")
        if any(counts[k] == 0 for k in used):
            raise AssertionError(f"reduced serve: kernel launches {counts}")
        log(f"reduced serve (serve.main --reduced {' '.join(extra)}, "
            f"{', '.join(archs)}, head dim 16) on the card: {m.group(0)}; "
            f"launches {counts}")


def causal_pairs(sq: int, window=None) -> int:
    """(query, key) pairs a causal prefill of ``sq`` rows attends, within
    ``window`` keys of each query when one is given."""
    w = sq if window is None else min(window, sq)
    return w * (w + 1) // 2 + (sq - w) * w


def flash_logged(label, q, k, v, window=None, causal=True):
    """The flash kernel at one more prefill shape, held against its plain
    version and timed (logged; the JSON line keeps qwen2-7b's main shape)
    beside SDPA: causal, or with a boolean mask where the window cuts
    pairs the causal mask keeps, or (``causal=False``: an encoder, or a
    cross layer over a context of Sk rows) with no mask.  Returns the
    kernel's output."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    b, sq, h, d = q.shape
    sk, kv = k.shape[1:3]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    err = close(f"flash {label}", out,
                fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window))
    io = 2 * (q.numel() * 2 + k.numel() + v.numel())
    n = copies_for(io)
    sets = [[x.clone() for x in (q, k, v)] for _ in range(n)]
    tsets = [[x.transpose(1, 2).contiguous() for x in xs] for xs in sets]
    pairs = causal_pairs(sq, window) if causal else sq * sk
    bnd, by = bound(4 * b * h * d * pairs, io)
    calls = [lambda x=x: fa.flash_attention(*x, causal=causal,
                                            window=window) for x in sets]
    if not causal:
        sdpa = [lambda x=x: F.scaled_dot_product_attention(
            *x, enable_gqa=True) for x in tsets]
        how = "no mask"
    elif window is not None and window < sq:
        pos = torch.arange(sq, device=q.device)
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
        sdpa = [lambda x=x: F.scaled_dot_product_attention(
            *x, attn_mask=mask, enable_gqa=True) for x in tsets]
        how = "a boolean causal window mask"
    else:
        sdpa = [lambda x=x: F.scaled_dot_product_attention(
            *x, is_causal=True, enable_gqa=True) for x in tsets]
        how = "causal"
    log(f"kernel flash_attention at {label} (B={b} Sq={sq} Sk={sk} H={h} "
        f"K={kv} D={d} causal {causal} window {window}): max_abs_err={err} "
        f"ms={time_ms(calls)} "
        f"device_ms={device_ms(calls)} library_ms={time_ms(sdpa)} "
        f"library_device_ms={device_ms(sdpa)} (SDPA, {how}) "
        f"bound_ms={bnd} ({by})")
    return out


def window_inputs(dev, sq=4160, h=32, kv=8, d=128, window=4096) -> tuple:
    """bf16 q, k, v of a causal prefill of ``sq`` rows past its
    ``window`` (mixtral-8x7b's geometry), drawn from their own seed, with
    V of the ``sq - window`` keys its last row leaves out set to
    ``WINDOW_V``: row ``window + j`` leaves out keys 0..j, and their
    weight then moves each such row beyond ``TOL`` (``window_probe``)."""
    import torch
    gen = np.random.default_rng(SEED + 19)
    q, k, v = (torch.from_numpy(gen.standard_normal((1, sq, n, d)).astype(
        np.float32)).to(dev).to(torch.bfloat16) for n in (h, kv, kv))
    v[:, :sq - window] = WINDOW_V
    return q, k, v


def window_gaps(q, k, v, window, out) -> tuple:
    """The rows of a causal prefill past its ``window`` (``out``: a flash
    output of ``q`` over ``k`` / ``v``, as many rows) against the plain
    version with the window and without it: per row, the max |diff| to
    each, and whether the row lies outside ``close``'s tolerance of
    each.  Returns ((gaps windowed, windowless), (outside windowed,
    windowless))."""
    from repro_torch.kernels import flash_attention as fa
    tail, got = q[:, window:], out[:, window:].float()
    gaps, outside = [], []
    for w in (window, None):
        ref = fa.flash_attention_plain(tail, k, v, window=w,
                                       q_offset=window).float()
        diff = (got - ref).abs()
        gaps.append(diff.flatten(2).amax(-1)[0])
        outside.append((diff > TOL + TOL * ref.abs()).flatten(2).any(-1)[0])
    return tuple(gaps), tuple(outside)


def window_probe(label, q, k, v, window, out) -> str:
    """flash's window, seen (inputs from ``window_inputs``): each row past
    it lies within ``close``'s tolerance of the windowed plain version
    and outside it of the windowless one, so a kernel that ignored the
    window, or cut it a key off, would fail ``close``.  Returns what to
    log."""
    import torch
    (win, free), (out_win, out_free) = window_gaps(q, k, v, window, out)
    rows = f"rows {window}-{q.shape[1] - 1}"
    if out_win.any() or not out_free.all():
        raise AssertionError(
            f"flash {label}: {rows}: outside the windowed plain version's "
            f"tolerance at rows "
            f"{(window + torch.nonzero(out_win).flatten()).tolist()}, "
            f"within the windowless one's at rows "
            f"{(window + torch.nonzero(~out_free).flatten()).tolist()}")
    return (f"{rows} each within TOL of the windowed plain version (max "
            f"|diff| {float(win.max())}) and beyond it of the windowless "
            f"one (max |diff| a row {float(free.min())} to "
            f"{float(free.max())}; row {window} leaves out 1 key)")


def flash_dense_configs(dev) -> None:
    """The flash kernel at gemma3-27b's prefill geometry (32 query heads
    over 16 kv heads of 128) at 1920 rows, its local layers' window of
    1024 cutting tiles, and at its global layers' (no window); at
    starcoder2-15b's (48 over 4 of 128), qwen2-moe-a2.7b's (16 over 16
    of 128: G = 1), seamless-m4t-large-v2's decoder self layers' (16 over
    16 of 64) and llama-3.2-vision-11b's self layers' (32 over 8 of 128:
    G = 4), causal at a 512-token prompt, and at mixtral-8x7b's (32 over
    8 of 128) at a 4160-token prompt, past its window of 4096; each held
    against its plain version and timed beside SDPA and the bound, the
    last with the window seen (``window_probe``)."""
    import torch
    gen = np.random.default_rng(SEED + 9)

    def rand(*shape):
        return torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)

    for label, sq, h, kv, d, window in (
            ("gemma3-27b's local prefill", 1920, 32, 16, 128, 1024),
            ("gemma3-27b's global prefill", 1920, 32, 16, 128, None),
            ("starcoder2-15b's prefill", 512, 48, 4, 128, None),
            ("qwen2-moe-a2.7b's prefill", 512, 16, 16, 128, None),
            ("seamless-m4t-large-v2's decoder prefill", 512, 16, 16, 64,
             None),
            ("llama-3.2-vision-11b's self prefill", 512, 32, 8, 128,
             None)):
        flash_logged(label, rand(1, sq, h, d), rand(1, sq, kv, d),
                     rand(1, sq, kv, d), window=window)
    label, window = "mixtral-8x7b's prefill past its window", 4096
    q, k, v = window_inputs(dev, window=window)
    out = flash_logged(label, q, k, v, window=window)
    log(f"kernel flash_attention at {label}, the window seen: "
        f"{window_probe(label, q, k, v, window, out)}")


def decode_logged(label, q, kc, vc, lens, plan_kv=None) -> None:
    """The bf16 dense decode kernel at one more geometry (its split of S
    planned for ``plan_kv`` kv heads, as a pod's member plans it), held
    against its plain version and timed (logged) beside SDPA with a
    length mask (none where every row is at ``cache_len = S``, as a cross
    layer's context cache) and the bound: the rows ``lens`` holds, read
    once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da

    b, _, h, d = q.shape
    s, kv = kc.shape[1:3]
    err = close(f"decode {label}",
                da.decode_attention(q, kc, vc, lens, plan_kv=plan_kv),
                da.decode_attention_plain(q, kc, vc, lens))
    rows = int(lens.clamp(max=s).sum())
    bnd, by = bound(4 * h * d * rows,
                    2 * rows * kv * d * 2 + 2 * q.numel() * 2 + 4 * b)
    n = copies_for(kc.numel() * 4)
    sets = [[x.clone() for x in (q, kc, vc)] for _ in range(n)]
    tsets = [[x[0].reshape(b, h, 1, d)]
             + [c.transpose(1, 2).contiguous() for c in x[1:]]
             for x in sets]
    full = bool((lens == s).all())
    mask = None if full else (torch.arange(s, device=q.device)[None, :]
                              < lens[:, None])[:, None, None, :]
    calls = [lambda x=x: da.decode_attention(*x, lens, plan_kv=plan_kv)
             for x in sets]
    sdpa = [lambda x=x: F.scaled_dot_product_attention(
        *x, attn_mask=mask, enable_gqa=True) for x in tsets]
    log(f"kernel decode_attention at {label} (B={b} S={s} H={h} K={kv} "
        f"D={d}, split planned for {plan_kv or kv} kv heads, cache_len "
        f"{lens.tolist()}): max_abs_err={err} "
        f"ms={time_ms(calls)} device_ms={device_ms(calls)} "
        f"library_ms={time_ms(sdpa)} library_device_ms={device_ms(sdpa)} "
        f"(SDPA, {'no mask' if full else 'mask'}) bound_ms={bnd} ({by})")


def decode_dense_configs(dev) -> None:
    """The bf16 dense decode kernel at starcoder2-15b's round (B=8, S=1024,
    48 query heads over 4 kv heads of 128: G = 12), at gemma3-27b's global
    layers' (B=8, S=2048, 32 over 16: G = 2), at qwen2-moe-a2.7b's round
    (B=8, S=1024, 16 over 16: G = 1), and at the self layers' rounds of
    seamless-m4t-large-v2 (B=8, S=1024, 16 over 16 of 64: G = 1) and
    llama-3.2-vision-11b (B=8, S=1024, 32 over 8 of 128: G = 4), mixed
    cache lengths, each held against its plain version and timed."""
    import torch
    gen = np.random.default_rng(SEED + 11)

    def rand(*shape):
        return torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)

    mixed = [1024, 1, 517, 64, 1000, 333, 768, 129]
    for label, s, h, kv, d, lens in (
            ("starcoder2-15b's round, G=12", 1024, 48, 4, 128, mixed),
            ("gemma3-27b's global layers, G=2", 2048, 32, 16, 128,
             [2048, 1, 1517, 64, 1900, 333, 1168, 129]),
            ("qwen2-moe-a2.7b's round, G=1", 1024, 16, 16, 128, mixed),
            ("seamless-m4t-large-v2's self round, G=1", 1024, 16, 16, 64,
             mixed),
            ("llama-3.2-vision-11b's self round, G=4", 1024, 32, 8, 128,
             mixed)):
        decode_logged(label, rand(8, 1, h, d), rand(8, s, kv, d),
                      rand(8, s, kv, d),
                      torch.tensor(lens, dtype=torch.int32, device=dev))


def paged_logged(label, q, kc, vc, lens, page=16, plan_kv=None) -> None:
    """The bf16 paged decode kernel at one more geometry (split as
    ``decode_logged``'s): ``kc``/``vc``
    scattered over ``page``-row pages in a random order, held against the
    plain paged version and timed beside SDPA over the dense layout (with
    a length mask) and the bound: the rows ``lens`` holds and their table
    entries, read once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da

    b, _, h, d = q.shape
    s, kv = kc.shape[1:3]
    (kp, vp), tables = scatter_pages((kc, vc), page,
                                     np.random.default_rng(SEED + 13))
    err = close(f"paged {label}",
                da.paged_decode_attention(q, kp, vp, tables, lens,
                                          plan_kv=plan_kv),
                da.paged_decode_attention_plain(q, kp, vp, tables, lens))
    rows = int(lens.sum())
    entries = int((-(-lens // page)).sum())
    bnd, by = bound(4 * h * d * rows, 2 * rows * kv * d * 2
                    + 2 * q.numel() * 2 + 4 * b + 4 * entries)
    n = copies_for(kp.numel() * 4)
    sets = [[x.clone() for x in (q, kp, vp)] for _ in range(n)]
    calls = [lambda x=x: da.paged_decode_attention(*x, tables, lens,
                                                   plan_kv=plan_kv)
             for x in sets]
    dense = [[q.reshape(b, h, 1, d).clone()]
             + [c.transpose(1, 2).contiguous() for c in (kc, vc)]
             for _ in range(n)]
    mask = (torch.arange(s, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    sdpa = [lambda x=x: F.scaled_dot_product_attention(
        *x, attn_mask=mask, enable_gqa=True) for x in dense]
    log(f"kernel paged_decode_attention at {label} (B={b} pages of {page} "
        f"rows, M={tables.shape[1]} H={h} K={kv} D={d}, split planned for "
        f"{plan_kv or kv} kv heads, cache_len {lens.tolist()}): "
        f"max_abs_err={err} ms={time_ms(calls)} "
        f"device_ms={device_ms(calls)} library_ms={time_ms(sdpa)} "
        f"library_device_ms={device_ms(sdpa)} (SDPA over the dense "
        f"layout, mask) bound_ms={bnd} ({by})")


def member_geometries(dev) -> None:
    """The kernels of a qwen2-7b pod at its members' geometries: a
    2-member pod's member attends 14 q heads over 2 kv heads of 128, a
    4-member pod's 7 over 1 (G = 7 either way).  Flash causal at a
    512-token prompt (B=1); dense decode at B=8, S=1024 with mixed cache
    lengths; paged decode over pages of 16 rows; int8 dense decode at 14
    over 2.  Then flash windowed at a 4-member gemma3-27b pod's member
    (1920 rows, 8 over 4, window 1024) and dense decode at a 4-member
    qwen2-moe-a2.7b pod's (4 over 4).  Each held against its plain
    version and timed beside SDPA (none computes int8 decode) and the
    bound."""
    import torch
    gen = np.random.default_rng(SEED + 12)

    def rand(*shape):
        return torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)

    lens = torch.tensor([1024, 1, 517, 64, 1000, 333, 768, 129],
                        dtype=torch.int32, device=dev)
    for shards, h, kv in ((2, 14, 2), (4, 7, 1)):
        label = f"a {shards}-member qwen2-7b pod's member, G=7"
        flash_logged(label, rand(1, 512, h, 128), rand(1, 512, kv, 128),
                     rand(1, 512, kv, 128))
        q, kc, vc = (rand(8, 1, h, 128), rand(8, 1024, kv, 128),
                     rand(8, 1024, kv, 128))
        decode_logged(label, q, kc, vc, lens, plan_kv=4)
        paged_logged(label, q, kc, vc, lens, plan_kv=4)
        if shards == 2:
            int8_logged(label, q, kc, vc, lens, plan_kv=4)
    # The windowed and moe pods, one member geometry each: a
    # 4-member gemma3-27b pod's local prefill (8 q over 4 kv heads of 128,
    # window 1024) and a 4-member qwen2-moe-a2.7b pod's round (4 over 4).
    flash_logged("a 4-member gemma3-27b pod's member, local", rand(
        1, 1920, 8, 128), rand(1, 1920, 4, 128), rand(1, 1920, 4, 128),
                 window=1024)
    decode_logged("a 4-member qwen2-moe-a2.7b pod's member, G=1",
                  rand(8, 1, 4, 128), rand(8, 1024, 4, 128),
                  rand(8, 1024, 4, 128), lens, plan_kv=16)
    member_split_check(rand, lens)
    recurrent_member_split(dev)


def member_split_check(rand, lens) -> None:
    """A pod's member attends its heads as one device does: each decode
    kernel (dense and paged, bf16 and int8) at qwen2-moe-a2.7b's 16 q /
    16 kv heads and qwen2-7b's 28 / 4, and at a 2- and a 4-member pod's
    slices of the same inputs with the split planned for the whole
    model's kv heads (``plan_kv``, as ``decode_step_tp`` launches them),
    which must equal the whole launch's heads bit for bit.  Without
    ``plan_kv`` a member splits S by its own heads, and the entries that
    differ are counted (logged).  Then flash (``flash_member_split``)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.attention import kv_quantize

    out = []
    for arch, h, kv in (("qwen2-moe-a2.7b", 16, 16), ("qwen2-7b", 28, 4)):
        q, kc, vc = (rand(8, 1, h, 128), rand(8, 1024, kv, 128),
                     rand(8, 1024, kv, 128))
        (k8, ks), (v8, vs) = kv_quantize(kc), kv_quantize(vc)
        (kp, vp), tables = scatter_pages((kc, vc), 16,
                                         np.random.default_rng(SEED + 15))
        (k8p, kps), (v8p, vps) = kv_quantize(kp), kv_quantize(vp)
        pools = {"decode_attention": (kc, vc),
                 "paged_decode_attention": (kp, vp),
                 "decode_attention_quant": (k8, v8, ks, vs),
                 "paged_decode_attention_quant": (k8p, v8p, kps, vps)}
        for name, pool in pools.items():
            fn = getattr(da, name)
            tail = (tables, lens) if name.startswith("paged") else (lens,)

            def run(q, sl, **kw):
                return fn(q, *(x[:, :, sl].contiguous() for x in pool),
                          *tail, **kw)

            whole = run(q, slice(None))
            for shards in (2, 4):
                kvm, hm = kv // shards, h // shards
                own = planned = 0
                for m in range(shards):
                    sl, qs = slice(m * kvm, (m + 1) * kvm), \
                        slice(m * hm, (m + 1) * hm)
                    qm = q[:, :, qs].contiguous()
                    got = run(qm, sl, plan_kv=kv)
                    planned += int((got != whole[:, :, qs]).sum())
                    own += int((run(qm, sl) != whole[:, :, qs]).sum())
                if planned:
                    raise AssertionError(
                        f"member split: {name} at {arch}'s {h}/{kv} heads, "
                        f"{shards} members: {planned} entries differ from "
                        f"the whole launch's with the split planned for "
                        f"{kv} kv heads")
                out.append(f"{name} {arch} x{shards} {own}")
    flash = flash_member_split(rand)
    torch.cuda.synchronize()
    log(f"member split: every member's heads equal the whole launch's bit "
        f"for bit with the split planned for the model's kv heads "
        f"(dense, paged, int8, paged int8; qwen2-moe-a2.7b 16/16 and "
        f"qwen2-7b 28/4 at 2 and 4 members); entries of the B x H x 128 "
        f"outputs that differ when a member plans by its own kv heads "
        f"(logged): {'; '.join(out)}; flash, bit for bit: {flash}")


def flash_member_split(rand) -> str:
    """A pod member's flash heads equal the whole launch's bit for bit:
    qwen2-7b's 28 q / 4 kv heads of 128 at a 512-token prefill split in
    2 and 4 members (14/2, 7/1), gemma3-27b's 32/16 at 1920 rows with its
    window of 1024 (16/8, 8/4)."""
    from repro_torch.kernels import flash_attention as fa

    done = []
    for arch, sq, h, kv, window in (("qwen2-7b", 512, 28, 4, None),
                                    ("gemma3-27b", 1920, 32, 16, 1024)):
        q, k, v = rand(1, sq, h, 128), rand(1, sq, kv, 128), \
            rand(1, sq, kv, 128)
        whole = fa.flash_attention(q, k, v, window=window)
        for shards in (2, 4):
            hm, kvm = h // shards, kv // shards
            for m in range(shards):
                qs, ks = slice(m * hm, (m + 1) * hm), \
                    slice(m * kvm, (m + 1) * kvm)
                got = fa.flash_attention(q[:, :, qs].contiguous(),
                                         k[:, :, ks].contiguous(),
                                         v[:, :, ks].contiguous(),
                                         window=window)
                bad = int((got != whole[:, :, qs]).sum())
                if bad:
                    raise AssertionError(
                        f"member split: flash at {arch}'s {h}/{kv} heads, "
                        f"member {m} of {shards}: {bad} entries differ "
                        f"from the whole launch's")
            done.append(f"{arch} {hm}/{kvm}")
    return ", ".join(done)


# The head axis of each input of the WKV-6 kernels (r, k, v, w, u, state)
# and of the scan's (x, dt, a_log, b, c, state).
WKV6_HEAD_AXES = (2, 2, 2, 2, 0, 1)
SSM_HEAD_AXES = (2, 2, 0, 2, 2, 1)


def recurrent_member_split(dev) -> None:
    """A pod's member scans its heads as one device does: both WKV-6
    kernels at rwkv6-1.6b's geometry (32 heads of 64; the chunked one at
    a B=1, S=512 prefill, the step one at a B=8, S=1 round) and both
    selective-scan kernels at the reduced hymba's (4 heads of 16, N=8;
    S=64 and S=1), each on a 2- and a 4-member pod's head slices of the
    same inputs: every member's outputs and final state must equal the
    whole launch's heads bit for bit (each CTA walks one head).  Then
    both WKV-6 kernels at a 2- and a 4-member rwkv6-1.6b pod's member
    geometry (16 and 8 heads), held against the plain scan and timed
    beside the bound (no PyTorch call computes WKV-6)."""
    import torch
    from repro_torch.kernels import ssm_scan, wkv6

    gen = np.random.default_rng(SEED + 16)
    cases = [("wkv6_chunked", wkv6.wkv6_chunked, WKV6_HEAD_AXES,
              wkv6_inputs(gen, dev, 1, 512, 32, 1.0)),
             ("wkv6_step", wkv6.wkv6_step, WKV6_HEAD_AXES,
              wkv6_inputs(gen, dev, 8, 1, 32, 1.0)),
             ("ssm_chunked", ssm_scan.ssm_chunked, SSM_HEAD_AXES,
              ssm_inputs(gen, dev, 1, 64, 4, 1.0, d=16, n=8)),
             ("ssm_step", ssm_scan.ssm_step, SSM_HEAD_AXES,
              ssm_inputs(gen, dev, 8, 1, 4, 1.0, d=16, n=8))]
    done = []
    for name, fn, axes, x in cases:
        out, state = fn(*x)
        h = x[-1].shape[1]
        for shards in (2, 4):
            hm = h // shards
            for m in range(shards):
                o, st = fn(*(t.narrow(a, m * hm, hm).contiguous()
                             for t, a in zip(x, axes)))
                if not (torch.equal(o, out.narrow(2, m * hm, hm))
                        and torch.equal(st, state.narrow(1, m * hm, hm))):
                    raise AssertionError(
                        f"member split: {name}'s member {m} of {shards} "
                        f"({hm} of {h} heads) differs from the whole "
                        f"launch's heads")
        done.append(f"{name} ({h} heads in {h // 2} and {h // 4}, "
                    f"B={x[0].shape[0]} S={x[0].shape[1]})")
    log(f"member split: every member's heads (outputs and final state) "
        f"equal the whole launch's bit for bit: {'; '.join(done)}")
    for shards in (2, 4):
        hm = 32 // shards
        for name, fn, b, s_ in (("wkv6_chunked", wkv6.wkv6_chunked, 1, 512),
                                ("wkv6_step", wkv6.wkv6_step, 8, 1)):
            x = wkv6_inputs(gen, dev, b, s_, hm, 0.0 if s_ > 1 else 1.0)
            err = close(f"{name} at a {shards}-member pod's member", fn(*x)[0],
                        wkv6.wkv6_scan_plain(*x)[0])
            flops, io = wkv6_cost(b, s_, hm)
            bnd, by = bound(flops, io)
            sets = [[t.clone() for t in x] for _ in range(copies_for(io))]
            calls = [lambda v=v: fn(*v) for v in sets]
            log(f"kernel {name} at a {shards}-member rwkv6-1.6b pod's member "
                f"(B={b} S={s_} H={hm} D=64): max_abs_err={err} "
                f"ms={time_ms(calls)} device_ms={device_ms(calls)} "
                f"bound_ms={bnd} ({by}); no library call")


def int8_logged(label, q, kc, vc, lens, plan_kv=None) -> None:
    """The int8 dense decode kernel at one more geometry (split as
    ``decode_logged``'s), on the codes and scales of ``kc``/``vc``
    (quantized on the card), held against its plain version and timed
    (logged) beside the bound: the rows ``lens`` holds, codes and scales,
    read once.  No PyTorch call computes it."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.attention import kv_quantize

    b, _, h, d = q.shape
    s, kv = kc.shape[1:3]
    (k8, ks), (v8, vs) = kv_quantize(kc), kv_quantize(vc)
    err = close(f"int8 decode {label}",
                da.decode_attention_quant(q, k8, v8, ks, vs, lens,
                                          plan_kv=plan_kv),
                da.decode_attention_quant_plain(q, k8, v8, ks, vs, lens))
    rows = int(lens.clamp(max=s).sum())
    bnd, by = bound(4 * h * d * rows, 2 * rows * kv * d + 2 * rows * kv * 2
                    + 2 * q.numel() * 2 + 4 * b)
    n = copies_for(k8.numel() * 2)
    sets = [[x.clone() for x in (q, k8, v8, ks, vs)] for _ in range(n)]
    calls = [lambda x=x: da.decode_attention_quant(*x, lens,
                                                   plan_kv=plan_kv)
             for x in sets]
    log(f"kernel decode_attention_quant at {label} (B={b} S={s} H={h} "
        f"K={kv} D={d}, split planned for {plan_kv or kv} kv heads, "
        f"cache_len {lens.tolist()}): max_abs_err={err} "
        f"ms={time_ms(calls)} device_ms={device_ms(calls)} library_ms=None "
        f"bound_ms={bnd} ({by})")


def context_attention(dev) -> None:
    """The attention of the encoder-decoder and vision families: flash with
    ``causal=False`` at seamless-m4t-large-v2's encoder (B=1, S=1024,
    H=K=16, D=64), its cross prefill (a 512-token prompt over the 1024
    encoder rows) and llama-3.2-vision-11b's cross prefill (512 over 1600
    image rows, 32 q / 8 kv of 128: 25 tiles of 64), and the bf16 dense
    decode kernel with every row at ``cache_len = S``, a cross layer's
    round: S=1024, G=1, D=64 and S=1600, G=4, D=128, B=8; each held
    against its plain version and timed beside SDPA (no mask) and the
    bound."""
    import torch
    gen = np.random.default_rng(SEED + 14)

    def rand(*shape):
        return torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)

    for label, sq, sk, h, kv, d in (
            ("seamless-m4t-large-v2's encoder", 1024, 1024, 16, 16, 64),
            ("seamless-m4t-large-v2's cross prefill", 512, 1024, 16, 16, 64),
            ("llama-3.2-vision-11b's cross prefill", 512, 1600, 32, 8, 128)):
        flash_logged(label, rand(1, sq, h, d), rand(1, sk, kv, d),
                     rand(1, sk, kv, d), causal=False)
    for label, s, h, kv, d in (
            ("seamless-m4t-large-v2's cross round, G=1", 1024, 16, 16, 64),
            ("llama-3.2-vision-11b's cross round, G=4", 1600, 32, 8, 128)):
        decode_logged(label, rand(8, 1, h, d), rand(8, s, kv, d),
                      rand(8, s, kv, d),
                      torch.full((8,), s, dtype=torch.int32, device=dev))


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
    _reference_starcoder2()
    _reference_gemma3()
    _reference_moe()
    _reference_mixtral()
    _reference_context()
    _reference_rwkv()
    _reference_hybrid()


def _filled(p_cpu, seed):
    """Give every all-zero leaf (norms, biases) values, in place, so they
    are checked too."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    for leaf in _leaves(p_cpu):
        if not leaf.any():
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 0.1)
    return p_cpu


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _reference_starcoder2() -> None:
    """A 2-layer GELU-with-biases model with starcoder2-15b's head geometry
    (48 query heads over 4 kv heads of 128, QKV bias; d_model 6144 ->
    1024, d_ff 24576 -> 2048, V 49152 -> 1024): bucketed prefill of a
    37-token prompt and 8 dense and 8 paged decode steps from bf16 and
    from int8 caches on the card through the kernels, against the same
    weights in f32 on the CPU through the plain versions."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="starcoder2-heads", family="dense", n_layers=2,
                      d_model=1024, n_heads=48, n_kv_heads=4, head_dim=128,
                      d_ff=2048, vocab_size=1024, qkv_bias=True, mlp="gelu",
                      rope_theta=1e5)
    model = build_model(cfg)
    p_cpu = _filled(model.init(torch.Generator().manual_seed(SEED)), SEED + 1)
    dev = torch.device("cuda", torch.cuda.current_device())
    p_gpu = _tree(p_cpu, lambda t: t.to(dev))
    p_ref = _tree(p_cpu, lambda t: t.float())
    max_len, n = 64, 37
    prompt = np.zeros((1, max_len), np.int32)
    prompt[0, :n] = np.random.default_rng(SEED + 12).integers(
        0, cfg.vocab_size, n)
    compare = Compare("starcoder2 reference")
    for kv_int8 in (False, True):
        _reference_decode(model, p_gpu, p_ref, prompt, n, max_len, kv_int8,
                          compare)
    log(f"reference: 2-layer GELU model with biases, starcoder2-15b's heads "
        f"(48 q / 4 kv of 128; cut: d 6144 -> 1024, d_ff 24576 -> 2048, V "
        f"49152 -> 1024), prefill + 8 dense + 8 paged decode steps from "
        f"bf16 and from int8 caches on the card within {compare.worst:.4f} "
        f"(limit {REF_TOL}) of f32 on the CPU")


def _reference_gemma3() -> None:
    """A 6-layer GeGLU model on dual caches with gemma3-27b's head geometry
    (32 query heads over 16 kv heads of 128, so q_dim 4096 != d_model),
    tied embeddings scaled by sqrt(d), 5 local layers and 1 global; cut:
    window 1024 -> 64, d_model 5376 -> 1024, d_ff 21504 -> 2048, V 262144
    -> 1024.  A 150-token prompt passes the window at prefill (flash with
    the window on the local layers, none on the global one; the rolled
    rows roll), then 3 decode steps (rolled attention on the local layers,
    the decode kernel on the global one), bf16 on the card against f32 on
    the CPU."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="gemma3-heads", family="dense", n_layers=6,
                      d_model=1024, n_heads=32, n_kv_heads=16, head_dim=128,
                      d_ff=2048, vocab_size=1024, mlp="geglu",
                      rope_theta=1e6, tie_embeddings=True, embed_scale=True,
                      sliding_window=64, local_global_ratio=5)
    model = build_model(cfg)
    p_cpu = _filled(model.init(torch.Generator().manual_seed(SEED)), SEED + 1)
    dev = torch.device("cuda", torch.cuda.current_device())
    p_gpu = _tree(p_cpu, lambda t: t.to(dev))
    p_ref = _tree(p_cpu, lambda t: t.float())
    prompt = np.random.default_rng(SEED + 13).integers(
        0, cfg.vocab_size, (1, 150)).astype(np.int32)
    compare = Compare("gemma3 reference")
    max_len = 256
    flash, decode = fa.flash_attention.launches, da.decode_attention.launches
    lg, cg = model.prefill(p_gpu, torch.as_tensor(prompt, device=dev),
                           max_len=max_len)
    lr, cr = model.prefill(p_ref, torch.as_tensor(prompt), max_len=max_len)
    compare("prefill", lg, lr)
    shapes = {k: tuple(v.shape) for k, v in cg.items()}
    if shapes != {"k": (6, 1, 64, 16, 128), "v": (6, 1, 64, 16, 128),
                  "global_k": (1, 1, 256, 16, 128),
                  "global_v": (1, 1, 256, 16, 128), "pos": ()} \
            or int(cg["pos"]) != 150:
        raise AssertionError(f"gemma3 reference: cache {shapes}")
    tok = model.sample_greedy(lr)
    for i in range(3):
        lg, cg = model.decode_step(p_gpu, tok.to(dev), cg)
        lr, cr = model.decode_step(p_ref, tok, cr)
        compare(f"decode step {i}", lg, lr)
        tok = model.sample_greedy(lr)
    ran = (fa.flash_attention.launches - flash,
           da.decode_attention.launches - decode)
    if ran != (6, 3):
        raise AssertionError(f"gemma3 reference: (flash, decode) launches "
                             f"{ran}, expected 6 a prefill and 1 a step")
    log(f"reference: 6-layer GeGLU dual-cache model, gemma3-27b's heads (32 "
        f"q / 16 kv of 128, q_dim 4096 != d 1024, tied and scaled "
        f"embeddings, 5 local + 1 global; cut: window 1024 -> 64, d 5376 "
        f"-> 1024, d_ff 21504 -> 2048, V 262144 -> 1024), prefill of 150 "
        f"tokens past the window + 3 decode steps on the card within "
        f"{compare.worst:.4f} (limit {REF_TOL}) of f32 on the CPU; launches "
        f"(flash, decode) {ran}")


MOE_MARGIN = 1e-4  # a top-k gate margin above this must route the same
MIN_KEPT = 0.75  # of a moe pod's prefills and round rows, the least share
#                  that must route as one instance's (near-tie flips aside),
#                  and of its prompts, the least share whose first token
#                  must be one instance's but at a near-tie of the logits
GATE_TOL = 5e-2  # a gate (a probability) of a run on another's experts
#                  against that run's, as REF_TOL holds the logits
#                    on the card as on the CPU


def _reference_moe() -> None:
    """A 2-layer MoE model with qwen2-moe-a2.7b's widths (d 2048, 16 q / 16
    kv heads of 128, QKV bias, 60 experts of d_ff 1408 top-4 and 4 shared;
    cut: 24 layers -> 2, V 151936 -> 1024), bf16 on the card against f32
    on the CPU, layer by layer from identical inputs (``_moe_layers``):
    a 300-token prefill (the flash kernel; capacity 41), 2 decode steps of
    8 slots on its cache (the decode kernel; 8 rows, capacity 8) and a
    speculative verify window of 8 slots x 5 (the verify attention; 40
    rows share capacity 8, so pairs drop).  Then ``top_e``, ``dest`` and
    ``keep`` at 512 tokens and capacity factor 0.5 (overflowing) equal
    the CPU's as integers, on integer features and an integer router
    (exact logits on both devices, ties included)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="qwen2-moe-widths", family="moe", n_layers=2,
                      d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
                      vocab_size=1024, qkv_bias=True, rope_theta=1e6,
                      n_experts=60, top_k=4, n_shared_experts=4,
                      moe_d_ff=1408)
    stats = _moe_layers(cfg, verify=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    # Exact logits: integer features and router, so routing is exact.
    irng = np.random.default_rng(SEED + 15)
    xi = irng.integers(-2, 3, (512, cfg.d_model)).astype(np.float32)
    ri = irng.integers(-3, 4, (cfg.d_model, cfg.n_experts)).astype(np.float32)
    cap_i = moe._capacity(512, cfg, 0.5)
    got = moe.route(torch.as_tensor(ri, device=dev),
                    torch.as_tensor(xi, device=dev).to(torch.bfloat16), cfg,
                    cap_i)
    want = moe.route(torch.from_numpy(ri), torch.from_numpy(xi), cfg, cap_i)
    for key in ("top_e", "dest", "keep"):
        if not torch.equal(got[key].cpu(), want[key]):
            raise AssertionError(f"moe reference: {key} at T=512, cf 0.5 "
                                 f"differs from the CPU's")
    dropped = int((~want["keep"]).sum())
    if not dropped:
        raise AssertionError("moe reference: T=512 at cf 0.5 dropped none")
    log(f"reference: 2-layer MoE model, qwen2-moe-a2.7b's widths (d 2048, "
        f"16 q / 16 kv of 128, 60 experts top-4 of d_ff 1408 + 4 shared, "
        f"f32 router; cut: 24 layers -> 2, V 151936 -> 1024), layer by "
        f"layer from the CPU's inputs rounded to bf16, through a 300-token "
        f"prefill, 2 decode steps of 8 slots and a verify window of 8 x "
        f"{SPEC_K + 1}: {_moe_stats_text(stats)}; top_e, dest and "
        f"keep at T=512, cf 0.5 (cap {cap_i}, {dropped} of "
        f"{512 * cfg.top_k} pairs dropped) equal the CPU's")


def _reference_mixtral() -> None:
    """A 2-layer model at mixtral-8x7b's widths (d 4096, 32 q / 8 kv heads
    of 128, 8 experts of d_ff 14336 top-2, window 4096, an f32 router;
    cut: 32 layers -> 2, V 32000 -> 1024), bf16 on the card against f32
    on the CPU, layer by layer from identical inputs (``_moe_layers``): a
    300-token prefill (windowed flash; capacity 150) and 2 decode steps of
    8 slots on its rolled cache (the plain rolled attention; capacity
    4)."""
    import dataclasses
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MIXTRAL_ARCH),
                              name="mixtral-widths", n_layers=2,
                              vocab_size=1024)
    t0 = time.perf_counter()
    stats = _moe_layers(cfg, verify=False)
    log(f"reference: 2-layer MoE model, {MIXTRAL_ARCH}'s widths (d "
        f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv of "
        f"{cfg.dh}, {cfg.n_experts} experts top-{cfg.top_k} of d_ff "
        f"{cfg.expert_d_ff}, window {cfg.sliding_window}, f32 router; cut: "
        f"32 layers -> 2, V 32000 -> {cfg.vocab_size}), layer by layer "
        f"from the CPU's inputs rounded to bf16, through a 300-token "
        f"prefill and 2 decode steps of 8 slots on the rolled cache: "
        f"{_moe_stats_text(stats)}; {time.perf_counter() - t0:.1f}s")


def _moe_layers(cfg, verify: bool) -> dict:
    """``cfg``'s 2-layer model, bf16 on the card (norms filled) against
    its f32 copy on the CPU, layer by layer from identical inputs
    (``_moe_forward``): a 300-token prefill through flash (within the
    config's window), 2 decode steps of 8 slots on the prefill's cache
    (a rolled cache for a windowed config, as the model keeps one) and,
    with ``verify``, a speculative verify window of 8 slots x
    ``SPEC_K + 1``.  Returns the comparison's statistics."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model

    model = build_model(cfg)
    dev = torch.device("cuda", torch.cuda.current_device())
    p_gpu = _filled(model.init(torch.Generator(device=dev).manual_seed(SEED)),
                    SEED + 1)
    p_ref = _tree(p_gpu, lambda t: t.float().cpu())
    if p_gpu["layers"]["moe"]["router"].dtype != torch.float32:
        raise AssertionError(f"{cfg.name} reference: the router is not f32")
    w = cfg.sliding_window
    rng = np.random.default_rng(SEED + 14)
    prompt = rng.integers(0, cfg.vocab_size, (1, 300)).astype(np.int32)
    stats = dict(attention={}, dropped={}, experts=0.0, flips=0, near=0,
                 rows=0, checked=0)
    planes = (p_gpu, p_ref)
    _moe_forward(cfg, planes, prompt, lambda a, h, i, plane: attn.attn_full(
        a, h, cfg, positions=torch.arange(300, device=h.device),
        window=w)[0], "prefill", stats)
    _, cache = model.prefill(p_ref, torch.as_tensor(prompt), max_len=320)
    rows = {k: cache[k].repeat(1, 8, 1, 1, 1) for k in ("k", "v")}

    def both(rows):
        """Both planes' caches: the CPU's rows so far, rounded to bf16."""
        return ({k: v.to(torch.bfloat16).to(dev) for k, v in rows.items()},
                {k: v.to(torch.bfloat16).float() for k, v in rows.items()})

    for step in range(2):
        caches, at = both(rows), torch.tensor(300 + step, dtype=torch.int32)
        _moe_forward(cfg, planes, rng.integers(0, cfg.vocab_size, (8, 1)),
                     lambda a, h, i, plane: attn.attn_decode(
                         a, h, caches[plane]["k"][i], caches[plane]["v"][i],
                         at.to(h.device), cfg, rolled=w is not None,
                         window=w)[0], f"decode step {step}", stats)
        rows = caches[1]
    if verify:
        caches, at = both(rows), torch.full((8,), 302, dtype=torch.int32)
        _moe_forward(cfg, planes, rng.integers(0, cfg.vocab_size,
                                               (8, SPEC_K + 1)),
                     lambda a, h, i, plane: attn.attn_verify(
                         a, h, caches[plane]["k"][i], caches[plane]["v"][i],
                         at.to(h.device), cfg)[0], "verify", stats)
    return stats


def _moe_stats_text(stats) -> str:
    return (f"the attention half within "
            f"{max(stats['attention'].values()):.4f} (limit {TOL}; by step "
            f"{ {k: round(v, 4) for k, v in stats['attention'].items()} }) "
            f"of f32 on the CPU at every position; the expert block routed "
            f"the same wherever the top-k margin > {MOE_MARGIN} "
            f"({stats['near']} of {stats['rows']} token-layers at or below "
            f"it; flips {stats['flips']}; pairs dropped on the CPU by step "
            f"{stats['dropped']}), outputs of the {stats['checked']} "
            f"token-layers routed the same within {stats['experts']:.4f} "
            f"(limit {TOL})")


def _moe_forward(cfg, planes, tokens, attend, label, stats) -> None:
    """One forward of the card's bf16 and the CPU's f32 ``planes`` (their
    params), layer by layer from identical inputs.  Layer i's input on the
    CPU, rounded to bf16, goes through the attention half on both planes
    (``attend(attention params, normed input, i, plane)``, plane 0 the
    card's); the card's output must be within ``TOL`` of the CPU's (max
    |diff| / max |reference|).  Then the CPU's expert-block input,
    rounded to bf16, goes through ``_moe_block``; the CPU's stream goes on
    in f32 from there."""
    import torch
    from repro_torch.models import moe, transformer
    from repro_torch.models.layers import rms_norm

    dev = planes[0]["embed"].device
    x = transformer.embed_tokens(planes[1], torch.as_tensor(tokens), cfg)
    for i in range(cfg.n_layers):
        lps = [transformer.layer_params(p, i) for p in planes]
        xb = x.to(torch.bfloat16)
        ins = (xb.to(dev), xb.float())
        outs = [attend(lp["attn"], rms_norm(xi, lp["ln1"], cfg.norm_eps), i,
                       plane)
                for plane, (lp, xi) in enumerate(zip(lps, ins))]
        rel = _rel_err(f"moe reference {label} layer {i} attention", *outs)
        stats["attention"][label] = max(stats["attention"].get(label, 0.0),
                                        rel)
        mid = ins[1] + outs[1]
        h = rms_norm(mid, lps[1]["ln2"], cfg.norm_eps)
        stats["dropped"][label] = stats["dropped"].get(label, 0) + \
            _moe_block(cfg, lps[0]["moe"], lps[1]["moe"],
                       h.to(torch.bfloat16), f"{label} layer {i}", stats)
        x = mid + moe.moe_apply(lps[1]["moe"], h, cfg, cfg.moe_cf_eval)[0]


def _moe_block(cfg, lg, lc, hb, label, stats) -> int:
    """The expert block on the card (``lg``, bf16) and on the CPU (``lc``,
    f32) from the same bf16 input ``hb`` (B, S, D), at the serving
    capacity of B * S rows: the chosen experts must agree wherever the
    k-th gate's margin over the (k+1)-th exceeds ``MOE_MARGIN`` (flips
    below it are counted), and the outputs within ``TOL`` of the largest
    on every row whose experts and kept pairs agree.  Returns the pairs
    the CPU dropped."""
    import torch
    from repro_torch.models import moe

    t, k = hb.shape[0] * hb.shape[1], cfg.top_k
    cap = moe._capacity(t, cfg, cfg.moe_cf_eval)
    xg = hb.to(lg["router"].device).reshape(t, -1)
    xc = hb.float().reshape(t, -1)
    rg = moe.route(lg["router"], xg, cfg, cap)
    rc = moe.route(lc["router"], xc, cfg, cap)
    gates = rc["gates"].sort(-1, descending=True).values
    margin = gates[:, k - 1] - gates[:, k]
    same = (rg["top_e"].cpu().sort(-1).values
            == rc["top_e"].sort(-1).values).all(-1)
    if not same[margin > MOE_MARGIN].all():
        raise AssertionError(f"moe reference {label}: experts differ at "
                             f"margins {margin[~same].tolist()}")
    agree = same & (rg["keep"].cpu().view(t, k)
                    == rc["keep"].view(t, k)).all(-1)
    yg = moe.moe_apply(lg, xg[None], cfg, cfg.moe_cf_eval)[0][0]
    yc = moe.moe_apply(lc, xc[None], cfg, cfg.moe_cf_eval)[0][0]
    stats["experts"] = max(stats["experts"], _rel_err(
        f"moe reference {label} experts", yg.float().cpu()[agree],
        yc[agree]))
    stats["flips"] += int((~same).sum())
    stats["near"] += int((margin <= MOE_MARGIN).sum())
    stats["rows"] += t
    stats["checked"] += int(agree.sum())
    return int((~rc["keep"]).sum())


def _rel_err(name, got, ref) -> float:
    """max |got - ref| / max |ref| (``got`` finite), asserted within
    ``TOL``."""
    import torch
    got = got.float().cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    if not torch.isfinite(got).all() or not rel <= TOL:
        raise AssertionError(f"{name}: rel err {rel} > {TOL}")
    return rel


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


def _reference_context() -> None:
    """A 2 + 2-layer encoder-decoder at seamless-m4t-large-v2's widths
    (d=1024, 16 heads of 64, d_ff 8192 with GELU biases, a 1024-frame
    context; V 256206 -> 1024) and a one-group vision model at
    llama-3.2-vision-11b's heads (2 self layers and 1 gated cross layer,
    32 q / 8 kv of 128, a 1600-row context; d 4096 -> 1024, d_ff 14336 ->
    2048, V 128256 -> 1024), norms, biases and gates filled, unit-normal
    contexts: a 37-token prefill and 8 decode steps (teacher-forced on the
    CPU's greedy picks) in bf16 on the card through flash (non-causal over
    the encoder and the contexts) and the decode kernel (the cross layers
    at ``cache_len = S_ctx``), against f32 on the CPU through the plain
    versions."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    for cfg, what in (
            (ModelConfig(name="seamless-heads", family="encdec", n_layers=2,
                         encoder_layers=2, d_model=1024, n_heads=16,
                         n_kv_heads=16, d_ff=8192, vocab_size=1024,
                         mlp="gelu", n_context_tokens=1024),
             "2 + 2-layer encoder-decoder, seamless-m4t-large-v2's widths "
             "(d 1024, 16 heads of 64, d_ff 8192, GELU with biases; cut: "
             "24 + 24 layers -> 2 + 2, V 256206 -> 1024), a 1024-frame "
             "context"),
            (ModelConfig(name="vision-heads", family="vlm", n_layers=2,
                         d_model=1024, n_heads=32, n_kv_heads=8,
                         head_dim=128, d_ff=2048, vocab_size=1024,
                         mlp="swiglu", rope_theta=5e5, cross_attn_every=2,
                         n_context_tokens=1600),
             "one vision group (2 self + 1 gated cross layer), "
             "llama-3.2-vision-11b's heads (32 q / 8 kv of 128; cut: 40 + "
             "8 layers -> 2 + 1, d 4096 -> 1024, d_ff 14336 -> 2048, V "
             "128256 -> 1024), a 1600-row context")):
        model = build_model(cfg)
        p_cpu = _filled(model.init(torch.Generator().manual_seed(SEED)),
                        SEED + 1)
        p_gpu = _tree(p_cpu, lambda t: t.to(dev))
        p_ref = _tree(p_cpu, lambda t: t.float())
        rng = np.random.default_rng(SEED + 18)
        prompt = rng.integers(0, cfg.vocab_size, (1, 37)).astype(np.int32)
        ctx = torch.from_numpy(rng.standard_normal(
            (1, cfg.n_context_tokens, cfg.d_model)).astype(np.float32))
        ctx_gpu = ctx.to(dev).to(torch.bfloat16)
        ctx_ref = ctx_gpu.cpu().float()  # the same values, widened
        compare = Compare(f"{cfg.name} reference")
        flash, decode = (fa.flash_attention.launches,
                         da.decode_attention.launches)
        lg, cg = model.prefill(p_gpu, torch.as_tensor(prompt, device=dev),
                               max_len=64, ctx=ctx_gpu)
        lr, cr = model.prefill(p_ref, torch.as_tensor(prompt), max_len=64,
                               ctx=ctx_ref)
        compare("prefill", lg, lr)
        tok = model.sample_greedy(lr)
        for i in range(8):
            lg, cg = model.decode_step(p_gpu, tok.to(dev), cg)
            lr, cr = model.decode_step(p_ref, tok, cr)
            compare(f"decode step {i}", lg, lr)
            tok = model.sample_greedy(lr)
        per_prefill, per_round = context_launches(cfg)
        ran = (fa.flash_attention.launches - flash,
               da.decode_attention.launches - decode)
        if ran != (per_prefill, 8 * per_round):
            raise AssertionError(f"{cfg.name} reference: (flash, decode) "
                                 f"launches {ran}")
        log(f"reference: {what}, prefill of 37 tokens + 8 decode steps on "
            f"the card within {compare.worst:.4f} (limit {REF_TOL}) of f32 "
            f"on the CPU; launches (flash, decode) {ran}")


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

# {shards: (weight bytes, slot-pool bytes at 8 x 1024)} a member of each
# pod holds at the depth the smoke serves it (``POD_LAYERS`` where it is
# cut), as JAX's ``per_device_bytes`` counts the params it places by
# ``serve_pspec`` and the pool its engine places by ``resolve_pspec``
# (bf16 weights; the pool's per-slot ``pos`` included).  hymba's pool is
# whole on every member: neither its 5 kv heads nor its 25 SSM heads
# divide 2 or 4.
POD_MEMBER_BYTES = {
    "rwkv6-1.6b": {1: (3_167_887_360, 102_236_192),
                   2: (2_144_477_184, 51_904_544),
                   4: (1_632_772_096, 26_738_720)},
    "hymba-1.5b": {1: (2_702_673_600, 361_758_752),
                   2: (1_839_646_400, 361_758_752),
                   4: (1_408_132_800, 361_758_752)},
    # mixtral-8x7b at POD_LAYERS depth (8 of 32 layers): every member
    # holds every expert's w_down whole (tests/test_torch_mixtral.py)
    MIXTRAL_ARCH: {1: (23_745_142_784, 268_435_488),
                   2: (15_765_479_424, 134_217_760),
                   4: (11_775_647_744, 67_108_896)}}
HYBRID_PARAMS = 1_351_336_800    # hymba-1.5b, as the JAX package counts
HYBRID_DENSE_BYTES = 361_758_724  # its dense_kv_bytes(8, 1024): rolled
#                                   K/V of 1024 rows + the f32 SSM state
STARCODER_SIZES = (15_957_145_600,  # starcoder2-15b params, as JAX counts
                   671_088_644,     # dense_kv_bytes(8, 1024), bf16
                   340_787_204,     # the same, int8 KV
                   1_310_720,       # kv_block_bytes(16), bf16
                   665_600)         # the same, int8 KV
GEMMA_SIZES = (27_008_319_744,  # gemma3-27b params, as JAX counts
               5_502_926_852)   # dense_kv_bytes(8, 2048): (62 rolled x 1024
#                                 + 10 global x 2048 rows) x 8 x 16 x 128
#                                 x 2 B x (K, V) + the int32 pos
GEMMA_MAX_LEN = 2048
MOE_SIZES = (14_315_784_192,  # qwen2-moe-a2.7b params, as JAX's specs count
             28_637_466_624,  # its weight bytes (bf16, the f32 router)
             1_610_612_740)   # dense_kv_bytes(8, 1024), bf16
MIXTRAL_SIZES = (46_702_792_704,  # mixtral-8x7b params, as JAX's specs count
                 93_407_682_560,  # its weight bytes (bf16, the f32 router)
                 1_073_741_828,   # dense_kv_bytes(8, 1024), bf16
                 4_294_967_300)   # dense_kv_bytes(8, 4608): C = 4096 rows
MIXTRAL_WINDOW = dict(max_len=4352, prompt=4160, new_tokens=64, requests=2)
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

    t_arch = t0 = time.perf_counter()
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
    streams = dense_modes(model, params, ARCH, prompts, alloc, totals)
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
    spec_phase(model, params, alloc, prompts, streams, totals)
    pod_phase(model, params, prompts, totals)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve: {ARCH} phases took {time.perf_counter() - t_arch:.1f}s")

    t_arch = time.perf_counter()
    starcoder2_phase(prompts, alloc, totals)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve: {STARCODER_ARCH} phase took "
        f"{time.perf_counter() - t_arch:.1f}s")
    t_arch = time.perf_counter()
    gemma3_phase(alloc, totals)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve: {GEMMA_ARCH} phase took {time.perf_counter() - t_arch:.1f}s")
    t_arch = time.perf_counter()
    qwen2_moe_phase(prompts, alloc, totals)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve: {MOE_ARCH} phase took {time.perf_counter() - t_arch:.1f}s")
    t_arch = time.perf_counter()
    mixtral_phase(prompts, alloc, totals)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve: {MIXTRAL_ARCH} phase took "
        f"{time.perf_counter() - t_arch:.1f}s")
    for arch in (SEAMLESS_ARCH, VISION_ARCH):
        context_phase(arch, prompts, totals)
        gc.collect()
        torch.cuda.empty_cache()

    # -- rwkv6-1.6b, the same request mix, after gemma3-27b is freed ------
    t_arch = t0 = time.perf_counter()
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
    sampled_check(model, params, RWKV_ARCH, rwkv_prompts[:SAMPLED_REQUESTS],
                  alloc, "continuous")
    pod_family(model, staged_store(model, params, RWKV_ARCH), RWKV_ARCH,
               rwkv_prompts, totals, ("continuous",))

    # -- hymba-1.5b, the same request mix, after rwkv6-1.6b is freed ------
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve: {RWKV_ARCH} phase took {time.perf_counter() - t_arch:.1f}s")
    t_arch = t0 = time.perf_counter()
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
    sampled_check(model, params, HYBRID_ARCH,
                  hybrid_prompts[:SAMPLED_REQUESTS], alloc, "continuous")
    pod_family(model, staged_store(model, params, HYBRID_ARCH), HYBRID_ARCH,
               hybrid_prompts, totals, ("continuous",))
    log(f"serve: {HYBRID_ARCH} phase took "
        f"{time.perf_counter() - t_arch:.1f}s")
    return totals


def dense_modes(model, params, arch, prompts, alloc, totals) -> dict:
    """A full-cache dense config's four serve modes (``serve_mode``):
    continuous, paged, int8 continuous, int8 paged; continuous and paged
    must emit the same greedy streams, bf16 and int8 alike.  Returns the
    streams by mode."""
    streams = {}
    for mode, int8, kernel in [
            ("continuous", False, "decode_attention"),
            ("paged", False, "paged_decode_attention"),
            ("int8 continuous", True, "decode_attention_quant"),
            ("int8 paged", True, "paged_decode_attention_quant")]:
        streams[mode] = serve_mode(model, params, arch, prompts, alloc, mode,
                                   {"flash_attention", kernel}, totals,
                                   int8=int8)
    for a, b in [("continuous", "paged"), ("int8 continuous", "int8 paged")]:
        if streams[a] != streams[b]:
            raise AssertionError(f"{arch}: {a} and {b} greedy streams differ")
        log(f"serve {arch}: {a} and {b} emit identical greedy streams")
    return streams


def starcoder2_phase(qwen_prompts, alloc, totals) -> None:
    """starcoder2-15b at full width (40 layers, d=6144, 48 q / 4 kv heads
    of 128, GELU MLP with biases) on the serve mix, as qwen2-7b's four
    modes run: continuous, paged, int8 continuous and int8 paged, each
    through its graphs and against ``fused=False``; continuous and paged
    streams equal, bf16 and int8 alike; then a profile window."""
    import torch
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    model, params = serve.init_model(STARCODER_ARCH, reduced=False,
                                     seed=SEED)
    torch.cuda.synchronize()
    cfg = model.cfg
    sizes = (model.n_params(), model.dense_kv_bytes(8, 1024, False),
             model.dense_kv_bytes(8, 1024, True),
             model.kv_block_bytes(16, False), model.kv_block_bytes(16, True))
    if sizes != STARCODER_SIZES:
        raise AssertionError(f"{STARCODER_ARCH} (params, dense bf16 / int8, "
                             f"block bf16 / int8 bytes): {sizes}")
    log(f"serve: {STARCODER_ARCH} full width ({cfg.n_layers}L "
        f"d={cfg.d_model} H={cfg.n_heads} K={cfg.n_kv_heads} D={cfg.dh} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size}, {cfg.mlp} MLP with biases), "
        f"{model.n_params()} params, drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s; (params, dense_kv_bytes(8, 1024) "
        f"bf16 / int8, kv_block_bytes(16) bf16 / int8) = {sizes}")
    prompts = [p % cfg.vocab_size for p in qwen_prompts]
    dense_modes(model, params, STARCODER_ARCH, prompts, alloc, totals)
    round_check(model, params, STARCODER_ARCH, prompts[:8], alloc)
    profile_window(model, params, prompts[:8], alloc, STARCODER_ARCH)


def gemma3_prompts(vocab: int) -> list:
    """16 prompts, short and long in turns so both instances get both: 8
    of 64-512 tokens and 8 of 1100-1900, past the window of 1024."""
    rng = np.random.default_rng(SEED + 10)
    short, long = rng.integers(64, 513, 8), rng.integers(1100, 1901, 8)
    lens = [int(n) for pair in zip(short, long) for n in pair]
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def gemma3_phase(alloc, totals) -> None:
    """gemma3-27b at full width (62 layers, d=5376, 32 q / 16 kv heads of
    128, GeGLU, tied embeddings; 52 local layers of window 1024 and 10
    global ones on dual caches), continuous, ``max_len=2048``: its param
    count and slot-pool bytes against the constants reckoned from JAX's
    layout, the serve run through the graphs (flash 62 times a prefill,
    the decode kernel 10 times a round, on the global layers) against
    ``fused=False``, one round replayed == eager bit for bit, the rolled
    decode's and the round's device time beside the weights' bytes, a
    profile window and a sampled check.  Then its widths at
    ``POD_LAYERS`` layers on one instance and as 2- and 4-member pods
    (``pod_family``)."""
    import gc
    import torch
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    model, params = serve.init_model(GEMMA_ARCH, reduced=False, seed=SEED)
    torch.cuda.synchronize()
    cfg = model.cfg
    sizes = (model.n_params(), model.dense_kv_bytes(8, 2048))
    if sizes != GEMMA_SIZES:
        raise AssertionError(f"{GEMMA_ARCH} (params, dense_kv_bytes(8, "
                             f"2048)): {sizes}, reckoned {GEMMA_SIZES}")
    n_global = sum(cfg.is_global_layer(i) for i in range(cfg.n_layers))
    log(f"serve: {GEMMA_ARCH} full width ({cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} D={cfg.dh} d_ff={cfg.d_ff} "
        f"V={cfg.vocab_size}, {cfg.mlp}, {cfg.n_layers - n_global} local "
        f"layers of window {cfg.sliding_window} + {n_global} global), "
        f"{model.n_params()} params, drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s; dense_kv_bytes(8, 2048) = "
        f"{sizes[1]} (62 rolled layers x 1024 rows + 10 global x 2048, as "
        f"JAX lays them out)")
    prompts = gemma3_prompts(cfg.vocab_size)
    streams = serve_mode(model, params, GEMMA_ARCH, prompts, alloc,
                         "continuous", {"flash_attention", "decode_attention"},
                         totals, max_len=GEMMA_MAX_LEN,
                         layers={"decode_attention": n_global})
    log(f"serve {GEMMA_ARCH}: distinct tokens per stream "
        f"{[len(set(x)) for x in streams]}, the prompt's last token repeated "
        f"in {sum(x == [int(p[-1])] * len(x) for x, p in zip(streams, prompts))}"
        f" of {len(streams)} (logged: random tied weights, whose head scores "
        f"the input token's own embedding highest)")
    round_check(model, params, GEMMA_ARCH, prompts[:8], alloc,
                max_len=GEMMA_MAX_LEN)
    profile_window(model, params, prompts[:8], alloc, GEMMA_ARCH,
                   "continuous", max_len=GEMMA_MAX_LEN)
    sampled_check(model, params, GEMMA_ARCH, prompts[:SAMPLED_REQUESTS],
                  alloc, "continuous", max_len=GEMMA_MAX_LEN)
    # Its widths as pods at ``POD_LAYERS`` layers: the layers' leading
    # slices staged, the full tree freed.
    cut, cut_params = depth_cut(model, params, POD_LAYERS[GEMMA_ARCH])
    store = staged_store(cut, cut_params, GEMMA_ARCH)
    del params, cut_params
    gc.collect()
    torch.cuda.empty_cache()
    n_global = sum(cut.cfg.is_global_layer(i) for i in range(
        cut.cfg.n_layers))
    log(f"pod {GEMMA_ARCH}: depth cut to {cut.cfg.n_layers} of "
        f"{cfg.n_layers} layers (POD_LAYERS: {cut.cfg.n_layers - n_global} "
        f"local + {n_global} global)")
    pod_family(cut, store, GEMMA_ARCH, prompts, totals, ("continuous",),
               max_len=GEMMA_MAX_LEN)


def qwen2_moe_phase(qwen_prompts, alloc, totals) -> None:
    """qwen2-moe-a2.7b at full width (24 layers, d=2048, 16 q / 16 kv heads
    of 128, 60 routed experts top-4 of d_ff 1408 and 4 shared, an f32
    router) on the serve mix, with its param count, weight bytes and
    slot-pool bytes against the constants reckoned from JAX's specs: the
    four modes of qwen2-7b (``dense_modes``: continuous == paged, graph ==
    ``fused=False``), one round replayed == eager bit for bit with the
    round's device time beside three bounds and split into the expert
    FFN, the dispatch and the rest (``round_check``), a paged profile
    window, speculation continuous and paged with the 2-layer draft of
    views (``spec_phase``), and the sampled checks.  Then its widths at
    ``POD_LAYERS`` layers on one instance and as 2- and 4-member pods,
    continuous and paged (``pod_family``)."""
    import gc
    import torch
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    model, params = serve.init_model(MOE_ARCH, reduced=False, seed=SEED)
    torch.cuda.synchronize()
    cfg = model.cfg
    sizes = (model.n_params(), pytree_nbytes(params),
             model.dense_kv_bytes(8, 1024, False))
    if sizes != MOE_SIZES:
        raise AssertionError(f"{MOE_ARCH} (params, weight bytes, "
                             f"dense_kv_bytes(8, 1024)): {sizes}, reckoned "
                             f"{MOE_SIZES}")
    log(f"serve: {MOE_ARCH} full width ({cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} D={cfg.dh} V={cfg.vocab_size}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.expert_d_ff} "
        f"+ {cfg.n_shared_experts} shared, router "
        f"{params['layers']['moe']['router'].dtype}), {sizes[0]} params, "
        f"{sizes[1]} bytes, drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s; dense_kv_bytes(8, 1024) bf16 / "
        f"int8 {sizes[2]} / {model.dense_kv_bytes(8, 1024, True)}, "
        f"kv_block_bytes(16) bf16 / int8 {model.kv_block_bytes(16, False)} "
        f"/ {model.kv_block_bytes(16, True)}")
    prompts = [p % cfg.vocab_size for p in qwen_prompts]
    streams = dense_modes(model, params, MOE_ARCH, prompts, alloc, totals)
    round_check(model, params, MOE_ARCH, prompts[:8], alloc)
    profile_window(model, params, prompts[:8], alloc, MOE_ARCH)
    spec_phase(model, params, alloc, prompts, streams, totals, MOE_ARCH)
    cut, cut_params = depth_cut(model, params, POD_LAYERS[MOE_ARCH])
    store = staged_store(cut, cut_params, MOE_ARCH)
    del params, cut_params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"pod {MOE_ARCH}: depth cut to {cut.cfg.n_layers} of "
        f"{cfg.n_layers} layers (POD_LAYERS)")
    pod_family(cut, store, MOE_ARCH, prompts, totals,
               ("continuous", "paged"))


def moe_round(model, params, round_dev: float) -> None:
    """A moe round's device time beside three bounds at the card's rate:
    every weight the round reads (all but the embedding table), the
    expert weights alone (the batched product reads every expert whatever
    the routing) and the active weights (``active_param_count``: top-k
    routed plus shared).  Then its split: the expert FFN (three batched
    products and the activation), the dispatch (router, rank, bucket
    scatter, gather, combine and the aux loss) and the shared experts
    where the config has them, each timed alone at the round's shapes (B
    = 8 tokens, capacity ``moe._capacity(8)``) on every layer's weights,
    and the rest."""
    import functools
    import torch
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.models import moe, transformer

    cfg, n = model.cfg, model.cfg.n_layers
    blocks = params["layers"]["moe"]
    nbytes = {"every weight a round reads (all but the embedding)":
              pytree_nbytes(params) - pytree_nbytes(params["embed"]),
              "the expert weights": sum(pytree_nbytes(blocks[k]) for k in
                                        ("w_gate", "w_up", "w_down")),
              "the active weights (2 x active_param_count)":
              2 * cfg.active_param_count()}
    log(f"round {model.cfg.name}: device {round_dev:.4f} ms against " +
        "; ".join(f"{name} {b} bytes: {b / PEAK_BYTES * 1e3:.4f} ms "
                  f"({round_dev / (b / PEAK_BYTES * 1e3):.2f}x)"
                  for name, b in nbytes.items()))
    t = 8
    cap = moe._capacity(t, cfg, cfg.moe_cf_eval)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xt = torch.randn((t, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    lps = [transformer.layer_params(params, i)["moe"] for i in range(n)]
    ins = [moe.dispatch(xt, moe.route(lp["router"], xt, cfg, cap), cfg, cap)
           for lp in lps]
    flats = [moe.experts(lp, e_in) for lp, e_in in zip(lps, ins)]

    def dispatch(i):
        r = moe.route(lps[i]["router"], xt, cfg, cap)
        moe.dispatch(xt, r, cfg, cap)
        moe.aux_loss(r, cfg)
        return moe.combine(flats[i], r)

    parts = {
        "expert FFN": [functools.partial(moe.experts, lps[i], ins[i])
                       for i in range(n)],
        "dispatch": [functools.partial(dispatch, i) for i in range(n)]}
    if cfg.n_shared_experts:
        parts["shared experts"] = [functools.partial(
            moe._shared, lps[i]["shared"], xt) for i in range(n)]
    ms = {name: n * device_ms(calls, iters=2 * n,
                              label=f"{name} (one layer)")
          for name, calls in parts.items()}
    rest = round_dev - ms["expert FFN"] - ms["dispatch"]
    log(f"round {model.cfg.name} split (device ms a round, each part "
        f"timed alone on all {n} layers at T={t}, cap {cap}): " +
        "; ".join(f"{name} {v:.4f} ({v / round_dev:.3f})"
                  for name, v in ms.items()) +
        f"; the rest (attention, norms, head, shared experts, launches) "
        f"{rest:.4f} ({rest / round_dev:.3f})")


def mixtral_phase(qwen_prompts, alloc, totals) -> None:
    """mixtral-8x7b at its full widths (d=4096, 32 q / 8 kv heads of 128, 8
    experts of d_ff 14336 top-2, window 4096 on a rolled cache of every
    layer, V=32000), on one card at ``POD_LAYERS`` depth (8 of 32 layers:
    all 32 take 93.4 GB, which ``scripts/mixtral_pod_cards.py`` serves as
    a pod over two cards).  The full config's params, weight bytes and
    slot-pool bytes, reckoned from its specs on the meta device, must
    equal ``MIXTRAL_SIZES``.  The cut, drawn on the card, serves the mix
    on two weight-shared instances, continuous, graph == ``fused=False``
    (``serve_mode``; exact-length prefills, flash once a layer, no kernel
    a round); one round replayed == eager bit for bit, its device time
    beside its bounds and split into the expert FFN, the dispatch and the
    rest (``round_check``); a profile window; the window crossed
    (``mixtral_window``); then the cut as 1-, 2- and 4-member pods,
    continuous (``pod_family``)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    full = build_model(get_config(MIXTRAL_ARCH))
    cfg = full.cfg
    sizes = (full.n_params(), pytree_nbytes(dryrun.meta_params(full)),
             full.dense_kv_bytes(8, 1024, False),
             full.dense_kv_bytes(8, 4608, False))
    if sizes != MIXTRAL_SIZES:
        raise AssertionError(f"{MIXTRAL_ARCH} (params, weight bytes, "
                             f"dense_kv_bytes(8, 1024), (8, 4608)): "
                             f"{sizes}, reckoned {MIXTRAL_SIZES}")
    layers = POD_LAYERS[MIXTRAL_ARCH]
    model = build_model(dataclasses.replace(cfg, n_layers=layers))
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"serve: {MIXTRAL_ARCH} full widths ({cfg.n_layers}L d="
        f"{cfg.d_model} H={cfg.n_heads} K={cfg.n_kv_heads} D={cfg.dh} "
        f"V={cfg.vocab_size}, {cfg.n_experts} experts top-{cfg.top_k} of "
        f"d_ff {cfg.expert_d_ff}, window {cfg.sliding_window}): (params, "
        f"weight bytes, dense_kv_bytes(8, 1024), (8, 4608)) = {sizes} "
        f"reckoned on the meta device; depth cut to {layers} of "
        f"{cfg.n_layers} layers (POD_LAYERS), {model.n_params()} params, "
        f"{pytree_nbytes(params)} bytes, drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    prompts = [p % cfg.vocab_size for p in qwen_prompts]
    serve_mode(model, params, MIXTRAL_ARCH, prompts, alloc, "continuous",
               {"flash_attention"}, totals)
    round_check(model, params, MIXTRAL_ARCH, prompts[:8], alloc)
    profile_window(model, params, prompts[:8], alloc, MIXTRAL_ARCH,
                   "continuous")
    mixtral_window(model, params, alloc, totals)
    log(f"pod {MIXTRAL_ARCH}: host MemAvailable {host_mem_available()} "
        f"bytes before staging {pytree_nbytes(params)}")
    store = staged_store(model, params, MIXTRAL_ARCH)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    pod_family(model, store, MIXTRAL_ARCH, prompts, totals, ("continuous",),
               forced=True)


def mixtral_window(model, params, alloc, totals) -> None:
    """mixtral's cut past its window (``MIXTRAL_WINDOW``): one instance at
    ``max_len`` 4352, a rolled cache of C = 4096 rows a layer, serves 2
    requests of 4160 prompt tokens x 64 new ones.  Each prefill's
    windowed flash must leave the oldest keys out of its last rows:
    in every flash call of the prefills (``_WindowProbe``), its last
    row, which leaves out 64 keys, differs from the windowless plain
    version by more than any row past the window differs from the
    windowed one.  The prefill keeps the last 4096 rows rolled by 64;
    decode writes positions 4160-4223 to slots 64-127.  flash must run
    once a layer a prefill and no kernel a round.  The served first
    tokens, and the logits of both prefills and of one round from their
    pool (``pod_logits``), are held against the same weights through the
    plain versions on the card (``_PlainOps``) with the kernels' experts
    (``routed_as``): logits within ``REF_TOL``, a first token other only
    at a near-tie; the plain versions' own choice on the kernels'
    experts differs from them only at near-ties (``routing_ties``).
    Then one round at the window replayed == eager bit for bit, with the
    rolled attention's device time at C = 4096 (``round_check``)."""
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    cfg, win = model.cfg, MIXTRAL_WINDOW
    rng = np.random.default_rng(SEED + 16)
    prompts = [rng.integers(0, cfg.vocab_size, win["prompt"]).astype(
        np.int32) for _ in range(win["requests"])]
    engine = deploy(model, params, MIXTRAL_ARCH, alloc, "continuous",
                    n_instances=1, max_len=win["max_len"],
                    max_batch=win["requests"])
    (inst,) = engine.instances.values()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    reqs, done, wall = serve.drive(engine, MIXTRAL_ARCH, prompts,
                                   win["new_tokens"])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rows = inst.cache["k"].shape[2]  # the pool, made at the first admission
    if rows != cfg.sliding_window:
        raise AssertionError(f"window: a rolled cache of {rows} rows, the "
                             f"window {cfg.sliding_window}")
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.n_layers * len(prompts)
    if done != len(prompts) or counts != want or any(
            len(r.tokens_out) != win["new_tokens"] for r in reqs):
        raise AssertionError(f"window: served {done}, launches {counts}, "
                             f"expected {want}")
    for k in totals:
        totals[k] += counts[k]
    first = [r.tokens_out[0] for r in reqs]
    with _WindowProbe(cfg.sliding_window) as probe:
        routes, (pre, rnd, ker_first) = pod_routes(
            cfg, lambda: pod_logits(inst, prompts))
    with _PlainOps():
        own, (ref_pre, ref_rnd, _) = pod_routes(cfg, lambda: routed_as(
            routes, lambda: pod_logits(inst, prompts, ker_first)))
    routing, _ = routing_ties(f"window {MIXTRAL_ARCH}", cfg, routes, own,
                              len(prompts))
    ref = dict(pre=ref_pre, rnd=ref_rnd, first=ref_pre.argmax(-1).tolist())
    held = held_against(f"window {MIXTRAL_ARCH}", ref, first, pre, rnd,
                        whose="the plain versions' (routed as the "
                        "kernels')")
    last = win["prompt"] + win["new_tokens"] - 1
    log(f"window {MIXTRAL_ARCH} ({cfg.n_layers}L, max_len {win['max_len']}:"
        f" a rolled cache of {rows} rows a layer): {done} requests of "
        f"{win['prompt']} prompt tokens x {win['new_tokens']} new in "
        f"{wall:.3f}s; {probe.report(cfg.n_layers * len(prompts))}, "
        f"and decode wrote positions {win['prompt']}-{last} to "
        f"slots {win['prompt'] % rows}-{last % rows}; launches {counts}; "
        f"served first tokens {first} (the kernels' prefill argmax "
        f"{[int(t) for t in ker_first]}, the plain versions' on the card "
        f"{ref['first']}){held}{routing}")
    del engine, inst
    gc.collect()
    torch.cuda.empty_cache()
    round_check(model, params, MIXTRAL_ARCH, prompts, alloc,
                max_len=win["max_len"], max_batch=win["requests"],
                split=False)
    log(f"window {MIXTRAL_ARCH} took {time.perf_counter() - t0:.1f}s")


# --------------------------------------------------------------------------
# The encoder-decoder and vision families: JAX's model-level continuous
# loop (their prefill needs a context, and no engine request carries one)
# --------------------------------------------------------------------------

SEAMLESS_ARCH = "seamless-m4t-large-v2"
VISION_ARCH = "llama-3.2-vision-11b"
CONTEXT_SIZES = {  # (params, dense_kv_bytes(8, 1024)), as JAX's layout counts
    # 24 layers x 8 slots x (1024 self + 1024 cross rows) x 16 x 64 x 2 B
    # x (K, V) + the int32 pos
    SEAMLESS_ARCH: (1_632_675_840, 1_610_612_740),
    # (40 layers x 1024 self rows + 8 cross layers x 1600 rows) x 8 slots
    # x 8 x 128 x 2 B x (K, V) + the int32 pos
    VISION_ARCH: (11_520_053_264, 1_761_607_684)}
CONTEXT_SCALE = 0.02  # a context's scale, as tests/test_smoke_archs.py:20-27


def contexts(cfg, n: int, seed: int, scale: float = CONTEXT_SCALE) -> list:
    """``n`` random bf16 contexts (n_context_tokens, d_model) on the card
    from a numpy seed, one a request: the stubbed frontends' output."""
    import torch
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(
        (cfg.n_context_tokens, cfg.d_model)) * scale).astype(np.float32)
    ).to("cuda").to(torch.bfloat16) for _ in range(n)]


def context_launches(cfg) -> tuple[int, int]:
    """(flash launches a prefill, decode launches a round): seamless's
    encoder, decoder self and cross layers, then its self and cross
    layers; the vision model's self and cross layers, twice."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    n = cfg.n_layers + cfg.n_layers // cfg.cross_attn_every
    return n, n


class ContextLoop:
    """The model-level continuous loop of JAX's ``Model`` API for a model
    whose prefill needs a context: each request prefills alone at batch 1
    with its own context (exact length, eager: neither family buckets),
    is merged into a free slot of one ``max_batch``-slot pool, and
    ``decode_step_tokens`` rounds run over the pool with per-slot
    positions; a slot frees when its request has its tokens and refills
    at the next admission.  The rounds go through one ``RoundGraph``
    (``serving/graphs.py``: the first eager, the second captured, the rest
    replayed), and the host syncs once a round, to read its tokens."""

    def __init__(self, model, params, max_batch: int = 8,
                 max_len: int = 1024):
        import torch
        from repro_torch.serving.graphs import RoundGraph
        dev = params["embed"].device
        self.model, self.params, self.max_len = model, params, max_len
        self.pool = model.init_slot_cache(max_batch, max_len, dev)
        self.tok = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self.graph = RoundGraph(dev)

    def body(self):
        """One round over fixed buffers, written in place: the pools, the
        positions and the slot tokens."""
        new, advanced = self.model.decode_step_tokens(self.params, self.tok,
                                                      self.pool)
        self.pool["pos"].copy_(advanced["pos"])
        return self.tok.copy_(new)

    def state(self) -> dict:
        return {"slot tokens": self.tok, **self.pool}

    def admit(self, slot: int, prompt, ctx):
        """Prefill ``prompt`` ((S,) int32 on the card) over ``ctx`` into
        ``slot``; returns its logits (1, V) and first token (1,), on the
        card."""
        logits, entry = self.model.prefill(self.params, prompt[None],
                                           max_len=self.max_len,
                                           ctx=ctx[None])
        first = self.model.sample_greedy(logits)
        self.model.merge_slot(self.pool, entry, slot)
        self.tok[slot:slot + 1].copy_(first)
        return logits, first

    def serve(self, prompts, ctxs, new_tokens: int) -> tuple:
        """Serve every request, ``new_tokens`` tokens each (its prefill's,
        then one a round).  Returns (streams, prefill logits, (prompt
        length, start event, end event) of each prefill, rounds)."""
        import torch
        b = len(self.tok)
        queue = list(range(len(prompts)))
        slots = [None] * b
        rest = [[] for _ in prompts]
        firsts, logits, timing, rounds = [], [None] * len(prompts), [], 0
        while queue or any(r is not None for r in slots):
            for slot in range(b):
                if slots[slot] is None and queue:
                    r = queue.pop(0)
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    logits[r], first = self.admit(slot, prompts[r], ctxs[r])
                    end.record()
                    firsts.append((r, first))
                    timing.append((len(prompts[r]), start, end))
                    slots[slot] = r if new_tokens > 1 else None
            if all(r is None for r in slots):
                continue
            self.graph.run(self.body)
            rounds += 1
            got = self.tok.tolist()  # the round's one sync
            for slot, r in enumerate(slots):
                if r is not None:
                    rest[r].append(got[slot])
                    if len(rest[r]) == new_tokens - 1:
                        slots[slot] = None
        first = dict(zip([r for r, _ in firsts],
                         torch.cat([f for _, f in firsts]).tolist()))
        return ([[first[r]] + x for r, x in enumerate(rest)], logits, timing,
                rounds)


def check_streams(label, model, streams, logits, new_tokens) -> None:
    """Every stream has ``new_tokens`` tokens of the vocabulary, and its
    first is the greedy pick of its prefill logits (the argmax over the
    padded width, clipped to the vocabulary, as ``greedy_tokens``)."""
    vocab = model.cfg.vocab_size
    for i, (stream, lg) in enumerate(zip(streams, logits)):
        row = lg[0].float().cpu().numpy()
        if not np.isfinite(row).all():
            raise AssertionError(f"{label}: request {i}'s prefill logits "
                                 f"are not finite")
        pick = min(int(np.argmax(row)), vocab - 1)
        if (len(stream) != new_tokens or stream[0] != pick
                or min(stream) < 0 or max(stream) >= vocab):
            raise AssertionError(f"{label}: request {i}'s stream {stream} "
                                 f"(its prefill's greedy pick {pick})")


def reduced_context_serve() -> None:
    """seamless-m4t-large-v2's and llama-3.2-vision-11b's reduced configs
    (head dim 16, a 12-row context) on the card through ``ContextLoop``:
    6 requests of 8-20 tokens, 8 tokens each, on 4 slots (two refill),
    norms, biases and gates filled; the first tokens equal the prefills'
    greedy picks and the kernels ran once a layer and prefill or round;
    then 4 of the requests in one pool against each alone at batch 1,
    with a planted fault (``context_slots``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve

    rng = np.random.default_rng(SEED + 16)
    for arch in (SEAMLESS_ARCH, VISION_ARCH):
        model, params = serve.init_model(arch, reduced=True, seed=SEED)
        _filled(params, SEED + 1)
        cfg = model.cfg
        prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                                   dtype=torch.int32, device="cuda")
                   for n in rng.integers(8, 21, 6)]
        loop = ContextLoop(model, params, max_batch=4, max_len=64)
        kernels.reset_launch_counts()
        ctxs = contexts(cfg, 6, SEED + 17, scale=1.0)
        streams, logits, _, rounds = loop.serve(prompts, ctxs, 8)
        counts = kernels.launch_counts()
        check_streams(f"reduced {arch}", model, streams, logits, 8)
        per_prefill, per_round = context_launches(cfg)
        want = {k: 0 for k in counts}
        want.update(flash_attention=6 * per_prefill,
                    decode_attention=rounds * per_round)
        if counts != want or loop.graph.captures != 1:
            raise AssertionError(f"reduced {arch}: launches {counts}, "
                                 f"{loop.graph.captures} captures")
        log(f"reduced serve {arch} (head dim {cfg.dh}, context "
            f"{cfg.n_context_tokens} rows) on the card through the "
            f"model-level loop: 6 requests x 8 tokens on 4 slots, {rounds} "
            f"rounds ({loop.graph.replays} replayed); launches flash "
            f"{counts['flash_attention']}, decode "
            f"{counts['decode_attention']}")
        context_slots(model, params, f"reduced {arch}", prompts[:4],
                      ctxs[:4], 6, 64)


def context_round_bytes(params, pool, pos) -> dict:
    """What one round reads: the decoder's weights and head (not the
    embedding table, of which it reads 8 rows, nor the encoder or the
    cross layers' ``wk``/``wv``, which only prefill reads), each self
    layer's rows up to ``pos + 1`` and the whole context caches."""
    from repro_torch.core.model_sharing import pytree_nbytes
    weights = pytree_nbytes(params) - pytree_nbytes(params["embed"])
    for key in ("enc_layers", "enc_ln"):
        weights -= pytree_nbytes(params.get(key, {}))
    cross = (params["layers"]["xattn"] if "xattn" in params["layers"]
             else params["cross_layers"]["attn"])
    weights -= pytree_nbytes(cross["wk"]) + pytree_nbytes(cross["wv"])
    l, _, s, kv, dh = pool["k"].shape
    rows = int((pos.long() + 1).clamp(max=s).sum())
    return {"weights": weights, "self K/V rows": 2 * l * rows * kv * dh * 2,
            "context caches": pytree_nbytes(pool["cross_k"])
            + pytree_nbytes(pool["cross_v"])}


def context_round(loop, arch, prompts, ctxs) -> None:
    """Every slot of ``loop`` live (``prompts``): one round replayed from
    the loop's graph, and the eager round over the same state (copies
    restored between them), write the same slot tokens, positions, ``k``
    and ``v`` bit for bit and leave ``cross_k``/``cross_v`` as prefill
    wrote them.  Then the round's time by CUDA events and device time
    over 10 replays, beside the bytes it reads at the card's rate."""
    import torch

    for slot, (p, c) in enumerate(zip(prompts, ctxs)):
        loop.admit(slot, p, c)
    loop.graph.run(loop.body)
    start = {k: v.clone() for k, v in loop.state().items()}
    loop.graph.replay()
    replayed = {k: v.clone() for k, v in loop.state().items()}
    for k, v in loop.state().items():
        v.copy_(start[k])
    loop.body()
    torch.cuda.synchronize()
    diff = [k for k, v in loop.state().items()
            if not torch.equal(v, replayed[k])]
    written = sorted(k for k in loop.pool
                     if not torch.equal(start[k], replayed[k]))
    if diff or written != ["k", "pos", "v"]:
        raise AssertionError(f"round check {arch}: replay != eager in "
                             f"{diff}; leaves the round wrote: {written}")
    log(f"round check {arch} (8 live slots, prompts of "
        f"{sorted(len(p) for p in prompts)} tokens): the round replayed "
        f"from the loop's graph equals the eager round bit for bit in "
        f"{sorted(loop.state())}; cross_k and cross_v unwritten")
    for k, v in loop.state().items():
        v.copy_(start[k])
    nbytes = context_round_bytes(loop.params, loop.pool, start["pos"])
    total = sum(nbytes.values())
    replay = [loop.graph.replay]
    round_ms = time_ms(replay, iters=10)
    round_dev = device_ms(replay, iters=10, label=f"a {arch} round")
    bound_ms = total / PEAK_BYTES * 1e3
    log(f"round {arch}: {round_ms:.4f} ms a round by CUDA events, device "
        f"{round_dev:.4f} ms, over 10 replays; it reads {total} bytes ("
        + ", ".join(f"{k} {v}" for k, v in nbytes.items())
        + f"): {bound_ms:.4f} ms at {PEAK_BYTES / 1e12} TB/s, device time "
        f"{round_dev / bound_ms:.2f}x that")


def slot_logits(model, params, entries, streams, max_len: int,
                own=None, swap: bool = False):
    """Logits (n, steps, V) of ``len(entries)`` prefilled requests decoded
    teacher-forced on ``streams`` ((n, steps) tokens) in one pool of n
    slots.  With ``own`` the pool holds request ``own`` in every slot, only
    its slot's rows are returned ((1, steps, V)), and its row of
    ``streams`` past the first token is written with its greedy picks.
    ``swap`` plants a pool fault: slots 0 and 1 read each other's
    ``cross_k``/``cross_v``."""
    import torch
    n, dev = len(entries), params["embed"].device
    pool = model.init_slot_cache(n, max_len, dev)
    for slot in range(n):
        model.merge_slot(pool, entries[slot if own is None else own], slot)
    if swap:
        for key in ("cross_k", "cross_v"):
            pool[key][:, [0, 1]] = pool[key][:, [1, 0]]
    rows = []
    for step in range(streams.shape[1]):
        tok = (streams[:, step] if own is None
               else streams[own, step].expand(n).contiguous())
        logits, pool = model.decode_step(params, tok, pool)
        if own is not None:
            logits = logits[own:own + 1]
            if step + 1 < streams.shape[1]:
                streams[own, step + 1] = model.sample_greedy(logits)[0]
        rows.append(logits)
    return torch.stack(rows, 1)[:, :, :model.cfg.vocab_size].float()


def context_slots(model, params, label, prompts, ctxs, steps: int,
                  max_len: int) -> None:
    """Every slot of a pool reads its own context and positions.  Each
    request is prefilled at batch 1 and decoded ``steps`` rounds,
    teacher-forced on its own greedy stream, three ways: in one pool with
    the others (the loop's pool); in a pool of the same size holding only
    copies of it (its ``own`` pool: the same shapes, so the same kernels
    and summation order); and alone at batch 1.  Its slot of the shared
    pool must equal its own pool's bit for bit, and stay within
    ``SLOT_TOL`` of batch 1 (which sums in another order).  Then slots 0
    and 1 of the shared pool read each other's context caches, a planted
    fault that the bitwise comparison must see in both."""
    import torch
    n = len(prompts)
    entries, first = [], []
    for p, c in zip(prompts, ctxs):
        logits, entry = model.prefill(params, p[None], max_len=max_len,
                                      ctx=c[None])
        entries.append(entry)
        first.append(model.sample_greedy(logits))
    streams = torch.zeros(n, steps, dtype=torch.int32,
                          device=params["embed"].device)
    streams[:, 0] = torch.cat(first)
    own = torch.cat([slot_logits(model, params, entries, streams, max_len,
                                 own=r) for r in range(n)])
    alone = []
    for r in range(n):
        cache = _tree(entries[r], lambda t: t.clone())
        rows = []
        for step in range(steps):
            logits, cache = model.decode_step(
                params, streams[r, step:step + 1], cache)
            rows.append(logits[0, :model.cfg.vocab_size].float())
        alone.append(torch.stack(rows))
    alone = torch.stack(alone)
    shared = slot_logits(model, params, entries, streams, max_len)
    fault = slot_logits(model, params, entries, streams, max_len, swap=True)

    def rel(x, ref):  # per slot, the largest over its steps
        return ((x - ref).abs().amax((1, 2))
                / ref.abs().amax((1, 2))).tolist()

    exact = [torch.equal(shared[r], own[r]) for r in range(n)]
    batch1 = rel(shared, alone)
    planted = rel(fault, own)
    if not all(exact) or max(batch1) > SLOT_TOL:
        raise AssertionError(
            f"{label}: slots equal to their own pools {exact}, "
            f"(shared - own) {rel(shared, own)}; against batch 1 "
            f"{batch1} (limit {SLOT_TOL})")
    if min(planted[:2]) == 0 or max(planted[2:]) != 0:
        raise AssertionError(f"{label}: with slots 0 and 1's contexts "
                             f"swapped the slots read {planted} from their "
                             f"own pools: the check cannot see the fault")
    log(f"slots {label}: {n} requests in one pool, {steps} teacher-forced "
        f"rounds: every slot's logits equal its own pool's (the request in "
        f"all {n} slots) bit for bit; against batch 1 at most "
        f"{max(batch1):.6f} of the largest logit (limit {SLOT_TOL}; per "
        f"slot {[round(x, 6) for x in batch1]}); planted fault (slots 0 "
        f"and 1 swap cross_k/cross_v): they read "
        f"{[round(x, 6) for x in planted[:2]]} from their own pools "
        f"({int((fault[:2] != own[:2]).sum())} of {own[:2].numel()} logits "
        f"differ), the others 0, and "
        f"{[round(x, 6) for x in rel(fault, alone)[:2]]} from batch 1")


def context_phase(arch, qwen_prompts, totals) -> None:
    """seamless-m4t-large-v2 or llama-3.2-vision-11b at full width, random
    bf16 weights from the seed with the zero-initialised norms, biases and
    gates filled, through ``ContextLoop``: its params and slot-pool bytes
    against the constants reckoned from JAX's layout; a warm-up that
    captures the round; 16 requests (the serve mix's prompts, each with
    its own random context) x 32 tokens on 8 slots with ``max_len=1024``,
    with the launch counts and the peak memory reset just before and read
    just after (every round a replay; flash once a layer and prefill,
    the decode kernel once a layer and round); each first token the
    greedy pick of its prefill logits; one round replayed == eager
    (``context_round``); 8 requests in one pool against each in its own
    pool and alone at batch 1, with a planted fault (``context_slots``);
    a profile window (8 requests x 8 tokens)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve

    t_arch = t0 = time.perf_counter()
    model, params = serve.init_model(arch, reduced=False, seed=SEED)
    _filled(params, SEED + 1)
    torch.cuda.synchronize()
    cfg = model.cfg
    sizes = (model.n_params(), model.dense_kv_bytes(8, 1024))
    if sizes != CONTEXT_SIZES[arch]:
        raise AssertionError(f"{arch} (params, dense_kv_bytes(8, 1024)): "
                             f"{sizes}, reckoned {CONTEXT_SIZES[arch]}")
    log(f"serve: {arch} full width ({cfg.family}: {cfg.n_layers}L"
        + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers
           else f", a cross layer after every {cfg.cross_attn_every}")
        + f", d={cfg.d_model} H={cfg.n_heads} K={cfg.n_kv_heads} D={cfg.dh} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size}, {cfg.mlp}, context "
        f"{cfg.n_context_tokens} x {cfg.d_model}), {sizes[0]} params, drawn "
        f"on the card in {time.perf_counter() - t0:.1f}s; "
        f"dense_kv_bytes(8, 1024) = {sizes[1]}")
    prompts = [torch.as_tensor(p % cfg.vocab_size, device="cuda")
               for p in qwen_prompts]
    ctxs = contexts(cfg, len(prompts), SEED + 15)
    loop = ContextLoop(model, params)
    loop.serve(prompts[:8], ctxs[:8], 3)  # an eager round, then a capture
    if loop.graph.captures != 1 or loop.graph.eager_rounds != 1:
        raise AssertionError(f"{arch}: warm-up left {loop.graph.captures} "
                             f"captures")
    replays0 = loop.graph.replays
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    streams, logits, timing, rounds = loop.serve(prompts, ctxs, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())
    replayed = loop.graph.replays - replays0
    per_prefill, per_round = context_launches(cfg)
    want = {k: 0 for k in counts}
    want.update(flash_attention=len(prompts) * per_prefill,
                decode_attention=rounds * per_round)
    if counts != want or replayed != rounds or loop.graph.captures != 1:
        raise AssertionError(f"{arch}: launches {counts}, expected {want}; "
                             f"{replayed} of {rounds} rounds replayed")
    check_streams(arch, model, streams, logits, 32)
    for k in totals:
        totals[k] += counts[k]
    prefill_ms = sorted((n, round(a.elapsed_time(b), 3))
                        for n, a, b in timing)
    n_tok = sum(len(x) for x in streams)
    log(f"serve {arch}: {len(streams)} requests, {n_tok} tokens in "
        f"{wall:.3f}s = {n_tok / wall:.1f} tokens/s; {rounds} rounds, all "
        f"replayed (1 capture, in the warm-up), 1 sync a round; launches a "
        f"prefill: flash {per_prefill}; a round: flash 0, decode "
        f"{per_round}; launches {counts}; peak device memory allocated "
        f"{peak[0]}, reserved {peak[1]} bytes; each first token the greedy "
        f"pick of its prefill logits")
    log(f"serve {arch}: prefill ms by prompt length (CUDA events; exact "
        f"length, eager, the context encoded or projected each time): "
        f"{prefill_ms}")
    log(f"serve {arch}: distinct tokens per stream "
        f"{[len(set(x)) for x in streams]} (logged: random weights)")
    context_round(loop, arch, prompts[:8], ctxs[:8])
    context_slots(model, params, arch, prompts[:8], ctxs[:8], 4, 1024)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.serve(prompts[:8], ctxs[:8], 8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_profile(raw_events(prof, host=False), arch, "8 requests x 8 "
                   "tokens through the model-level loop (8 eager "
                   "prefills, 7 replayed rounds)", wall)
    log(f"serve: {arch} phase took {time.perf_counter() - t_arch:.1f}s")


def round_check(model, params, arch, prompts, alloc, max_len=1024,
                max_batch=8, split=True) -> None:
    """One continuous round of a one-instance engine with every slot live
    (``prompts``, one a slot of ``max_batch``; gemma3's, half of them past
    the window; mixtral's at its window, all past it), replayed from
    the instance's graph against the eager round body over the same state
    (copies restored between them): slot tokens and every pool leaf
    (positions, ``k``/``v``, and gemma3's rolled ``k``/``v`` and
    ``global_k``/``global_v``), bit for bit.  Then the round's time by
    CUDA events and device time over replays, beside the weights' bytes at
    the card's rate, and for a windowed config the rolled decode
    attention's device time at the round's shapes, times the local layers
    that run it; a moe round's split (``moe_round``) where ``split``."""
    import torch
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.models import attention

    engine = deploy(model, params, arch, alloc, "continuous", n_instances=1,
                    max_len=max_len, max_batch=max_batch)
    for p in prompts:
        engine.submit(arch, p, max_new_tokens=16)
    (inst,) = engine.instances.values()
    for _ in range(3):  # admissions + eager round, capture, replay
        inst.run_step()
    rg = inst.round_graph
    if rg.captures != 1 or rg.replays != 2 or \
            inst.n_active() != inst.max_batch:
        raise AssertionError(f"round check: {inst.n_active()} live slots, "
                             f"{rg.captures} captures, {rg.replays} replays")

    def state():
        return {"slot tokens": inst._slot_tok_dev, **inst.cache}

    start = {k: v.clone() for k, v in state().items()}
    rg.replay()
    replayed = {k: v.clone() for k, v in state().items()}
    for k, v in state().items():
        v.copy_(start[k])
    inst._round_body()
    torch.cuda.synchronize()
    diff = [k for k, v in state().items() if not torch.equal(v, replayed[k])]
    kept = [k for k in inst.cache if torch.equal(start[k], replayed[k])]
    if diff or kept:
        raise AssertionError(f"round check: replay != eager in {diff}; "
                             f"pool leaves the round did not write: {kept}")
    log(f"round check {arch} continuous ({inst.n_active()} live slots, "
        f"prompts of {sorted(len(p) for p in prompts)} tokens): the round "
        f"replayed from the instance's graph equals the eager round body "
        f"bit for bit in {sorted(state())}")
    for k, v in state().items():
        v.copy_(start[k])
    replay = [rg.replay]
    round_ms, round_dev = time_ms(replay, iters=10), device_ms(
        replay, iters=10)
    weight_ms = pytree_nbytes(params) / PEAK_BYTES * 1e3
    log(f"round {arch}: {round_ms:.4f} ms a round by CUDA events, device "
        f"{round_dev:.4f} ms, over 10 replays; the weights' "
        f"{pytree_nbytes(params)} bytes at {PEAK_BYTES / 1e12} TB/s take "
        f"{weight_ms:.4f} ms")
    cfg = model.cfg
    if cfg.family == "moe" and split:
        moe_round(model, params, round_dev)
    if not cfg.sliding_window:
        return
    for k, v in state().items():
        v.copy_(start[k])
    n_local = sum(not cfg.is_global_layer(i) for i in range(cfg.n_layers))
    pools = inst.cache
    gen = torch.Generator(device=pools["k"].device).manual_seed(SEED)
    q = torch.randn((inst.max_batch, 1, cfg.n_heads, cfg.dh), generator=gen,
                    device=pools["k"].device).to(torch.bfloat16)
    rolled = [lambda i=i: attention._rolled_decode(
        q, pools["k"][i], pools["v"][i], pools["pos"], cfg.sliding_window)
        for i in range(2)]
    rolled_dev = device_ms(rolled, label="rolled decode attention")
    log(f"round {arch}: rolled decode attention (plain torch, "
        f"B={inst.max_batch} "
        f"C={pools['k'].shape[2]} H={cfg.n_heads} K={cfg.n_kv_heads} "
        f"D={cfg.dh}) {rolled_dev:.5f} ms device a layer x {n_local} local "
        f"layers = {rolled_dev * n_local:.4f} ms a round "
        f"({rolled_dev * n_local / round_dev:.3f} of the round's device "
        f"time)")


EAGER_TOKENS = 8  # the fused=False runs serve this many tokens a request
LABELS = {"_dispatch_round": "decode_round", "_admit": "admission"}
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")  # host calls that put work on the card


def deploy(model, params, arch, alloc, batching, *, int8=False,
           n_instances=2, max_len=1024, max_batch=8, **kw):
    """A ``ServingEngine`` on the card with ``n_instances`` weight-shared
    instances (``max_batch`` 8 and ``max_len`` 1024 unless given, block
    size 16), the int8-KV gate set for the deploy only (an instance reads
    it once)."""
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(window=0.2, device="cuda")
    with kv_gate(int8):
        engine.deploy(arch, model, params, alloc, n_instances=n_instances,
                      max_batch=max_batch, max_len=max_len,
                      batching=batching, block_size=16, **kw)
    return engine


@contextlib.contextmanager
def kv_gate(int8: bool):
    """The int8-KV gate set for a deploy or placement only (the frontend
    charges, and an instance pins, the KV dtype it reads then), put back
    after."""
    old = os.environ.pop("REPRO_KV_INT8", None)
    if int8:
        os.environ["REPRO_KV_INT8"] = "1"
    try:
        yield
    finally:
        os.environ.pop("REPRO_KV_INT8", None)
        if old is not None:
            os.environ["REPRO_KV_INT8"] = old


WARM_BUCKETS = (64, 128, 256, 512)  # the buckets of 64-512-token prompts


def warm(engine, arch, prompt, new_tokens: int = 3) -> dict:
    """Before any timed window, two requests of ``new_tokens`` tokens per
    instance and serve bucket (64, 128, 256 and 512 tokens, cut from
    ``prompt`` repeated), all admitted in one pass: each bucket's first
    admission runs eagerly and its second is captured and replayed (the
    dense family), the first round runs eagerly and the second is
    captured.  3 tokens make exactly 2 rounds; a speculating instance
    emits up to k + 1 tokens a round, so it warms with ``3 + 2k`` tokens
    and at least 2 rounds.  Instances that admit at exact length, eager
    (no buckets), take one request each, of the first bucket's length:
    only their rounds are captured.  Returns each instance's graphs,
    (round graph, {bucket: prefill graph}); an engine without them (a
    checkout before them, ``--windows``) gets ``None``s."""
    from repro_torch.launch import serve

    n = len(engine.instances)
    bucketed = all(getattr(i, "bucketed", True)
                   for i in engine.instances.values())
    lens = ([b for b in WARM_BUCKETS for _ in range(2 * n)] if bucketed
            else [WARM_BUCKETS[0]] * n)
    serve.drive(engine, arch, [np.resize(prompt, b) for b in lens],
                new_tokens)
    graphs = {}
    for k, inst in engine.instances.items():
        rg = getattr(inst, "round_graph", None)
        spec = getattr(inst, "speculate", None) is not None
        if rg is not None and (rg.graph is None or rg.captures != 1
                               or (inst.rounds < 2 if spec
                                   else inst.rounds != 2)):
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


def timed_serve(engine, arch, prompts, new_tokens, warm_tokens=3) -> tuple:
    """Warm every instance through its captures, then serve ``prompts``
    with the launch counts and the peak memory set to 0 just before and
    read just after.  Returns (requests, completed, wall s, launch counts,
    telemetry delta per instance, (rounds, prefills) replayed, peak
    bytes allocated and reserved: a graph's memory pool is reserved, and
    a replay allocates nothing)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve

    graphs = warm(engine, arch, prompts[0], warm_tokens)
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
               int8=False, new_tokens=32, max_len=1024, layers=None
               ) -> list:
    """Serve ``prompts`` on two weight-shared instances in ``mode``, each
    through its round graph, captured in a warm-up before the run; the
    launch counts are set to 0 just before the run and read just after
    it.  Checks that every request is served, one host sync per pass, the
    weights stored once, that every round of the run was a replay of the
    graph captured in the warm-up, that the kernels in ``used`` ran and no
    other, each once per layer and prefill (flash, chunked WKV-6, the
    chunked scan) or round (decode, step WKV-6, the step scan), or once
    per ``layers[kernel]`` layers (gemma3's decode kernel: its global
    layers), that each scan dispatcher launched once per layer and pass of
    either shape, and that a ``fused=False`` engine (the host-argmax
    reference, eager) on the same prompts gives the same greedy streams
    over its ``EAGER_TOKENS`` tokens.  Returns the token streams."""
    import gc
    import torch
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.kernels import ssm_scan, wkv6
    from repro_torch.launch import serve

    batching = mode.split()[-1]
    layers = layers or {}
    engine = deploy(model, params, arch, alloc, batching, int8=int8,
                    max_len=max_len)
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
        n_layers = layers.get(k, model.cfg.n_layers)
        if counts[k] != n_layers * per:
            raise AssertionError(
                f"{arch} {mode}: {counts[k]} {k} launches for {prefills} "
                f"prefills and {rounds} rounds of {n_layers} layers")
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
    gc.collect()
    torch.cuda.empty_cache()
    ref = deploy(model, params, arch, alloc, batching, int8=int8,
                 fused=False, max_len=max_len)
    host, done, _ = serve.drive(ref, arch, prompts, EAGER_TOKENS)
    if done != len(prompts) or [r.tokens_out for r in host] != [
            s[:EAGER_TOKENS] for s in streams]:
        raise AssertionError(f"{arch} {mode}: the graph's streams differ "
                             f"from fused=False's")
    log(f"serve {arch} {mode}: the graph-backed rounds' greedy streams equal "
        f"a fused=False engine's (host argmax, eager) over their first "
        f"{EAGER_TOKENS} tokens, {len(prompts)} requests")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
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
        events = raw_events(prof)
        spans = [(a, b) for name, dev, a, b in events
                 if name == "cow_round" and not dev]
        per_pass.append(sum(1 for name, dev, t, _ in events
                            if name in LAUNCH_CALLS and not dev
                            and any(a <= t <= b for a, b in spans)))
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


# --------------------------------------------------------------------------
# 6. qwen2-7b speculative decoding, then sampled rounds (and qwen2-moe's)
# --------------------------------------------------------------------------

SPEC_K = 4          # draft tokens a round
DRAFT_LAYERS = 2    # the drafts: the target's config at n_layers=2
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9, seed=5)
SAMPLED_REQUESTS = 4


def draft_params(params) -> dict:
    """The draft's tree: views of the target's embed, head, ln_f and
    layers 0-1 (no copy)."""
    return {**params, "layers": _tree(params["layers"],
                                      lambda t: t[:DRAFT_LAYERS])}


def agreeing_target(params) -> dict:
    """A target the 2-layer draft agrees with: its layers past the draft's
    add nothing to the residual stream (copies of ``layers/attn/wo`` and
    of the FFN's ``w_down`` — ``layers/mlp/w_down``, or the routed and the
    shared experts' ``w_down`` of ``layers/moe`` — with those layers
    zeroed, about 4.5 GB for qwen2-7b and 7.8 GB for qwen2-moe-a2.7b;
    every other leaf shared), ``benchmarks/decode_throughput.py:73-112``'s
    construction at full width."""
    def zeroed(t):
        t = t.clone()
        t[DRAFT_LAYERS:] = 0
        return t

    layers = params["layers"]
    out = {**layers, "attn": {**layers["attn"],
                              "wo": zeroed(layers["attn"]["wo"])}}
    if "mlp" in layers:
        out["mlp"] = {**layers["mlp"],
                      "w_down": zeroed(layers["mlp"]["w_down"])}
    else:
        moe = layers["moe"]
        out["moe"] = {**moe, "w_down": zeroed(moe["w_down"]),
                      "shared": {**moe["shared"], "w_down":
                                 zeroed(moe["shared"]["w_down"])}}
    return {**params, "layers": out}


def spec_mode(model, params, alloc, prompts, batching, label, kw,
              totals, arch=ARCH) -> tuple[list, dict]:
    """Serve ``prompts`` (32 new tokens each) on two weight-shared
    instances, speculating when ``kw`` holds ``speculate``: every timed
    round and prefill a replay of the warm-up's graphs, one sync a pass,
    exactly 32 tokens a request, and the kernels of the path launched
    once per layer and prefill (flash: the target's and the draft's) or
    per layer and draft step (decode: k + 1 draft steps a round) or, spec
    off, per layer and round.  Returns the streams and the numbers."""
    spec = kw.get("speculate")
    engine = deploy(model, params, arch, alloc, batching, **kw)
    reqs, done, wall, counts, delta, (replayed, pre_replayed), peak = \
        timed_serve(engine, arch, prompts, 32,
                    3 + 2 * SPEC_K if spec else 3)
    what = f"spec {arch} {batching} {label}"
    if done != len(prompts) or not all(
            r.done and len(r.tokens_out) == 32 for r in reqs):
        raise AssertionError(f"{what}: served {done}/{len(prompts)}")
    tele = {c: sum(v[c] for v in delta.values()) for c in
            ("steps", "syncs", "rounds", "prefills", "spec_proposed",
             "spec_accepted")}
    if tele["steps"] != tele["syncs"]:
        raise AssertionError(f"{what}: syncs {tele['syncs']} != passes "
                             f"{tele['steps']}")
    if (replayed, pre_replayed) != (tele["rounds"], tele["prefills"]):
        raise AssertionError(f"{what}: replayed {replayed} of "
                             f"{tele['rounds']} rounds, {pre_replayed} of "
                             f"{tele['prefills']} prefills")
    layers = model.cfg.n_layers
    if spec:
        want = {"flash_attention": (layers + DRAFT_LAYERS) * tele["prefills"],
                "decode_attention": DRAFT_LAYERS * (SPEC_K + 1)
                * tele["rounds"]}
    else:
        want = {"flash_attention": layers * tele["prefills"],
                "decode_attention" if batching == "continuous"
                else "paged_decode_attention": layers * tele["rounds"]}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"{what}: launches {counts}, want {want}")
    for k in totals:
        totals[k] += counts[k]
    n_tok = sum(len(r.tokens_out) for r in reqs)
    decode_tok = n_tok - len(reqs)
    out = dict(tps=n_tok / wall, wall=wall, rounds=tele["rounds"],
               proposed=tele["spec_proposed"],
               accepted=tele["spec_accepted"],
               per_round=decode_tok / max(tele["rounds"], 1))
    acc = out["accepted"] / max(out["proposed"], 1)
    slot_rounds = out["proposed"] // SPEC_K
    log(f"{what}: {done} requests, {n_tok} tokens in {wall:.3f}s = "
        f"{out['tps']:.1f} tokens/s; passes {tele['steps']}, syncs "
        f"{tele['syncs']} (1 per pass); rounds {tele['rounds']} (all "
        f"replayed, 1 capture per instance), prefills {tele['prefills']} "
        f"(all replayed); decode tokens {decode_tok} = "
        f"{out['per_round']:.2f} per round"
        + (f"; draft tokens proposed {out['proposed']}, accepted "
           f"{out['accepted']} (acceptance {acc:.4f}), tokens per verify "
           f"round a slot {1 + out['accepted'] / max(slot_rounds, 1):.3f}"
           if spec else "")
        + f"; launches {counts}; peak device memory allocated {peak[0]}, "
        f"reserved {peak[1]} bytes")
    return [list(r.tokens_out) for r in reqs], out


def _captured(model, params, alloc, prompts, batching, arch=ARCH, **kw):
    """A one-instance engine serving ``prompts`` (32 new tokens each) after
    three passes: admissions and the eager round, the capture, a replay;
    returns the instance (which holds its store and graphs)."""
    engine = deploy(model, params, arch, alloc, batching, n_instances=1,
                    **kw)
    for p in prompts:
        engine.submit(arch, p, max_new_tokens=32)
    (inst,) = engine.instances.values()
    for _ in range(3):
        inst.run_step()
    return inst


def _replay_ms(rg, n: int = 10) -> float:
    """Mean ms of ``n`` back-to-back replays of a round graph, CUDA
    events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rg.replay()
    start.record()
    for _ in range(n):
        rg.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def spec_round_check(model, params, alloc, prompts, batching, spec,
                     dparams, arch=ARCH) -> None:
    """One speculative round replayed from the instance's graph against
    the eager round body over the same state (copies restored between
    them): ``out``, ``n_emit``, slot tokens, positions, key, target pools
    and draft pool bit for bit.  Then the round's time by CUDA events
    over 10 replays against a spec-off instance's round on the same
    prompts, in turns (plain, spec, spec, plain).  Continuous, then on
    the same pools: ``verify_step``'s logits at each of the k + 1 window
    positions against k + 1 sequential ``decode_step`` logits on a copy
    (within ``REF_TOL``: plain f32 verify attention against the decode
    kernel).  Not for a moe config: the verify's B * (k + 1) rows share
    the experts' capacity, where a decode step's B rows never overflow, so
    the two forwards are different functions wherever a pair drops
    (``_reference_moe`` holds the verify forward against the CPU)."""
    import torch
    inst = _captured(model, params, alloc, prompts, batching, arch,
                     speculate=spec, draft_params=dparams)
    rg = inst.round_graph
    if (rg.captures, rg.replays, inst.n_active()) != (1, 2, len(prompts)):
        raise AssertionError(f"spec round check: {rg.captures} captures, "
                             f"{rg.replays} replays, {inst.n_active()} live")
    bufs = {"out": inst._out_dev, "n_emit": inst._n_emit_dev,
            "slot tokens": inst._slot_tok_dev, "key": inst._key_dev,
            **{f"pool {k}": v for k, v in inst.cache.items()},
            **{f"draft {k}": v for k, v in inst.dcache.items()}}
    if batching == "paged":
        bufs["positions"] = inst._pos_dev
    start = {k: v.clone() for k, v in bufs.items()}
    rg.replay()
    replayed = {k: v.clone() for k, v in bufs.items()}
    for k, v in bufs.items():
        v.copy_(start[k])
    inst._round_body()
    torch.cuda.synchronize()
    diff = [k for k, v in bufs.items() if not torch.equal(v, replayed[k])]
    if diff or torch.equal(start["key"], replayed["key"]):
        raise AssertionError(f"spec round check {arch} {batching}: replay "
                             f"!= eager in {diff}")
    n_emit = replayed["n_emit"].tolist()
    log(f"spec round check {arch} {batching}: a draft-{SPEC_K} / verify-1 "
        f"round "
        f"replayed from the graph equals the eager round body bit for bit "
        f"({len(bufs)} buffers: out, n_emit {n_emit}, slot tokens, "
        f"positions, key, target pools, draft pool)")
    # The plain instance stays referenced while its graph replays: the
    # graph reads the instance's buffers, which die with it.
    plain = _captured(model, params, alloc, prompts, batching, arch)
    times = [_replay_ms(g) for g in (plain.round_graph, rg, rg,
                                     plain.round_graph)]
    log(f"spec round time {arch} {batching} ({len(prompts)} live slots, CUDA "
        f"events over 10 replays, plain/spec/spec/plain): "
        f"{', '.join(f'{t:.3f}' for t in times)} ms; spec / plain "
        f"{(times[1] + times[2]) / (times[0] + times[3]):.3f}")
    if batching != "continuous":
        return
    if model.cfg.family == "moe":
        log(f"spec verify check {arch}: not against sequential decode steps "
            f"(a verify window's {len(prompts) * (SPEC_K + 1)} rows share "
            f"the experts' capacity, which a decode step's "
            f"{len(prompts)} rows never fill, so the two differ wherever "
            f"a pair drops); the verify forward is held layer by layer "
            f"against f32 on the CPU in the moe reference")
        return
    window = torch.as_tensor(
        np.random.default_rng(SEED).integers(
            0, model.cfg.vocab_size, (len(prompts), SPEC_K + 1)),
        dtype=torch.int32, device="cuda")
    got, _ = model.verify_step(params, window, {
        k: start[f"pool {k}"].clone() for k in inst.cache})
    seq = {k: start[f"pool {k}"].clone() for k in inst.cache}
    compare = Compare("verify vs sequential decode")
    for j in range(SPEC_K + 1):
        logits, seq = model.decode_step(params, window[:, j], seq)
        compare(f"position {j}", got[:, j], logits.float().cpu())
    log(f"spec verify check {arch}: verify_step's logits (B={len(prompts)}, "
        f"W={SPEC_K + 1}) at every window position within "
        f"{compare.worst:.5f} (limit {REF_TOL}) of {SPEC_K + 1} sequential "
        f"decode_step logits on a copy of the same cache")


def verify_attention_time(batching, cfg) -> float:
    """Device ms of the verify attention of one speculative round at the
    phase's shapes (B=8, W=k+1, ``cfg``'s heads (qwen2-7b: 28 q / 4 kv of
    128), 1024 rows; paged: 64 pages of 16 a sequence, gathered first),
    one call a layer times ``cfg``'s layers, by the profiler's kernel
    records."""
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, w, s, bs = 8, SPEC_K + 1, 1024, 16
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.dh

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q = rand(b, w, h, d)
    lens = torch.tensor([1019, 0, 512, 59, 995, 328, 763, 124],
                        dtype=torch.int32, device="cuda")
    if batching == "continuous":
        kc, vc = rand(b, s, kv, d), rand(b, s, kv, d)
        call = lambda: ops.verify_attention(q, kc, vc, lens)  # noqa: E731
    else:
        n = b * (s // bs) + 1
        kp, vp = rand(n, bs, kv, d), rand(n, bs, kv, d)
        tables = torch.randperm(n - 1, generator=g, device="cuda")[
            :b * (s // bs)].view(b, s // bs).to(torch.int32) + 1
        call = lambda: ops.paged_verify_attention(  # noqa: E731
            q, kp, vp, tables, lens)
    return cfg.n_layers * device_ms([call],
                                    label=f"verify attention ({batching})")


def sampled_check(model, params, arch, prompts, alloc, batching,
                  max_len=1024) -> None:
    """Temperature 0.8, top-k 50, top-p 0.9, seed 5: a graph-backed engine
    and a ``fused=False`` one (the eager reference, replaying the same key
    stream) each warm up the same way, then serve ``prompts`` for
    ``EAGER_TOKENS`` tokens: the streams must be equal bit for bit, the
    graph engine's syncs equal to its passes, every round after the
    warm-up a replay, and every token in the vocab."""
    from repro_torch.launch import serve
    from repro_torch.serving.speculative import SamplingConfig
    sampling = SamplingConfig(**SAMPLING)
    runs = {}
    for fused in (True, False):
        engine = deploy(model, params, arch, alloc, batching, fused=fused,
                        sampling=sampling, max_len=max_len)
        graphs = warm(engine, arch, prompts[0])
        before = {k: dict(v) for k, v in engine.telemetry().items()}
        rounds0 = same_graphs(engine, graphs, arch)[0]
        reqs, done, _ = serve.drive(engine, arch, prompts, EAGER_TOKENS)
        if done != len(prompts) or not all(
                len(r.tokens_out) == EAGER_TOKENS for r in reqs):
            raise AssertionError(f"sampled {arch} {batching}: served {done}")
        tele = {k: {c: v[c] - before[k][c] for c in v}
                for k, v in engine.telemetry().items()}
        if fused:
            rounds = sum(v["rounds"] for v in tele.values())
            replayed = same_graphs(engine, graphs, arch)[0] - rounds0
            if replayed != rounds or any(v["syncs"] != v["steps"]
                                         for v in tele.values()):
                raise AssertionError(f"sampled {arch} {batching}: "
                                     f"{replayed} of {rounds} rounds "
                                     f"replayed, telemetry {tele}")
        runs[fused] = [list(r.tokens_out) for r in reqs]
        del engine
    vocab = model.cfg.vocab_size
    if runs[True] != runs[False] or not all(
            0 <= t < vocab for s in runs[True] for t in s):
        raise AssertionError(f"sampled {arch} {batching}: the graph's "
                             f"streams differ from fused=False's")
    log(f"sampled {arch} {batching} ({SAMPLING}): {len(prompts)} requests x "
        f"{EAGER_TOKENS} tokens through the graphs equal a fused=False "
        f"engine's bit for bit (one key stream), 1 sync per pass, every "
        f"round replayed; first stream {runs[True][0]}")


def spec_phase(model, params, alloc, prompts, spec_off, totals,
               arch=ARCH) -> None:
    """``arch`` (qwen2-7b, or qwen2-moe-a2.7b) speculating with k = 4 on
    two weight-shared instances, continuous then paged, with two drafts of
    2 layers (views of the target's leaves): against a target whose
    layers past the draft's add nothing (``agreeing_target``) and against
    the unmodified target.  Checks and
    logs per mode (``spec_mode``), the agreeing draft's acceptance above
    the disagreeing one's, the round replay against the eager body and
    the verify logits (``spec_round_check``), and logs how many greedy
    streams equal the spec-off ones (``spec_off``: the serve phase's
    streams of the unmodified target), the verify attention's device time
    a round, and a profile window of the agreeing draft's rounds (host
    launch calls a spec round); then the sampled runs
    (``sampled_check``), continuous and paged."""
    import dataclasses
    import gc
    import torch
    from repro_torch.serving.speculative import SpecConfig

    t0 = time.perf_counter()
    dcfg = dataclasses.replace(model.cfg, name=f"{arch}-draft{DRAFT_LAYERS}",
                               n_layers=DRAFT_LAYERS)
    spec = SpecConfig(draft_cfg=dcfg, k=SPEC_K)
    dparams = draft_params(params)
    agree = agreeing_target(params)
    torch.cuda.synchronize()
    log(f"spec: drafts {dcfg.name} ({DRAFT_LAYERS} layers, views of the "
        f"target's leaves), k = {SPEC_K}; the agreeing target copies "
        f"layers/attn/wo and the FFN's w_down with layers "
        f"{DRAFT_LAYERS}-{model.cfg.n_layers - 1} zeroed")
    for batching in ("continuous", "paged"):
        runs = {}
        for label, target, kw in (
                ("spec off (agreeing target)", agree, {}),
                ("agreeing draft", agree,
                 dict(speculate=spec, draft_params=dparams)),
                ("disagreeing draft", params,
                 dict(speculate=spec, draft_params=dparams))):
            runs[label] = spec_mode(model, target, alloc, prompts, batching,
                                    label, kw, totals, arch)
        (off, off_n), (ag, ag_n), (dis, dis_n) = runs.values()
        acc = {k: n["accepted"] / n["proposed"] for k, (_, n) in runs.items()
               if n["proposed"]}
        if not acc["agreeing draft"] > acc["disagreeing draft"]:
            raise AssertionError(f"spec {arch} {batching}: acceptance "
                                 f"{acc}")
        same_ag = sum(a == b for a, b in zip(ag, off))
        same_dis = sum(a == b for a, b in zip(dis, spec_off[batching]))
        log(f"spec {arch} {batching}: acceptance agreeing "
            f"{acc['agreeing draft']:.4f} > disagreeing "
            f"{acc['disagreeing draft']:.4f}; tokens/s spec off "
            f"{off_n['tps']:.1f}, agreeing {ag_n['tps']:.1f}, disagreeing "
            f"{dis_n['tps']:.1f}; greedy streams equal to spec off: "
            f"agreeing {same_ag}/{len(ag)}, disagreeing {same_dis}/"
            f"{len(dis)} (logged, not asserted: a verify GEMM of B*(k+1) "
            f"rows may round otherwise than a decode GEMM of B rows, and "
            f"a near-tie flips, and a moe verify window shares the "
            f"experts' capacity; the exact check is the CPU's, in f32)")
        spec_round_check(model, params, alloc, prompts[:8], batching, spec,
                         dparams, arch)
        log(f"spec {arch} {batching}: verify attention device time per "
            f"spec round {verify_attention_time(batching, model.cfg):.4f} "
            f"ms ({model.cfg.n_layers} layers)")
        profile_window(model, agree, prompts[:8], alloc,
                       f"{arch} spec agreeing", batching, 3 + 2 * SPEC_K,
                       speculate=spec, draft_params=dparams)
        gc.collect()
    del agree, dparams
    gc.collect()
    torch.cuda.empty_cache()
    for batching in ("continuous", "paged"):
        sampled_check(model, params, arch, prompts[:SAMPLED_REQUESTS], alloc,
                      batching)
    log(f"spec {arch}: phase took {time.perf_counter() - t0:.1f}s")


POD_TOKENS = 32   # new tokens a request, as the serve modes
POD_REDUCED = dict(max_batch=4, max_len=128, block_size=16)
POD_SAMPLING = dict(temperature=0.8, top_k=8, seed=7)


def pod_frontend(store=None, devices=None):
    """Four logical nodes on the card (or on ``devices``, one a node), 40
    GiB of admission budget each."""
    from repro_torch.serving import ClusterFrontend
    return ClusterFrontend(n_nodes=4, mem_bytes=40 << 30, window=0.2,
                           model_store=store, devices=devices)


def pod_of(fe):
    """The frontend's one placement, its primary engine and instance."""
    (p,) = fe.placements
    eng = fe.engines[p.node]
    return p, eng, eng.instances[p.inst_id]


def pod_reduced() -> None:
    """The reduced configs as 1-, 2- and 4-member pods on the card: qwen2-7b's
    smoke cut (4 q over 2 kv heads of 16: a 2-member pod splits its heads,
    a 4-member one replicates its pool), bf16 and int8 KV, and a 2-layer
    model of qwen2-7b's heads (7 q over 1 kv of 128, d=896: the kv head
    never divides, and at 4 members each member's q columns end
    mid-head), continuous and paged; gemma3-27b's (dual caches, window 8)
    and mixtral-8x7b's (moe on a rolled cache, window 16) continuous;
    qwen2-moe-a2.7b's continuous and paged; rwkv6-1.6b's (2 heads of 64:
    ``wkv`` split at 2 members, replicated at 4, where each member's
    columns are half a head), hymba-1.5b's (4 q over 2 kv heads of 16:
    K/V and ``ssm`` split at 2, K/V replicated and ``ssm`` split at 4)
    and a hymba cut with 5 q over 1 kv head at d=80 (every pool
    replicated, the ``w_in`` and q columns ending mid-head, as at full
    width), continuous.  bf16 weights with their zero
    norms and biases filled, 6 requests of 5-40 tokens x 8 new tokens on 4
    slots, greedy and sampled (temperature 0.8, top-k 8, seed 7): each
    pod's streams must equal one instance's, every round a replay of the
    one capture."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.resources import Alloc
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.speculative import SamplingConfig

    t0 = time.perf_counter()
    alloc = Alloc(sm=0.25, quota_request=0.5, quota_limit=1.0)
    heads = ModelConfig(name="qwen2-7b-heads", family="dense", n_layers=2,
                        d_model=896, n_heads=7, n_kv_heads=1, head_dim=128,
                        d_ff=1024, vocab_size=1024, qkv_bias=True,
                        mlp="swiglu", rope_theta=1e6)
    hymba_cut = dataclasses.replace(get_config(HYBRID_ARCH, reduced=True),
                                    name="hymba-5q1kv", d_model=80,
                                    n_heads=5, n_kv_heads=1)
    both = ("continuous", "paged")
    cases = [(get_config(ARCH, reduced=True), False, both),
             (heads, False, both), (get_config(ARCH, reduced=True), True, both),
             (get_config(GEMMA_ARCH, reduced=True), False, ("continuous",)),
             (get_config("mixtral-8x7b", reduced=True), False,
              ("continuous",)),
             (get_config(MOE_ARCH, reduced=True), False, both),
             (get_config(RWKV_ARCH, reduced=True), False, ("continuous",)),
             (get_config(HYBRID_ARCH, reduced=True), False, ("continuous",)),
             (hymba_cut, False, ("continuous",))]
    rng = np.random.default_rng(SEED + 14)
    for cfg, int8, batchings in cases:
        model = build_model(cfg)
        p_cpu = _filled(model.init(torch.Generator().manual_seed(SEED)),
                        SEED + 1)
        params = _tree(p_cpu, lambda t: t.cuda())
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                   for n in rng.integers(5, 41, 6)]
        checked = []
        for batching in batchings:
            for sampling in (None, SamplingConfig(**POD_SAMPLING)):
                streams = {}
                for shards in (1, 2, 4):
                    fe = pod_frontend()
                    with kv_gate(int8):
                        fe.place_instance(cfg.name, model, params, alloc,
                                          batching=batching,
                                          sampling=sampling, shards=shards,
                                          **POD_REDUCED)
                    reqs = [fe.submit(cfg.name, q, max_new_tokens=8)
                            for q in prompts]
                    fe.pump(budget_s=120.0)
                    _, _, inst = pod_of(fe)
                    if not all(r.done for r in reqs) or \
                            inst.round_graph.captures != 1 or \
                            inst.kv_int8 != int8:
                        raise AssertionError(
                            f"pod {cfg.name} x{shards} {batching}: served "
                            f"{sum(r.done for r in reqs)}/{len(reqs)}, "
                            f"{inst.round_graph.captures} round captures, "
                            f"int8 {inst.kv_int8}")
                    streams[shards] = [list(r.tokens_out) for r in reqs]
                what = (f"{batching} "
                        f"{'sampled' if sampling else 'greedy'}")
                if not streams[1] == streams[2] == streams[4]:
                    raise AssertionError(
                        f"pod {cfg.name} {'int8 ' if int8 else ''}{what}: "
                        f"streams at 1/2/4 members {streams}")
                checked.append(what)
        log(f"pod reduced {cfg.name} (H={cfg.n_heads} K={cfg.n_kv_heads} "
            f"D={cfg.dh} d={cfg.d_model}, {cfg.family}, window "
            f"{cfg.sliding_window}, {'int8' if int8 else 'bf16'} KV, bf16 "
            f"weights): streams at 1, 2 and 4 members equal in "
            f"{', '.join(checked)}, {len(prompts)} requests x 8 tokens, "
            f"every round of a pod a graph replay")
    log(f"pod reduced phase took {time.perf_counter() - t0:.1f}s")


def round_state(inst) -> dict:
    """Every buffer a fused round reads and writes: the slot tokens, each
    member's pool leaves (one member without a group; paged, its pages)
    and, paged, the page tables, positions and active mask."""
    pools = inst.cache if inst.group is not None else [inst.cache]
    out = {"slot tokens": inst._slot_tok_dev}
    if inst.batching == "paged":
        out["page tables, positions, active"] = inst._state_dev
    for m, pool in enumerate(pools):
        out.update({f"member {m} {k}": v for k, v in pool.items()})
    return out


def pod_round_check(eng, inst, prompts, fn=ARCH) -> tuple[float, str]:
    """One round with 8 live slots replayed from the pod's
    graph against its eager body over the same state (copies restored
    between them), bit for bit; then, from the profiler over one replay,
    the round's device time (its kernels' durations summed), host launch
    calls and device kernels, and the replay's time by CUDA events over
    10 replays.  Returns (device ms, what it logged)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for q in prompts:
        eng.submit(fn, q, max_new_tokens=16)
    for _ in range(2):  # admissions and a replayed round
        inst.run_step()
    rg = inst.round_graph
    if rg.captures != 1 or inst.n_active() != inst.max_batch:
        raise AssertionError(f"pod round check: {inst.n_active()} live "
                             f"slots, {rg.captures} captures")
    start = {k: v.clone() for k, v in round_state(inst).items()}
    rg.replay()
    replayed = {k: v.clone() for k, v in round_state(inst).items()}
    for k, v in round_state(inst).items():
        v.copy_(start[k])
    inst._round_body()
    torch.cuda.synchronize()
    diff = [k for k, v in round_state(inst).items()
            if not torch.equal(v, replayed[k])]
    if diff:
        raise AssertionError(f"pod round check: replay != eager in {diff}")
    for k, v in round_state(inst).items():
        v.copy_(start[k])
    rg.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rg.replay()
        torch.cuda.synchronize()
    events = raw_events(prof)
    calls = sum(name in LAUNCH_CALLS and not dev
                for name, dev, _, _ in events)
    kernels = [(a, b) for _, dev, a, b in events if dev]
    dev_ms = sum(b - a for a, b in kernels) / 1e6
    wall_ms = time_ms([rg.replay], iters=10)
    for k, v in round_state(inst).items():
        v.copy_(start[k])
    eng.pump(budget_s=120.0)  # the 8 requests finish from the restored state
    return dev_ms, (f"replay == eager bit for bit over {len(start)} "
                    f"buffers; a replayed round {dev_ms:.4f} ms device "
                    f"({wall_ms:.4f} ms by CUDA events over 10 replays), "
                    f"{calls} host launch calls and {len(kernels)} device "
                    f"kernels a round")


def pod_logits(inst, prompts, first=None) -> tuple:
    """Exact-length prefill logits of every prompt and, over a fresh pool
    holding ``prompts[:8]`` (up to 8 slots, or paged up to 8 sequences'
    pages through one page table; in the instance's KV dtype), one
    round's logits from
    the tokens ``first``
    (default: the prefills' greedy picks; a pod takes one instance's, so a
    near-tie pick cannot change a round's input), eager, through the
    instance's runner.  Returns (prefill logits, round logits, the
    round's tokens)."""
    import torch
    run, dev, int8 = inst.runner, inst.device, inst.kv_int8
    paged = inst.batching == "paged"
    n = min(8, len(prompts))
    if paged:
        per = inst.max_len // inst.block_size
        pool = run.init_paged_cache(n * per + 1, inst.block_size, dev,
                                    kv_int8=int8)
        tables = (1 + torch.arange(n * per, dtype=torch.int32,
                                   device=dev)).view(n, per)
    else:
        pool = run.init_slot_cache(n, inst.max_len, dev, kv_int8=int8)
    pre = []
    for slot, q in enumerate(prompts):
        tokens = torch.as_tensor(q[None], device=dev)
        logits, entry = run.prefill(inst.params, tokens,
                                    max_len=inst.max_len, kv_int8=int8)
        pre.append(logits[0].float())
        if slot < n and paged:
            run.append_paged(pool, entry, tables[slot].long())
        elif slot < n:
            run.merge_slot(pool, entry, slot)
    if first is None:
        first = torch.stack([torch.argmax(x).to(torch.int32)
                             for x in pre[:n]])
    if paged:
        pos = torch.as_tensor([len(q) for q in prompts[:n]],
                              dtype=torch.int32, device=dev)
        round_logits, _ = run.decode_step_paged(inst.params, first, pool,
                                                tables, pos)
    else:
        round_logits, _ = run.decode_step(inst.params, first, pool)
    return torch.stack(pre), round_logits.float(), first


def pod_phase(model, params, prompts, totals) -> None:
    """qwen2-7b's widths at ``POD_LAYERS`` layers as one instance and as
    2- and 4-member pods, continuous and then paged (see the module
    docstring, phase 7), all on four logical nodes of the card through
    one ``FleetModelStore``."""
    import torch
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import FleetModelStore

    t_phase = time.perf_counter()
    full = model.cfg.n_layers
    model, params = depth_cut(model, params, POD_LAYERS[ARCH])
    log(f"pod {ARCH}: full widths, depth cut to {model.cfg.n_layers} of "
        f"{full} layers (POD_LAYERS), the leading layers' leaves")
    alloc = Alloc(sm=0.25, quota_request=0.5, quota_limit=1.0)
    store = FleetModelStore(host_budget_bytes=40 << 30)
    one = {b: pod_widths(model, params, prompts, totals, alloc, store, b)
           for b in ("continuous", "paged")}
    if torch.cuda.device_count() >= 2:
        pod_spread(model, params, alloc, store, prompts, one["continuous"])
    log(f"pod phase took {time.perf_counter() - t_phase:.1f}s")
    t_phase = time.perf_counter()
    for b in ("continuous", "paged"):
        pod_widths(model, params, prompts, totals,
                   alloc, store, b, int8=True, failure=False)
    log(f"pod int8 {ARCH} phase took {time.perf_counter() - t_phase:.1f}s")


# The pods of earlier slices (qwen2-7b's, bf16 and int8 KV; gemma3-27b's;
# qwen2-moe-a2.7b's; mixtral-8x7b's, whose 32 layers no card holds) serve
# their model's full widths at a quarter of its depth (gemma3-27b: two of
# its local:global groups), so that the whole
# smoke keeps well inside its time limit; every run, request and check of
# theirs is whole.  rwkv6-1.6b's and hymba-1.5b's pods run whole.
POD_LAYERS = {ARCH: 7, GEMMA_ARCH: 12, MOE_ARCH: 6, MIXTRAL_ARCH: 8}


def depth_cut(model, params, layers) -> tuple:
    """``model``'s config at its first ``layers`` layers and ``params``'
    leading ``layers`` slices of every stacked leaf (views, no copy)."""
    import dataclasses
    from repro_torch.models import build_model

    cut = build_model(dataclasses.replace(model.cfg, n_layers=layers))
    return cut, {k: (_tree(v, lambda t: t[:layers]) if k == "layers"
                     else v) for k, v in params.items()}


def staged_store(model, params, fn):
    """A ``FleetModelStore`` with ``params`` staged under ``fn`` in node
    0's host cache, so that a pod's placements upload from the host and
    the caller can free the tree it drew on the card."""
    from repro_torch.serving import FleetModelStore
    from repro_torch.serving.modelstore import stage_params

    staged = stage_params(model, params)
    store = FleetModelStore(host_budget_bytes=staged.nbytes + (1 << 30))
    store.cache(0).put(fn, staged)
    return store


def pod_family(model, store, fn, prompts, totals, batchings, max_len=1024,
               forced=False) -> None:
    """``fn``'s staged weights (``store``) on one instance and as 2- and
    4-member pods in each of ``batchings``, one placement at a time,
    each held against the one instance (``pod_widths``; ``forced``: a
    moe pod's logits with one instance's routing), serving
    ``prompts``."""
    from repro_torch.core.resources import Alloc

    t_phase = time.perf_counter()
    cfg = model.cfg
    log(f"pod {fn}: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads} "
        f"K={cfg.n_kv_heads} D={cfg.dh}, {model.n_params()} params, staged "
        f"{store.staged_nbytes(fn)} bytes on the host, {len(prompts)} "
        f"requests of {min(map(len, prompts))}-{max(map(len, prompts))} "
        f"tokens, max_len {max_len}")
    alloc = Alloc(sm=0.25, quota_request=0.5, quota_limit=1.0)
    for b in batchings:
        pod_widths(model, None, prompts, totals, alloc, store, b, fn=fn,
                   max_len=max_len, failure=False, forced=forced)
    log(f"pod {fn} phase took {time.perf_counter() - t_phase:.1f}s")


def pod_widths(model, params, prompts, totals, alloc, store, batching, *,
               fn=ARCH, int8=False, max_len=1024, failure=True,
               forced=False) -> dict:
    """The request mix on one instance and on 2- and 4-member pods of
    ``model`` in ``batching`` (bf16 or ``int8`` KV), one placement at a
    time, each held against the one instance (phase 7; a moe model's
    routing too, ``pod_routing``, or with ``forced`` ``routing_ties`` and
    the pod's logits taken with one instance's experts, ``routed_as``:
    at full width a mixtral pod's 8 gates move from one instance's by
    more than ``pod_routing``'s fixed margin, and the flips land in
    prompts that could then not be left out of the logits' tolerance;
    qwen2-moe's pods, whose gates equal one instance's bit for bit, keep
    the fixed margin, the stricter rule);
    after the continuous bf16 2-member pod
    (``failure``), a secondary member's failure.  ``params`` may be None
    when ``store`` holds ``fn``'s staged weights.  Returns the one
    instance's readings.  Each kernel of ``pod_kernels`` must launch once
    a layer a member at each prefill or round, and where
    ``POD_MEMBER_BYTES`` holds ``fn`` each member's weight and pool bytes
    must equal JAX's ``per_device_bytes``."""
    import gc
    import torch
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.distributed.sharding import per_member_bytes

    cfg = model.cfg
    per_prefill, per_round = pod_kernels(cfg, batching, int8)
    graphed = model.supports_bucketed_prefill()  # else exact-length, eager
    one = {}
    for shards in (1, 2, 4):
        t0 = time.perf_counter()
        fe = pod_frontend(store)
        with kv_gate(int8):
            fe.place_instance(fn, model, params, alloc, max_batch=8,
                              max_len=max_len, batching=batching,
                              shards=shards)
        p, eng, inst = pod_of(fe)
        event = fe.cold_start_events()[0]
        placed = time.perf_counter() - t0
        label = f"x{shards} {'int8 ' if int8 else ''}{batching}"
        if (inst.group is None) != (shards == 1) or \
                inst.round_graph.always_eager or inst.kv_int8 != int8:
            raise AssertionError(f"pod {fn} {label}: group {inst.group}, "
                                 f"eager {inst.round_graph.always_eager}, "
                                 f"int8 {inst.kv_int8}")
        reqs, done, wall, counts, delta, (replayed, pre_replayed), peak = \
            timed_serve(eng, fn, prompts, POD_TOKENS)
        (tel,) = delta.values()
        prefills, rounds = tel["prefills"], tel["rounds"]
        if done != len(prompts) or not all(
                len(r.tokens_out) == POD_TOKENS for r in reqs):
            raise AssertionError(f"pod {fn} {label}: served {done}")
        if (replayed, pre_replayed) != (rounds,
                                        prefills if graphed else 0):
            raise AssertionError(f"pod {fn} {label}: replayed {replayed}/"
                                 f"{rounds} rounds, {pre_replayed}/"
                                 f"{prefills} prefills")
        want = {k: 0 for k in counts}
        for kernels, n in ((per_prefill, prefills), (per_round, rounds)):
            for k, layers in kernels.items():
                want[k] += shards * layers * n
        if counts != want:
            raise AssertionError(f"pod {fn} {label}: launches {counts}, "
                                 f"expected {want}")
        for k in totals:
            totals[k] += counts[k]
        first = [r.tokens_out[0] for r in reqs]
        streams = [list(r.tokens_out) for r in reqs]
        t_logits = time.perf_counter()
        if forced and shards > 1:  # the pod's own choices on one's experts
            routes, (pre, rnd, fed) = pod_routes(cfg, lambda: routed_as(
                [r for r in one["routes"] for _ in range(shards)],
                lambda: pod_logits(inst, prompts, one["fed"])))
        else:
            routes, (pre, rnd, fed) = pod_routes(
                cfg, lambda: pod_logits(inst, prompts, one.get("fed")))
        t_logits = time.perf_counter() - t_logits
        members = inst.hbm_bytes_by_member()
        weights = (per_member_bytes(inst.group, inst.params)
                   if inst.group is not None
                   else {0: pytree_nbytes(inst.params)})
        kv = {n: members[n] - weights[n] for n in members}
        jax_bytes = POD_MEMBER_BYTES.get(fn, {}).get(shards)
        if jax_bytes and {(weights[n], kv[n]) for n in members} != \
                {jax_bytes}:
            raise AssertionError(f"pod {fn} {label}: (weights, pool) a "
                                 f"member {weights}, {kv}, JAX's "
                                 f"per_device_bytes {jax_bytes}")
        n_tok = len(prompts) * POD_TOKENS
        if shards == 1:
            one = dict(first=first, streams=streams, pre=pre, rnd=rnd,
                       fed=fed, bytes=sum(members.values()),
                       weights=sum(weights.values()), tps=n_tok / wall,
                       routes=routes)
            flips = ""
        else:
            if max(weights.values()) >= one["weights"]:
                raise AssertionError(f"pod {fn} {label}: member weights "
                                     f"{weights} not below one instance's "
                                     f"{one['weights']}")
            if forced:
                routing, exempt = routing_ties(
                    f"pod {fn} {label}", cfg, one["routes"], routes,
                    len(prompts), shards, "the pod's")
                flips = pod_against_one(
                    f"{fn} {label}", one, first, streams, pre, rnd, members,
                    n_tok, exempt=exempt) + routing + (
                    " (logits with one instance's routing)")
            else:
                routing, *flipped = pod_routing(f"{fn} {label}", cfg,
                                                one["routes"], routes,
                                                shards, len(prompts))
                flips = pod_against_one(f"{fn} {label}", one, first,
                                        streams, pre, rnd, members, n_tok,
                                        flipped) + routing
        t_check = time.perf_counter()
        dev_ms, check = pod_round_check(eng, inst, prompts[:8], fn)
        t_check = time.perf_counter() - t_check
        read = sum(weights.values()) + sum(kv.values())
        log(f"pod {fn} {label}: placed on nodes {p.all_nodes()} in "
            f"{placed:.2f}s (store tier {event.tier}, upload call "
            f"{event.upload_s:.2f}s); weights a member {weights}, KV pool a "
            f"member {kv}{' (JAX per_device_bytes)' if jax_bytes else ''}, "
            f"both a member {members} bytes (one instance "
            f"{one['bytes']}, its weights {one['weights']}); "
            f"{done} requests x {POD_TOKENS} tokens in {wall:.3f}s = "
            f"{n_tok / wall:.1f} tokens/s ({n_tok / wall / one['tps']:.3f}"
            f" of one instance's); prefills {prefills}, rounds {rounds}, "
            f"replayed {pre_replayed} and {replayed}; launches {counts}; "
            f"peak allocated {peak[0]} bytes{flips}; round check: {check}; "
            f"a round reads at most the members' weights and pools, {read} "
            f"bytes: {read / PEAK_BYTES * 1e3:.4f} ms at the card's rate "
            f"(the replayed round {dev_ms / (read / PEAK_BYTES * 1e3):.2f}x "
            f"that); {time.perf_counter() - t0:.1f}s in all (the logits "
            f"{t_logits:.1f}s, the round check {t_check:.1f}s)")
        if failure and shards == 2 and batching == "continuous":
            pod_failure(fe, model, params, alloc, prompts[0],
                        one["streams"][0])
        del fe, eng, inst
        gc.collect()
        torch.cuda.empty_cache()
    return one


def pod_kernels(cfg, batching, int8) -> tuple[dict, dict]:
    """The port's kernels a pod launches once a member at each prefill and
    at each round: ({kernel: layers a prefill}, {kernel: layers a
    round}).  rwkv: chunked WKV-6 a prefill, step WKV-6 a round; hybrid:
    windowed flash and the chunked scan a prefill, the step scan a round
    (its rolled decode attention is plain torch); a config rolled on
    every layer (mixtral) flash a prefill and nothing a round; the others
    flash a prefill and the decode kernel of their batching and KV dtype
    a round (a dual-cache config's on its global layers only)."""
    from repro_torch.models import transformer

    n = cfg.n_layers
    if cfg.family == "rwkv":
        return {"wkv6_chunked": n}, {"wkv6_step": n}
    if cfg.family == "hybrid":
        return {"flash_attention": n, "ssm_chunked": n}, {"ssm_step": n}
    if cfg.sliding_window and not cfg.local_global_ratio:
        return {"flash_attention": n}, {}
    decode = {("continuous", False): "decode_attention",
              ("paged", False): "paged_decode_attention",
              ("continuous", True): "decode_attention_quant",
              ("paged", True): "paged_decode_attention_quant"}[
        (batching, int8)]
    return {"flash_attention": n}, {decode: (
        transformer.n_global_layers(cfg) if cfg.local_global_ratio else n)}


def pod_routes(cfg, run) -> tuple:
    """``run()`` with every ``moe.route`` call's (top_e, gates) recorded in
    call order (none for a model without experts): a pod routes each
    layer once a member, in member order.  Returns (the records, what
    ``run`` returned)."""
    from repro_torch.models import moe

    if cfg.family != "moe":
        return [], run()
    calls, route = [], moe.route

    def recorded(router, xt, cfg_, cap):
        r = route(router, xt, cfg_, cap)
        calls.append((r["top_e"].clone(), r["gates"].clone()))
        return r

    moe.route = recorded
    try:
        out = run()
    finally:
        moe.route = route
    return calls, out


def pod_routing(label, cfg, one, pod, shards, n_pre) -> tuple:
    """A moe pod's routing against one instance's over the same ``n_pre``
    prefills and round (``pod_routes``): every member routes each
    token-layer to the same experts, as it must by construction (its
    tokens are the others' bit for bit), and the primary's experts equal
    one instance's wherever one instance's top-k gate margin exceeds
    ``MOE_MARGIN`` (PERF.md section 2; a member's decode kernels split S
    as one device's, ``plan_kv``).  Returns (what to log, the prompts
    whose prefill flipped an expert anywhere, the round's rows that
    did)."""
    import torch

    if not one:
        return "", set(), set()
    n = cfg.n_layers
    if len(one) != (n_pre + 1) * n or len(pod) != shards * len(one):
        raise AssertionError(f"pod {label}: {len(pod)} routings, one "
                             f"instance {len(one)}, {n_pre} prefills")
    k = cfg.top_k
    rows = flips = near = 0
    dev_max = 0.0
    pre, rnd = set(), set()
    for j, (top_e, gates) in enumerate(one):
        mine = [pod[j * shards + m] for m in range(shards)]
        if not all(torch.equal(e, mine[0][0]) for e, _ in mine[1:]):
            raise AssertionError(f"pod {label}: members route call {j} "
                                 f"differently")
        g = gates.sort(-1, descending=True).values
        margin = g[:, k - 1] - g[:, k]
        dev = (mine[0][1] - gates).abs().amax(-1)
        same = (mine[0][0].sort(-1).values == top_e.sort(-1).values).all(-1)
        if not (same | (margin <= MOE_MARGIN)).all():
            bad = ~(same | (margin <= MOE_MARGIN))
            raise AssertionError(
                f"pod {label}: call {j} routes other experts than one "
                f"instance at margins {margin[bad].tolist()}, gate "
                f"deviations {dev[bad].tolist()}")
        dev_max = max(dev_max, float(dev.max()))
        rows += int(same.numel())
        flips += int((~same).sum())
        near += int((margin <= MOE_MARGIN).sum())
        if (~same).any():
            if j // n < n_pre:
                pre.add(j // n)
            else:
                rnd.update(torch.nonzero(~same).flatten().tolist())
    return (f"; routing: every member the same experts, the primary one "
            f"instance's on {rows - flips}/{rows} token-layers ({flips} "
            f"flips, each at a top-{k} margin <= {MOE_MARGIN}; {near} "
            f"token-layers at such a margin; gates within {dev_max:.3g} of "
            f"one instance's); prefills with a flip {sorted(pre)}, round "
            f"rows {sorted(rnd)}", pre, rnd)


def pod_against_one(label, one, first, streams, pre, rnd, members,
                    n_tok, flipped=(set(), set()), exempt=frozenset()
                    ) -> str:
    """A pod's logits, first tokens and member bytes held against the one
    instance's readings ``one`` (``held_against``; a moe pod's prompts and
    round rows that routed a token-layer to other experts at a near-tie,
    ``flipped`` from ``pod_routing``, left out of the logits' tolerance;
    ``exempt`` prompts' first tokens free at a routing tie).  Returns
    what to log."""
    held = held_against(f"pod {label}", one, first, pre, rnd, flipped,
                        "one instance's", exempt)
    if any(b >= one["bytes"] for b in members.values()):
        raise AssertionError(f"pod {label}: member bytes {members} not "
                             f"below one instance's {one['bytes']}")
    same = sum(a == b for s_, o in zip(streams, one["streams"])
               for a, b in zip(s_, o))
    return f"{held}; {same}/{n_tok} stream tokens equal (logged)"


def held_against(label, ref, first, pre, rnd, flipped=(set(), set()),
                 whose="the reference's", exempt=frozenset()) -> str:
    """Prefill logits ``pre``, round logits ``rnd`` and served ``first``
    tokens held against the readings ``ref`` (its ``pre``, ``rnd`` and
    ``first``): the logits within ``REF_TOL`` of ref's (max |diff| / max
    |logit|) on every prompt and round row but those in ``flipped`` (moe
    rows routed to other experts at a near-tie), while at least
    ``MIN_KEPT`` of each stay held; a first token other than ref's only at
    a near-tie of ref's logits (top two within twice the logits'
    deviation, or two bf16 steps of the top logit), on a flipped prompt
    or on an ``exempt`` one (its last row routed other than ref's at a
    near-tie, its logits held with ref's routing), at most ``1 -
    MIN_KEPT`` of the prompts.  Returns what to log."""
    import torch
    keep_pre = [i for i in range(len(pre)) if i not in flipped[0]]
    keep_rnd = [i for i in range(len(rnd)) if i not in flipped[1]]
    if (len(keep_pre) < MIN_KEPT * len(pre)
            or len(keep_rnd) < MIN_KEPT * len(rnd)):
        raise AssertionError(f"{label}: {len(keep_pre)}/{len(pre)} "
                             f"prefills and {len(keep_rnd)}/{len(rnd)} "
                             f"round rows routed as {whose}, fewer "
                             f"than {MIN_KEPT} of each")
    if len(exempt) > (1 - MIN_KEPT) * len(first):
        raise AssertionError(f"{label}: {len(exempt)}/{len(first)} "
                             f"prompts' last rows routed other than "
                             f"{whose} (exempt: {sorted(exempt)}), more "
                             f"than {1 - MIN_KEPT} of them")
    if not (torch.isfinite(pre).all() and torch.isfinite(rnd).all()):
        raise AssertionError(f"{label}: non-finite logits")
    scale = float(ref["rnd"].abs().max())
    rel = float((rnd - ref["rnd"])[keep_rnd].abs().max()) / scale
    pre_rel = float((pre - ref["pre"])[keep_pre].abs().max()) / float(
        ref["pre"].abs().max())
    if rel > REF_TOL or pre_rel > REF_TOL:
        raise AssertionError(f"{label}: logits {pre_rel:.4f} "
                             f"(prefill) {rel:.4f} (round) of "
                             f"{whose}, limit {REF_TOL}")
    # A served first token may differ only at a near-tie of the
    # reference's logits: top two within twice the measured deviation,
    # or within two bf16 steps of the top logit (the logits are bf16
    # products, so closer values tie in bf16).
    top2 = torch.topk(ref["pre"], 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    dev = (pre - ref["pre"]).abs().amax(dim=-1).tolist()
    step = [2.0 ** (math.floor(math.log2(abs(t))) - 7)
            for t in top2[:, 0].tolist()]
    differ = [i for i, (a, b) in enumerate(zip(first, ref["first"]))
              if a != b]
    bad = [i for i in differ if margin[i] > max(2 * dev[i], 2 * step[i])
           and i not in flipped[0] and i not in exempt]
    if bad:
        raise AssertionError(
            f"{label}: first tokens of requests {bad} differ "
            f"from {whose} with top-2 margins "
            f"{[margin[i] for i in bad]} above twice the logits' "
            f"deviation {[dev[i] for i in bad]} and two bf16 steps "
            f"{[2 * step[i] for i in bad]}")
    ties = ", ".join(f"request {i}: margin {margin[i]:.4f}, "
                     f"deviation {dev[i]:.4f}" for i in differ)
    left = (f" over the {len(keep_pre)} prefills and {len(keep_rnd)} "
            f"round rows routed as {whose}" if any(flipped) else "")
    return (f"; first tokens equal {whose} on "
            f"{len(first) - len(differ)}/{len(first)} requests "
            f"({len(differ)} near-ties{': ' + ties if ties else ''}), "
            f"logits within {pre_rel:.5f} (prefills) and {rel:.5f} (a "
            f"round of {len(rnd)} slots) of {whose} (max |diff| / max "
            f"|logit|, limit {REF_TOL}){left}")


def routing_ties(label, cfg, ref, got, n_pre, shards=1,
                 whose="the plain versions'") -> tuple:
    """A run's routing on a reference's experts against the reference's,
    over ``n_pre`` prefills and a round: ``ref`` the reference's records
    (``pod_routes``, one call a layer), ``got`` the run's own (top_e,
    gates) at each call while it took ref's experts (``pod_routes``
    around ``routed_as``; ``shards`` calls a layer, in member order), so
    both are read on one trajectory and their gates differ only by their
    sums' rounding.  Every member routes alike (by construction: its
    tokens are the others' bit for bit); member 0's gates stay within
    ``GATE_TOL`` of ref's, and its own experts equal ref's wherever ref's
    top-k gate margin exceeds ``MOE_MARGIN`` and twice the row's gate
    deviation.  Two runs whose sums round apart (the kernels and the
    plain versions; at full width a pod's column slices and one device's
    products) move mixtral's 8 gates by more than a fixed margin, which
    qwen2-moe's pods, bit-equal to one instance, keep (``pod_routing``).
    Returns (what to log: the flips, all at such near-ties, the largest
    gate deviation, and the prompts whose last row flipped; those
    prompts)."""
    import torch

    n, k = cfg.n_layers, cfg.top_k
    if len(got) != shards * len(ref) or len(ref) != (n_pre + 1) * n:
        raise AssertionError(f"{label}: {len(got)} routings, the "
                             f"reference's {len(ref)}, {n_pre} prefills")
    rows = flips = ties = 0
    dev_max = 0.0
    last, rnd = set(), set()
    for j, (ref_e, ref_g) in enumerate(ref):
        mine = got[j * shards:(j + 1) * shards]
        if not all(torch.equal(e.to(mine[0][0].device), mine[0][0])
                   for e, _ in mine[1:]):
            raise AssertionError(f"{label}: members route call {j} "
                                 f"differently")
        top_e, gates = mine[0]
        g = ref_g.sort(-1, descending=True).values
        margin = g[:, k - 1] - g[:, k]
        dev = (gates.to(ref_g.device) - ref_g).abs().amax(-1)
        dev_max = max(dev_max, float(dev.max()))
        if dev_max > GATE_TOL:
            raise AssertionError(f"{label}: call {j}: {whose} gates "
                                 f"{dev_max} from the reference's, limit "
                                 f"{GATE_TOL}")
        tie = margin <= torch.clamp(2 * dev, min=MOE_MARGIN)
        same = (top_e.to(ref_e.device).sort(-1).values
                == ref_e.sort(-1).values).all(-1)
        if not (same | tie).all():
            bad = ~(same | tie)
            raise AssertionError(f"{label}: call {j}: {whose} own choice "
                                 f"routes other experts than the "
                                 f"reference's at margins "
                                 f"{margin[bad].tolist()}, gate deviations "
                                 f"{dev[bad].tolist()}")
        rows += int(same.numel())
        flips += int((~same).sum())
        ties += int(tie.sum())
        if j // n < n_pre and not bool(same[-1]):
            last.add(j // n)
        elif j // n == n_pre:
            rnd.update(torch.nonzero(~same).flatten().tolist())
    return (f"; {whose} own top-{k} on the reference's experts the same "
            f"on {rows - flips}/{rows} token-layers ({flips} flips, each at "
            f"a top-{k} margin within twice its gate deviation or "
            f"{MOE_MARGIN}; {ties} token-layers at such a margin; gates "
            f"within {dev_max:.4g} of the reference's, limit {GATE_TOL}; "
            f"prompts whose last row flipped {sorted(last)}, round rows "
            f"{sorted(rnd)})", last)


def routed_as(recorded, run):
    """``run()`` with the experts of every ``moe.route`` call replaced by
    ``recorded``'s (``pod_routes``, call for call), each token's weights,
    the ranks, buckets and drops made from its own gates at those experts
    (``moe.pairs``): a run's logits with another's routing, so that a
    near-tie flip between them (``routing_ties``) cannot move a row out
    of the logits' tolerance.  Within ``pod_routes`` the records are the
    run's own choices on those experts."""
    from repro_torch.models import moe

    calls, route = iter(recorded), moe.route

    def forced(router, xt, cfg_, cap):
        r = route(router, xt, cfg_, cap)
        return moe.pairs(r["gates"], next(calls)[0], cfg_, cap)

    moe.route = forced
    try:
        out = run()
    finally:
        moe.route = route
    if next(calls, None) is not None:
        raise AssertionError("routed_as: fewer routing calls than recorded")
    return out


def pod_spread(model, params, alloc, store, prompts, one) -> None:
    """A 2-member pod whose members lie on two cards (nodes on cuda:0 and
    cuda:1 in turn): declared eager at deploy (no graph is captured), it
    serves the request mix; its first tokens are counted against one
    instance's (logged)."""
    import gc
    import torch
    from repro_torch.launch import serve

    fe = pod_frontend(store, [f"cuda:{i % 2}" for i in range(4)])
    fe.place_instance(ARCH, model, params, alloc, max_batch=8, max_len=1024,
                      shards=2)
    p, eng, inst = pod_of(fe)
    if not inst.round_graph.always_eager or inst.group.one_device:
        raise AssertionError(f"pod across cards: devices "
                             f"{inst.group.devices}, eager "
                             f"{inst.round_graph.always_eager}")
    serve.drive(eng, ARCH, prompts[:2], 3)  # the kernel libraries, cuBLAS
    reqs, done, wall = serve.drive(eng, ARCH, prompts, POD_TOKENS)
    first = [r.tokens_out[0] for r in reqs]
    same = sum(a == b for a, b in zip(first, one["first"]))
    if done != len(prompts) or inst.round_graph.captures:
        raise AssertionError(f"pod across cards: served {done}, "
                             f"{inst.round_graph.captures} captures")
    n_tok = len(prompts) * POD_TOKENS
    log(f"pod {ARCH} x2 continuous across 2 cards {inst.group.devices}: "
        f"eager rounds and admissions (declared), {n_tok / wall:.1f} "
        f"tokens/s; first tokens equal one instance's on {same}/"
        f"{len(first)}; weights and KV a member "
        f"{inst.hbm_bytes_by_member()} bytes")
    del fe, eng, inst
    gc.collect()
    torch.cuda.empty_cache()


def pod_failure(fe, model, params, alloc, prompt, reference) -> None:
    """A 2-member pod's secondary member fails mid-request: the pod folds
    (its primary's instance killed, every rectangle released), the
    stranded request parks, and a one-instance replacement serves it the
    one-instance stream from the prompt."""
    p, eng, inst = pod_of(fe)
    stranded = fe.submit(ARCH, prompt, max_new_tokens=POD_TOKENS)
    for _ in range(3):
        inst.run_step()
    emitted = len(stranded.tokens_out)
    if fe.fail_node(p.member_nodes[1]) != 1 or fe.placements or \
            p.inst_id in eng.instances:
        raise AssertionError("pod failure: the pod did not fold")
    fe.place_instance(ARCH, model, params, alloc, max_batch=8, max_len=1024)
    fe.pump(budget_s=120.0)
    if not stranded.done or list(stranded.tokens_out) != reference:
        raise AssertionError(f"pod failure: the stranded request gave "
                             f"{stranded.tokens_out}, one instance "
                             f"{reference}")
    log(f"pod failure: node {p.member_nodes[1]} (a secondary member) "
        f"failed after {emitted} tokens; the pod folded, and the stranded "
        f"request re-ran from its prompt on a one-instance replacement on "
        f"node {fe.placements[0].node} and gave the one-instance stream, "
        f"{POD_TOKENS} tokens")


def profile_window(model, params, prompts, alloc, arch=ARCH,
                   batching="paged", warm_tokens=3, **kw) -> None:
    """Where a serve pass spends its time: device time by kernel (the
    copy kernels, casts included, also summed), the device's busy share of
    the wall time, and the host's launch calls a decode round and an
    admission make (a graph replay is one, an admission's argument copy
    one more), from ``torch.profiler`` over 8 requests x 8 tokens on one
    instance (after a warm-up that captures its round and, dense, its
    prefill buckets; ``kw`` goes to the deploy, as ``speculate``).  Runs on
    an engine without graphs too (``--windows``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch import serve

    engine = deploy(model, params, arch, alloc, batching, n_instances=1,
                    **kw)
    graphs = warm(engine, arch, prompts[0], warm_tokens)
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
    events = raw_events(prof)
    combines = sum(dev and b > a and "combine_kernel" in name
                   for name, dev, a, b in events)
    from repro_torch.kernels import decode_attention as da
    if combines and Path(da.__file__).resolve().is_relative_to(ROOT / "src"):
        raise AssertionError(f"profile {arch}: {combines} combine_kernel "
                             f"launches (one kernel a decode call)")
    calls = [t for name, dev, t, _ in events
             if name in LAUNCH_CALLS and not dev]
    inside = {}
    for label in LABELS.values():
        # The label's host spans (the profiler mirrors it on the device's
        # timeline too, as an annotation kept out of every count here).
        spans = sorted((a, b) for name, dev, a, b in events
                       if name == label and not dev)
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
    log(f"profile {arch}: rounds {rounds} ({n_spans} profiled), replayed "
        f"{replayed[0]}; prefills {prefills}, replayed {replayed[1]}; "
        f"{launch_text}; combine_kernel launches {combines}")
    kernel_profile(events, arch, f"8 requests x 8 tokens, {batching}, 1 "
                   f"instance", wall)


def kernel_profile(events, arch, what, wall) -> None:
    """Logs a profile window's device time by kernel, from its
    ``raw_events``: the device's busy share of the ``wall`` seconds, the
    port's kernels, cuBLAS and the rest, the copy kernels (casts
    included) and the ten longest kernels."""
    # Device-side (kernel) records only: the CPU-side op records carry
    # the same device time again as their children's.
    rows = [(us, n, key) for key, (us, n) in device_totals(
        events, skip=set(LABELS.values())).items()]
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
    log(f"profile {arch}: {what}: "
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
KERNEL_NAMES = TENSOR_CORE_KERNELS + ("wkv6_kernel", "wkv6_chunked_kernel",
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


# Kernels built on warpgroup products (wgmma): their SASS holds HGMMA,
# the other tensor-core kernels' (mma.sync) HMMA.
WGMMA_KERNELS = ("flash_kernel",)
# Kernels that load their tiles by TMA: their SASS holds UTMALDG.
TMA_KERNELS = ("flash_kernel", "decode_bf16_kernel",
               "paged_decode_bf16_kernel", "decode_q8_kernel",
               "paged_decode_q8_kernel")


def tensor_op(name: str) -> str:
    """The SASS tensor-core instruction a kernel must hold."""
    return "HGMMA" if name.split("<")[0] in WGMMA_KERNELS else "HMMA"


def sass_counts(sass: str) -> tuple[dict, dict]:
    """For each kernel (``_short`` names) of a ``cuobjdump -sass``
    listing: how many of its instructions are its ``tensor_op``, and its
    lines."""
    import re
    counts, lines, name = {}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _short(m.group(1))
            counts[name], lines[name] = 0, []
        elif name:
            counts[name] += re.search(rf"\b{tensor_op(name)}\b",
                                      line) is not None
            lines[name].append(line)
    return counts, lines


def tma_loads(lines: dict) -> dict:
    """UTMALDG (TMA tile loads) in the SASS ``lines`` of each kernel of
    ``TMA_KERNELS`` (``sass_counts``' second result)."""
    import re
    return {name: sum(re.search(r"\bUTMALDG\b", line) is not None
                      for line in body)
            for name, body in lines.items()
            if name.split("<")[0] in TMA_KERNELS}


def tensor_core_report(lib) -> None:
    """Tensor-core instructions in the SASS of each kernel, by the
    toolkit's cuobjdump: the tensor-core kernels (``tensor_core_builds``)
    must hold their ``tensor_op`` (HGMMA for flash, HMMA for the rest),
    flash and the four decode kernels TMA loads (UTMALDG), and the step
    kernel passes ``step_kernel_sass``."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        raise AssertionError(f"{tool} not found: the SASS checks cannot "
                             f"run")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, lines = sass_counts(sass)
    log(f"SASS tensor-core instructions per kernel (HGMMA for "
        f"{', '.join(WGMMA_KERNELS)}, HMMA for the rest): {counts}")
    for name in tensor_core_builds():
        if counts.get(name, 0) == 0:
            raise AssertionError(f"{name} has no {tensor_op(name)} "
                                 f"instruction in its SASS")
    tma = tma_loads(lines)
    log(f"SASS TMA loads (UTMALDG) per kernel: {tma}")
    for name in tensor_core_builds():
        if name.split("<")[0] in TMA_KERNELS and tma.get(name, 0) == 0:
            raise AssertionError(f"{name} has no UTMALDG in its SASS")
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


# --------------------------------------------------------------------------
# 8. training: the kernels' autograd Functions, a reference step, qwen2-7b's
#    widths, rwkv6-1.6b and hymba-1.5b, the 100m preset
# --------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 5
TRAIN_HEADROOM = 6e9  # bytes beside the 12-byte-a-param state and logits:
#                       one layer's recompute, the plain backward's
#                       transients, the update's slices (PERF.md §4)
GRAD_TOL = 5e-2       # bf16 gradients on the card vs f32 on the CPU, as
#                       max |diff| / max |reference| a leaf (REF_TOL's)
PRESET_STEPS = 300
TOP_LEAVES = ("['head']", "['ln_f']")  # above every layer
TIME_MIX = "['layers']['tm']"                # rwkv6's time-mix leaves
WITNESS_TOL = 1e-4  # f64 chunked vs f64 loop, max |diff| / max |ref| a leaf
WITNESS_LAYERS = 6  # rwkv6's first layers the f64 witness runs (the f64
#                     loop costs about 1 s a layer; --witness-layers 24
#                     runs the whole model, PERF.md 6)
# rwkv6-1.6b's step-0 gradient norm is not held against the plain path's:
# at its random weights the gradient is ill-conditioned.  At the first
# token (a zero WKV state) a head's output is one scalar r.(u*k) times v,
# and where that scalar is small its group norm (eps 1e-6) sits near its
# singular point; the gradient through those heads compounds over the 24
# layers, and any rounding of the forward moves it: in f64 its norm is
# 6.03e5, through the chunked algorithm in f32 6.0e5 pointing elsewhere,
# through the kernels in bf16 2.6e3 (PERF.md 6).  Held instead
# (``wkv6_witness``): Wkv6ScanFn at the model's own layer inputs, and in
# f64 the chunked algorithm its backward differentiates against the
# loop, every leaf.
NORM_BY_WITNESS = (RWKV_ARCH,)


def _step_grads(model, params, batch, remat=True):
    """(loss, gradients in ``leaves(params)`` order) of the train step's
    loss (``TrainStepConfig``'s aux weight), as ``make_train_step``
    differentiates it, without an update."""
    import torch
    from repro_torch.training import TrainStepConfig, cross_entropy
    from repro_torch.training.tree import leaves, rebuild

    dev = leaves(params)[0].device
    diff = [p.detach().requires_grad_() for p in leaves(params)]
    logits, aux = model.forward(rebuild(params, diff),
                                batch["tokens"].to(dev), remat=remat)
    loss = (cross_entropy(logits, batch["labels"].to(dev))
            + TrainStepConfig().aux_weight * aux)
    del logits
    return loss.detach(), torch.autograd.grad(loss, diff)


class _WindowProbe:
    """Within the block, every causal flash call of more rows than
    ``window`` with that window has its rows past the window held
    against the plain version with and without it (``window_gaps``):
    its last row must differ from the windowless version by more than
    any of those rows differs from the windowed one."""

    def __init__(self, window: int):
        self.window, self.calls = window, []

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.saved = ops, ops.flash_attention

        def probed(q, k, v, *, causal=True, window=None, **kw):
            out = self.saved(q, k, v, causal=causal, window=window, **kw)
            if causal and window == self.window and q.shape[1] > window \
                    and not kw.get("q_offset"):
                (win, free), _ = window_gaps(q, k, v, window, out)
                if not float(free[-1]) > float(win.max()):
                    raise AssertionError(
                        f"window: flash call {len(self.calls)}: its last "
                        f"row within {float(free[-1])} of the windowless "
                        f"plain version, rows past the window within "
                        f"{float(win.max())} of the windowed one")
                self.calls.append((q.shape[1], float(win.max()),
                                   float(free[0]), float(free[-1])))
            return out

        ops.flash_attention = probed
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.saved

    def report(self, n_calls: int) -> str:
        """What to log; fails unless ``n_calls`` calls were probed."""
        if len(self.calls) != n_calls:
            raise AssertionError(f"window: {len(self.calls)} flash calls "
                                 f"past the window, expected {n_calls}")
        sq = {c[0] for c in self.calls}
        first = [c[2] for c in self.calls]
        last = [c[3] for c in self.calls]
        return (f"in each of the {n_calls} flash calls of the prefills "
                f"({sorted(sq)} rows), rows {self.window}-{max(sq) - 1} "
                f"within {max(c[1] for c in self.calls):.3g} of the "
                f"windowed plain version, while the windowless one differs "
                f"by {min(first):.3g}-{max(first):.3g} at row "
                f"{self.window} (1 key left out) and {min(last):.3g}-"
                f"{max(last):.3g} at row {max(sq) - 1} "
                f"({max(sq) - self.window} keys; max |diff| a row)")


class _PlainOps:
    """Within the block, the models' three training kernels run their
    plain versions on the card, differentiated by autograd directly: the
    scans' chunked algorithms, as their Functions' backward runs them
    there (``wkv6_backward_plain``, ``ssm_backward_plain``), or WKV-6's
    loop where ``loop`` is set."""

    def __init__(self, loop: bool = False):
        self.loop = loop

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ops, ssm_scan, wkv6
        self.ops, self.saved = ops, {n: getattr(ops, n) for n in (
            "flash_attention", "wkv6_scan", "ssm_scan")}
        ops.flash_attention = fa.flash_attention_plain
        ops.wkv6_scan = (wkv6.wkv6_scan_plain if self.loop
                         else wkv6.wkv6_backward_plain)
        ops.ssm_scan = lambda *a, state_out=None: ssm_scan.ssm_backward_plain(
            *a)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)


class _F64:
    """Within the block ``Tensor.float()`` gives f64, so the models and the
    plain versions, which compute in f32 by casting with it, compute in
    f64 on f64 weights: the witness of a gradient that f32 rounding
    moves."""

    def __enter__(self):
        import torch
        self.saved = torch.Tensor.float
        torch.Tensor.float = lambda t: t.double()
        return self

    def __exit__(self, *exc):
        import torch
        torch.Tensor.float = self.saved


def _grad_gap(grads, ref, names) -> dict:
    """How far ``grads`` lies from ``ref`` (same leaves, ``names`` their
    paths): the two norms and their relative gap, ||g - ref|| / ||ref||
    over all leaves, the worst leaf's max |diff| / max |ref|, and the
    same whole-slice gap for the first and the last layer's time-mix
    leaves."""
    def sq(xs):
        return float(sum(x.double().square().sum() for x in xs))

    diff = [g.double() - r.double() for g, r in zip(grads, ref)]
    norm, ref_norm = math.sqrt(sq(grads)), math.sqrt(sq(ref))
    out = dict(norm=norm, ref_norm=ref_norm,
               norm_rel=abs(norm - ref_norm) / ref_norm,
               total_rel=math.sqrt(sq(diff)) / ref_norm,
               worst_leaf=max((d.abs().max() / r.double().abs().max().clamp(
                   min=1e-30)).item() for d, r in zip(diff, ref)))
    tm = [i for i, n in enumerate(names) if n.startswith(TIME_MIX)]
    for key, layer in (("first_tm", 0), ("last_tm", -1)):
        if tm:
            num = sq([diff[i][layer] for i in tm])
            out[key] = math.sqrt(num / max(sq([ref[i][layer] for i in tm]),
                                           1e-300))
    return out


def _gap_text(g: dict) -> str:
    return (f"grad_norm {g['norm']:.5f} vs {g['ref_norm']:.5f} (rel "
            f"{g['norm_rel']:.3e}); ||diff|| / ||ref|| {g['total_rel']:.3e}; "
            f"worst leaf {g['worst_leaf']:.3e}; first / last layer's "
            f"time-mix {g.get('first_tm', 0):.3e} / {g.get('last_tm', 0):.3e}")


def wkv6_witness(model, params, batch, dev, layers) -> None:
    """rwkv6-1.6b at full width, step 0, two holds through the WKV-6
    backward:

    * ``Wkv6ScanFn`` (the kernel forward, the chunked algorithm's
      backward) at the inputs the model gives its first and last layers'
      scans on ``batch`` (its own decays): input gradients against
      autograd of the loop within ``TOL``, for a random output gradient;
    * the model cut to its first ``layers`` layers (the same weights), in
      f64 (``_F64``) through the plain versions: the chunked algorithm
      at ``grad_chunk(S)``, what the Function's backward differentiates
      on the card, against the loop, every leaf within ``WITNESS_TOL``.

    Logged, not held: how far the f32 chunked path's and the bf16
    kernels' gradients lie from the f64 loop's."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import ops, wkv6
    from repro_torch.kernels.grad import grad_chunk
    from repro_torch.models import build_model
    from repro_torch.training.tree import leaves, paths, rebuild

    captured, scan = [], ops.wkv6_scan
    ops.wkv6_scan = lambda *a: captured.append(a) or scan(*a)
    try:
        with torch.no_grad():
            model.forward(params, batch["tokens"].to(dev))
    finally:
        ops.wkv6_scan = scan
    rng = np.random.default_rng(SEED + 30)
    for label, x in (("first", captured[0]), ("last", captured[-1])):
        outs = [torch.from_numpy(rng.standard_normal(t.shape).astype(
            np.float32)).to(dev).to(t.dtype) for t in (x[0], x[5])]
        xs_k = [t.detach().clone().requires_grad_() for t in x]
        torch.autograd.backward(ops.wkv6_scan(*xs_k), outs)
        xs_p = [t.detach().clone().requires_grad_() for t in x]
        torch.autograd.backward(wkv6.wkv6_scan_plain(*xs_p), outs)
        errs = [((a.grad.float() - b.grad.float()).abs().max()
                 / b.grad.float().abs().max().clamp(min=1e-30)).item()
                for a, b in zip(xs_k, xs_p)]
        w = x[3].float()
        if not all(e <= TOL for e in errs):
            raise AssertionError(f"wkv6 grad at rwkv6's {label} layer: "
                                 f"input gradient rel errs {errs}")
        log(f"train-kernel wkv6 at rwkv6-1.6b's {label} layer's inputs "
            f"(B={x[0].shape[0]} S={x[0].shape[1]}, decays w in "
            f"[{w.min().item():.4f}, {w.max().item():.4f}]): Wkv6ScanFn's "
            f"input grads (r k v w u state) within "
            f"{[round(e, 6) for e in errs]} of the loop's autograd (limit "
            f"{TOL})")
    del captured
    depth, seq = model.cfg.n_layers, batch["tokens"].shape[1]
    if layers < depth:
        model = build_model(dataclasses.replace(model.cfg, n_layers=layers))
        params = {**params, "layers": _tree(params["layers"],
                                            lambda t: t[:layers])}
    names = [n for n, _ in paths(params)]

    def grads(p, loop=False):
        with _PlainOps(loop=loop):
            return _step_grads(model, p, batch)[1]

    t0 = time.perf_counter()
    p64 = rebuild(params, [t.double() for t in leaves(params)])
    with _F64():
        ref = grads(p64, loop=True)
        t_loop = time.perf_counter() - t0
        f64 = _grad_gap(grads(p64), ref, names)
    del p64
    f32 = _grad_gap(grads(rebuild(params, [t.float() for t in leaves(
        params)])), ref, names)
    bf16 = _grad_gap(_step_grads(model, params, batch)[1], ref, names)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train {RWKV_ARCH} witness, {layers} of "
        f"{depth} layers, f64 weights: the chunked "
        f"algorithm at grad_chunk({seq}) = {grad_chunk(seq)} vs the "
        f"loop: {_gap_text(f64)} (worst leaf's limit {WITNESS_TOL}); the "
        f"f64 loop took {t_loop:.1f}s")
    log(f"train {RWKV_ARCH} witness (not held): f32 weights through the "
        f"chunked algorithm vs the f64 loop: {_gap_text(f32)}")
    log(f"train {RWKV_ARCH} witness (not held): bf16 through the kernels "
        f"vs the f64 loop: {_gap_text(bf16)}")
    if not f64["worst_leaf"] <= WITNESS_TOL:
        raise AssertionError(f"train {RWKV_ARCH} witness: f64 chunked vs "
                             f"loop {f64}")


def _fb_times(fn, inputs, grad_out, iters=10) -> tuple[float, float]:
    """(forward ms, backward ms) of ``fn`` under autograd, CUDA events."""
    import torch
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    fwd = time_ms([lambda: fn(*xs)], iters)
    outs = iter([fn(*xs) for _ in range(iters + 1)])  # time_ms: 1 warm-up

    def back():
        o = next(outs)
        o = o if isinstance(o, tuple) else (o,)
        torch.autograd.grad(o, xs, grad_out[:len(o)])
    return fwd, time_ms([back], iters)


def function_grads(dev) -> None:
    """Each autograd Function at the trained shapes: its input gradients on
    the card against autograd of the plain version there (flash's equal by
    construction, its backward recomputing that version, so flash's
    kernel forward is held against the plain one too; flash causal at
    qwen2-7b's 4 x 512 rows, windowed at hymba's 4 x 640 with window 1024
    and at 33, not causal at seamless's encoder, 4 x 1024 frames; WKV-6
    at rwkv6-1.6b's 4 x 512 tokens, from S = 16 and at S = 1; the scan at
    hymba's 4 x 640 rows, N = 16), and the forward kernel's, the plain
    backward's and (flash) SDPA's forward + backward times beside the
    bound for forward + backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssm_scan, wkv6

    rng = np.random.default_rng(SEED + 29)
    b = TRAIN_B

    def rand(*shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) * scale).to(torch.bfloat16)

    def grads(fn, inputs, outs_like):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        out = fn(*xs)
        out = out if isinstance(out, tuple) else (out,)
        torch.autograd.backward(out, outs_like[:len(out)])
        return [x.grad for x in xs]

    def rel(name, got, want):
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"{name}: non-finite gradient {i}")
            e = ((g.float() - w.float()).abs().max()
                 / w.float().abs().max().clamp(min=1e-30)).item()
            if not e <= TOL:
                raise AssertionError(f"{name}: input {i} gradient rel err "
                                     f"{e} > {TOL}")
            worst = max(worst, e)
        return worst

    flash_cases = [("causal, qwen2-7b", 512, 512, 28, 4, 128, True, None),
                   ("window 1024, hymba", 640, 640, 25, 5, 64, True, 1024),
                   ("window 33, hymba heads", 640, 640, 25, 5, 64, True, 33),
                   ("not causal, seamless encoder", 1024, 1024, 16, 16, 64,
                    False, None)]
    for label, sq, sk, h, kv, d, causal, window in flash_cases:
        q, k, v = rand(b, sq, h, d), rand(b, sk, kv, d), rand(b, sk, kv, d)
        do = [rand(b, sq, h, d)]
        kw = dict(causal=causal, window=window)
        before = fa.flash_attention.launches
        got = grads(lambda *x: ops.flash_attention(*x, **kw), (q, k, v), do)
        if fa.flash_attention.launches != before + 1:
            raise AssertionError(f"flash grad {label}: the kernel did not "
                                 f"run the forward")
        err = rel(f"flash grad {label}", got, grads(
            lambda *x: fa.flash_attention_plain(*x, **kw), (q, k, v), do))
        with torch.no_grad():  # the gradients agree by construction
            fwd_err = (ops.flash_attention(q, k, v, **kw).float()
                       - fa.flash_attention_plain(q, k, v, **kw).float()
                       ).abs().max().item()
        if not fwd_err <= TOL:
            raise AssertionError(f"flash forward {label}: max abs err "
                                 f"{fwd_err} > {TOL}")
        pairs = causal_pairs(sq, window) if causal else sq * sk
        nbytes = 2 * (4 * q.numel() + 4 * k.numel())
        bnd, by = bound(3.5 * 4 * b * h * d * pairs, nbytes)
        fwd, bwd = _fb_times(lambda *x: ops.flash_attention(*x, **kw),
                             (q, k, v), do)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_in = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
        dot = do[0].transpose(1, 2).contiguous()
        mask = None
        if window is not None and window < sq:
            i = torch.arange(sq, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                  - window)

        def sdpa():
            o = F.scaled_dot_product_attention(
                *sdpa_in, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
            torch.autograd.grad(o, sdpa_in, dot)
        log(f"train-kernel flash {label} (B={b} Sq={sq} Sk={sk} {h} q / "
            f"{kv} kv of {d}): kernel forward within {fwd_err:.5f} (max abs) "
            f"of the plain version; input grads within {err:.5f} of the "
            f"plain version's autograd (its own recompute, so equal by "
            f"construction); kernel forward {fwd:.5f} ms, plain "
            f"backward {bwd:.5f} ms, SDPA forward + backward "
            f"{time_ms([sdpa], 10):.5f} ms, bound (forward + backward) "
            f"{bnd:.5f} ms ({by})")
    h, d = 32, 64
    for s in (TRAIN_S, 16, 1):
        x = [rand(b, s, h, d), rand(b, s, h, d), rand(b, s, h, d),
             (-torch.exp(rand(b, s, h, d, scale=0.3).float()) - 0.01).to(
                 torch.bfloat16), rand(h, d), rand(b, h, d, d).float()]
        outs = [rand(b, s, h, d), rand(b, h, d, d).float()]
        err = rel(f"wkv6 grad S={s}", grads(ops.wkv6_scan, x, outs),
                  grads(wkv6.wkv6_scan_plain, x, outs))
        seq = b * s * h * d
        bnd, by = bound(3 * 5 * seq * d, 2 * 10 * seq + 3 * 4 * b * h * d * d)
        fwd, bwd = _fb_times(ops.wkv6_scan, x, outs)
        log(f"train-kernel wkv6 S={s} (B={b} H={h} D={d}): input grads "
            f"within {err:.5f} of the plain loop's autograd; kernel forward "
            f"{fwd:.5f} ms, plain backward {bwd:.5f} ms, bound (forward + "
            f"backward) {bnd:.5f} ms ({by})")
    h, n, s = 25, 16, 640
    x = list(ssm_inputs(rng, dev, b, s, h, 0.0))
    outs = [rand(b, s, h, d), rand(b, h, d, n).float()]
    err = rel("ssm grad", grads(ops.ssm_scan, x, outs),
              grads(ssm_scan.ssm_scan_plain, x, outs))
    flops, io = ssm_cost(b, s, h)
    bnd, by = bound(3 * flops, 2 * io + 2 * b * s * h * d)
    fwd, bwd = _fb_times(ops.ssm_scan, x, outs)
    log(f"train-kernel ssm S={s} N={n} (B={b} H={h} D={d}): input grads "
        f"within {err:.5f} of the plain loop's autograd; kernel forward "
        f"{fwd:.5f} ms, plain backward {bwd:.5f} ms, bound (forward + "
        f"backward) {bnd:.5f} ms ({by})")


def train_reference(dev) -> None:
    """A 2-layer model with qwen2-7b's heads (28 q / 4 kv of 128, qkv
    bias; cut: d 3584 -> 1024, d_ff 18944 -> 2048, V 152064 -> 1024),
    zero leaves filled: its step-0 loss and every leaf's gradient on the
    card (bf16, through the kernels' Functions) against the same weights
    in f32 on the CPU (the plain versions), 2 x 256 tokens of the
    training stream."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.training.data import make_batch
    from repro_torch.training.tree import paths

    cfg = ModelConfig(name="qwen2-7b-heads-train", family="dense",
                      n_layers=2, d_model=1024, n_heads=28, n_kv_heads=4,
                      head_dim=128, d_ff=2048, vocab_size=1024,
                      qkv_bias=True, mlp="swiglu", rope_theta=1e6)
    model = build_model(cfg)
    p_cpu = _filled(model.init(torch.Generator().manual_seed(SEED)),
                    SEED + 2)
    batch = make_batch(cfg.vocab_size, 2, 256, 0, seed=SEED)
    loss, grads = _step_grads(model, _tree(p_cpu, lambda t: t.to(dev)),
                              batch)
    ref_loss, ref = _step_grads(model, _tree(p_cpu, lambda t: t.float()),
                                batch, remat=False)
    lrel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    worst, names = 0.0, [path for path, _ in paths(p_cpu)]
    for name, g, r in zip(names, grads, ref):
        g = g.float().cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"train reference {name}: non-finite")
        e = ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
        worst = max(worst, e)
        if e > GRAD_TOL:
            raise AssertionError(f"train reference {name}: gradient rel "
                                 f"err {e} > {GRAD_TOL}")
    if not lrel <= TOL:
        raise AssertionError(f"train reference: loss {loss.item()} vs "
                             f"{ref_loss.item()}")
    log(f"train reference: 2-layer d=1024 28 q / 4 kv of 128 model, step-0 "
        f"loss {loss.item():.5f} on the card vs {ref_loss.item():.5f} in f32 "
        f"on the CPU (rel {lrel:.5f}, limit {TOL}); {len(names)} leaves' "
        f"gradients within {worst:.5f} (max |diff| / max |ref|, limit "
        f"{GRAD_TOL})")


def step_split(prof) -> str:
    """A profiled train step's device time: the port's forward kernels
    (forward and remat recompute), the Functions' plain backward
    (``plain_backward`` ranges), the update (``AdamW.update``), cuBLAS
    matmuls outside both, and the rest.  A kernel belongs to a range when
    it starts inside the range's span on the device's timeline (the
    profiler mirrors each host range there as an annotation).  Reads the
    profiler's raw device records: building its event tree for a step of
    a few hundred thousand ops takes longer than the step."""
    labels = {"plain_backward": "plain backward",
              "AdamW.update": "optimizer"}
    events = [(name, a, b - a)
              for name, _, a, b in raw_events(prof, host=False)]
    spans = {label: sorted((t, t + d) for name, t, d in events
                           if name == label) for label in labels}
    kernels = [x for x in events if x[0] not in labels]
    if not kernels or not all(spans.values()):
        return "not measured (no device time or no device-side ranges)"

    def label_of(t):
        for label, sp in spans.items():
            i = bisect.bisect_right(sp, (t, math.inf)) - 1
            if i >= 0 and t < sp[i][1]:
                return labels[label]
        return None

    gemm = ("nvjet", "gemm", "cutlass", "xmma")
    parts = dict.fromkeys(("forward kernels", "plain backward", "optimizer",
                           "matmuls outside them", "the rest"), 0.0)
    for name, t, d in kernels:
        part = label_of(t) or (
            "forward kernels" if _port_name(name) else
            "matmuls outside them" if any(g in name for g in gemm)
            else "the rest")
        parts[part] += d / 1e3
    total = sum(parts.values())
    return f"device {total / 1e3:.2f} ms: " + ", ".join(
        f"{k} {v / 1e3:.2f} ms ({v / total:.3f})" for k, v in parts.items())


def train_layers(model) -> tuple[int, str]:
    """The most layers of ``model``'s widths whose training state fits the
    card: params, bf16 gradients and f32 moments (12 bytes a param), the
    f32 logits and their gradient path (four B x S x V f32 tensors) and
    ``TRAIN_HEADROOM``, within 0.9 of the card's memory."""
    import dataclasses
    import torch
    from repro_torch.models import build_model

    cfg = model.cfg

    def n(layers):
        return build_model(dataclasses.replace(cfg, n_layers=layers)) \
            .n_params()
    per_layer, base = n(2) - n(1), 2 * n(1) - n(2)
    logits = 4 * TRAIN_B * TRAIN_S * cfg.padded_vocab * 4
    total = torch.cuda.get_device_properties(0).total_memory
    fit = int((0.9 * total - logits - TRAIN_HEADROOM - 12 * base)
              // (12 * per_layer))
    layers = max(1, min(cfg.n_layers, fit))
    need = 12 * (base + layers * per_layer) + logits + TRAIN_HEADROOM
    return layers, (f"{per_layer} params a layer, {base} outside them; "
                    f"{layers} layers: 12 x {base + layers * per_layer} + "
                    f"{logits} (logits) + {TRAIN_HEADROOM:.0f} = {need} "
                    f"bytes of {total}")


def train_arch(arch, want, dev, witness_layers=WITNESS_LAYERS) -> None:
    """``arch`` at full width (depth cut to fit, for qwen2-7b), random bf16
    weights from the seed: the step-0 loss and ``grad_norm`` through the
    kernels against the plain path on the card, then ``TRAIN_STEPS``
    steps of B x S tokens of the training stream with remat and bf16
    gradients, the launch counts of the steps (each of ``want`` must
    run), steps/s, tokens/s, peak memory and a profiled step's split."""
    import dataclasses
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import AdamW, TrainStepConfig, make_train_step
    from repro_torch.training.data import batch_iterator
    from repro_torch.training.tree import paths

    t_arch = time.perf_counter()
    model = build_model(get_config(arch))
    cut = ""
    if arch == ARCH:
        layers, reckoning = train_layers(model)
        model = build_model(dataclasses.replace(model.cfg, n_layers=layers))
        cut = (f", depth cut {get_config(arch).n_layers} -> {layers} "
               f"({reckoning})")
    cfg = model.cfg
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    batches = batch_iterator(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=SEED)
    first = next(batches)

    def loss_norms(plain):
        """(loss, the gradient's norm, the head's and ln_f's norms)."""
        if plain:
            with _PlainOps():
                loss, grads = _step_grads(model, params, first)
        else:
            loss, grads = _step_grads(model, params, first)
        norms = dict(zip((n for n, _ in paths(params)),
                         (g.float().norm() for g in grads)))
        return (loss.item(),
                torch.sqrt(sum(n * n for n in norms.values())).item(),
                [norms[k].item() for k in TOP_LEAVES])

    t0 = time.perf_counter()
    (loss_k, norm_k, top_k), (loss_p, norm_p, top_p) = (loss_norms(False),
                                                        loss_norms(True))
    if arch in NORM_BY_WITNESS:
        wkv6_witness(model, params, first, dev, witness_layers)
    t_check = time.perf_counter() - t0
    lrel = abs(loss_k - loss_p) / abs(loss_p)
    nrel = abs(norm_k - norm_p) / norm_p
    trel = max(abs(a - b) / b for a, b in zip(top_k, top_p))
    held = arch not in NORM_BY_WITNESS
    if not (lrel <= TOL and trel <= TOL and math.isfinite(norm_k)
            and (nrel <= TOL or not held)):
        raise AssertionError(f"train {arch}: step 0 through the kernels "
                             f"(loss {loss_k}, grad_norm {norm_k}, head and "
                             f"ln_f {top_k}) vs the plain path ({loss_p}, "
                             f"{norm_p}, {top_p})")
    opt = AdamW(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    step = make_train_step(model, opt, TrainStepConfig(remat=True,
                                                       grad_compress=True))
    state = opt.init(params)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times, batch = [], [], first
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        batch = next(batches)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in want if not launches[k]]
    if missing or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {arch}: losses {losses}, launches "
                             f"{launches}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
    split = step_split(prof)
    t_prof = time.perf_counter() - t0
    steady = float(np.mean(times[1:]))
    log(f"train {arch}: full width ({cfg.n_layers}L d={cfg.d_model} "
        f"V={cfg.vocab_size}{cut}), {model.n_params()} params; step 0 "
        f"through the kernels loss {loss_k:.5f} grad_norm {norm_k:.5f} vs "
        f"the plain path {loss_p:.5f} {norm_p:.5f} (rel {lrel:.5f} / "
        f"{nrel:.5f}{'' if held else ', logged, held by the witness'}; "
        f"the head's and "
        f"ln_f's gradient norms within {trel:.5f}; limit {TOL})")
    log(f"train {arch}: {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} tokens "
        f"(remat, bf16 gradients): losses {[round(x, 5) for x in losses]}; "
        f"step seconds {[round(t, 4) for t in times]}; steady "
        f"{1 / steady:.3f} steps/s = {TRAIN_B * TRAIN_S / steady:.1f} "
        f"tokens/s; max_memory_allocated {peak} bytes; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    log(f"train {arch}: a profiled step: {split}")
    del params, state, metrics, prof
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train {arch} took {time.perf_counter() - t_arch:.1f}s (the "
        f"step-0 checks {t_check:.1f}s, the profiled step {t_prof:.1f}s)")


def train_preset() -> None:
    """``launch.train --preset 100m --steps 300`` on the card: the loss's
    mean over the last 5 steps must fall below 0.8 of the first 5's, as
    ``tests/test_training.py:36-45`` holds the reference's."""
    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    result = launch_train.main(["--preset", "100m", "--steps",
                                str(PRESET_STEPS)])
    first = float(np.mean(result.losses[:5]))
    last = float(np.mean(result.losses[-5:]))
    if not last < 0.8 * first:
        raise AssertionError(f"train preset 100m: loss {first} -> {last}")
    log(f"train preset 100m: {PRESET_STEPS} steps, mean loss of the first "
        f"5 {first:.4f}, of the last 5 {last:.4f} ({last / first:.3f}, "
        f"limit 0.8); {result.steps / result.wall_time:.2f} steps/s; took "
        f"{time.perf_counter() - t0:.1f}s")


def training_phase(witness_layers: int = WITNESS_LAYERS) -> None:
    import torch
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    function_grads(dev)
    log(f"train-kernel checks took {time.perf_counter() - t0:.1f}s")
    train_reference(dev)
    for arch, want in ((ARCH, ("flash_attention",)),
                       (RWKV_ARCH, ("wkv6_chunked",)),
                       (HYBRID_ARCH, ("flash_attention", "ssm_chunked"))):
        train_arch(arch, want, dev, witness_layers)
    train_preset()
    log(f"training phase took {time.perf_counter() - t0:.1f}s")


# --------------------------------------------------------------------------
# 9. the analysis layer: the dry run on the meta device; the examples
# --------------------------------------------------------------------------

DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun"
DRYRUN_CELLS = 280  # 10 configs x (4 training layouts + 3 cases x 8 layouts)


class DryRun:
    """``python -m repro_torch.launch.dryrun --all`` in a process of its
    own with no card visible (it traces on the meta device), its lines
    to ``DRYRUN_OUT``.  It runs beside the card's phases only to keep the
    smoke inside its time limit; a thread notes when it exits, so the
    log says which timed phases shared the host with it."""

    def __init__(self, src: Path):
        DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES="")
        with open(DRYRUN_OUT / "stdout.txt", "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                 "--out", str(DRYRUN_OUT)], env=env, stdout=out,
                stderr=subprocess.STDOUT, cwd=str(ROOT))
        self.started = time.perf_counter()
        self.ended: float | None = None
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()

    def _wait(self) -> None:
        self.proc.wait()
        self.ended = time.perf_counter()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.waiter.join()


def byte_reckonings() -> dict:
    """{what: (the dry run's reckoning on the meta device through the
    port's own pod code, the byte constant this script serves by)}: a
    member's weight and pool bytes at the smoke's serve shape (8 slots x
    1024 rows; gemma3's 2048) and its pods' depth (``POD_LAYERS``, where
    the pods are cut), and the configs' params and slot-pool bytes (the
    JAX package's counts)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model

    slots = 8

    def member(arch, n=1, max_len=1024, int8=False, layers=None):
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        return dryrun.serve_member_bytes(cfg, n, slots, max_len, int8)

    def dense(arch, max_len=1024, int8=False):
        """``dense_kv_bytes``: the pool's leaves and one scalar ``pos``
        (a slot pool holds one ``pos`` a slot)."""
        return member(arch, 1, max_len, int8)[1] - 4 * slots + 4

    checks = {}
    for arch, by_n in POD_MEMBER_BYTES.items():
        for n, want in by_n.items():
            checks[f"{arch} member of {n}"] = (
                member(arch, n, layers=POD_LAYERS.get(arch)), want)
    checks[f"{ARCH} dense_kv_bytes(8, 1024)"] = (
        (dense(ARCH), dense(ARCH, int8=True)),
        (BF16_DENSE_BYTES, INT8_DENSE_BYTES))
    sc = build_model(get_config(STARCODER_ARCH))
    checks[STARCODER_ARCH] = (
        (sc.n_params(), dense(STARCODER_ARCH),
         dense(STARCODER_ARCH, int8=True), sc.kv_block_bytes(16, False),
         sc.kv_block_bytes(16, True)), STARCODER_SIZES)
    checks[GEMMA_ARCH] = (
        (build_model(get_config(GEMMA_ARCH)).n_params(),
         dense(GEMMA_ARCH, GEMMA_MAX_LEN)), GEMMA_SIZES)
    checks[MOE_ARCH] = (
        (build_model(get_config(MOE_ARCH)).n_params(), member(MOE_ARCH)[0],
         dense(MOE_ARCH)), MOE_SIZES)
    return checks


def analysis_phase(dry: DryRun, t_serve: float) -> None:
    """The dry run's byte reckonings (``byte_reckonings``) held equal to
    the byte constants this script serves by; no kernel launches on
    meta.  Then the whole dry run's result, from its own process: every
    cell ``ok`` or ``skipped``, and its fit table, and when it exited
    against ``t_serve``, the serve phase's start."""
    import torch
    from repro_torch import kernels

    t0 = time.perf_counter()
    before = kernels.counter_values()
    checks = byte_reckonings()
    bad = {k: v for k, v in checks.items() if tuple(v[0]) != tuple(v[1])}
    if bad:
        raise AssertionError(f"analysis: reckoned bytes differ from the "
                             f"smoke's constants: {bad}")
    if kernels.counter_values() != before:
        raise AssertionError("analysis: a meta trace launched a kernel")
    log(f"analysis: {len(checks)} reckonings of member weight and pool "
        f"bytes on the meta device equal the smoke's constants: "
        + "; ".join(f"{k} {tuple(v[0])}" for k, v in checks.items()))
    t_wait = time.perf_counter()
    dry.waiter.join(timeout=600)
    waited = time.perf_counter() - t_wait
    rc = dry.proc.returncode
    text = (DRYRUN_OUT / "stdout.txt").read_text()
    cells = [json.loads(x) for x in
             (DRYRUN_OUT / "dryrun.jsonl").read_text().splitlines()]
    status = collections.Counter(c["status"] for c in cells)
    if rc != 0 or len(cells) != DRYRUN_CELLS or set(status) - {
            "ok", "skipped"}:
        raise AssertionError(f"analysis: dry run exit {rc}, "
                             f"{len(cells)} cells, {dict(status)}:\n"
                             f"{text[-4000:]}")
    summary = next(x for x in text.splitlines()
                   if x.startswith("[dryrun]"))
    lead = t_serve - dry.ended
    log(f"analysis: dry run --all under torch {torch.__version__}: "
        f"{dict(status)} of {len(cells)} cells; {summary} (waited "
        f"{waited:.1f}s for it here); it exited "
        f"{dry.ended - dry.started:.1f}s after it started, "
        + (f"{lead:.1f}s before the serve phase began" if lead >= 0 else
           f"{-lead:.1f}s into the serve phase, whose first windows "
           f"shared the host with it"))
    for line in text.split("[fit]", 1)[1].splitlines():
        if line.strip():
            log(f"fit: {line}")
    log(f"analysis phase took {time.perf_counter() - t0:.2f}s (predicted "
        f"3-6 s before its first run, PERF.md Findings)")


def load_example(name: str):
    """``examples/<name>.py`` as a module of its own."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase() -> None:
    """The port's examples on the card, in this process, each with its
    own asserts: torch_quickstart, torch_multi_tenant_isolation (the
    victim's rate while the aggressor runs, isolated at least 0.9 of
    time-shared) and
    torch_train_lm at ``--preset 100m --steps 40`` (the loss falls across
    the restart); their launches counted from 0, and flash, decode and
    the WKV-6 step kernel must each have run.  Then the two examples
    whose tiny models have head dim 8 must be refused before any weight
    is drawn (no device memory allocated), with no CPU fallback."""
    import torch
    from repro_torch import kernels

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    times = {}
    t = time.perf_counter()
    out = load_example("torch_quickstart").main([])
    times["quickstart"] = time.perf_counter() - t
    log(f"examples: torch_quickstart served {out['done']} of "
        f"{len(out['reqs'])} requests on the card; first completion "
        f"{out['reqs'][0].tokens_out}")
    t = time.perf_counter()
    runs = load_example("torch_multi_tenant_isolation").main([])
    times["isolation"] = time.perf_counter() - t
    shared = {}
    for k in ("contended", "isolated"):
        rec = runs[k]["engine"].recorders
        end = max(rec["aggressor"].completion_times)
        shared[k] = sum(t <= end for t in rec["victim"].completion_times)
    log("examples: torch_multi_tenant_isolation victim req/s "
        + ", ".join(f"{k} {v['rate']:.1f}" for k, v in runs.items())
        + f" (isolated / time-shared "
        f"{runs['isolated']['rate'] / runs['contended']['rate']:.3f}, "
        f"limit 0.9; read over the victim's completions while the "
        f"aggressor ran: {shared})")
    t = time.perf_counter()
    losses = load_example("torch_train_lm").main(
        ["--preset", "100m", "--steps", "40"])
    times["train_lm"] = time.perf_counter() - t
    log(f"examples: torch_train_lm 100m, 40 steps across a restart: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    counts = kernels.launch_counts()
    missing = [k for k in ("flash_attention", "decode_attention",
                           "wkv6_step") if not counts[k]]
    if missing:
        raise AssertionError(f"examples: no launches of {missing}: "
                             f"{counts}")
    log(f"examples: launches {({k: v for k, v in counts.items() if v})}")
    for name in ("torch_serve_cluster", "torch_autoscale_live"):
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated()
        try:
            load_example(name).main([])
        except SystemExit as e:
            if e.code != 2:
                raise
        else:
            raise AssertionError(f"examples: {name} ran on the card")
        if torch.cuda.memory_allocated() != mem:
            raise AssertionError(f"examples: {name} drew weights before "
                                 f"its refusal")
        log(f"examples: {name} refused on the card before drawing any "
            f"weight (its tiny models' head dim 8)")
    log(f"examples phase took {time.perf_counter() - t0:.1f}s ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in times.items())
        + "; predicted 22-43 s before its first run, PERF.md Findings)")


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
    ap.add_argument("--witness-layers", type=int, default=WITNESS_LAYERS,
                    help="rwkv6's layers the training phase's f64 witness "
                         "runs (24: all of them)")
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
    load_rates()
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
    tensor_core_report(lib)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    results = kernel_phase(rng)
    log(f"kernel phase took {time.perf_counter() - t0:.1f}s")
    # The dry run traces on the meta device in a process of its own, on a
    # host core, while the card runs the phases below (for the time limit).
    dry = DryRun(src)
    try:
        t0 = time.perf_counter()
        reference_phase(rng)
        log(f"reference phase took {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        reduced_serve()
        reduced_context_serve()
        log(f"reduced serve took {time.perf_counter() - t0:.1f}s")
        pod_reduced()
        t_serve = time.perf_counter()
        launches = serve_phase(rng)
        training_phase(args.witness_layers)
        analysis_phase(dry, t_serve)
    finally:
        dry.stop()
    examples_phase()
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
