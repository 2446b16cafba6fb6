"""mixtral-8x7b at all 32 layers (93.4 GB of bf16 weights, more than a
card holds) served as one 2-member pod over two cards, through the port's
entry points: ``stage_drawn``, ``FleetModelStore``,
``ClusterFrontend(devices=[...]).place_instance(shards=2)``, ``submit``
and ``pump``.  In order:

1. The weights, drawn from seed 0 on ``cuda:0`` a piece at a time into
   one pinned host buffer (``serving.modelstore.stage_drawn``): never
   whole on a card.  The host's MemAvailable is checked first against
   the pinned block the buffer takes (the pinned allocator rounds it up
   to a power of two: 128 GiB for 93.4 GB) and 16 GiB beside it; the
   seconds and the process's peak resident bytes are logged.
2. Refusal: on nodes of a card's 80 GB the frontend refuses the function
   at ``shards=1``, and at ``shards=2`` too, since it charges every
   member the whole weights, as JAX's frontend does (frontend.py:299-307
   of the JAX package; ROADMAP.md, Queue 3).  The pod is then placed at
   ``shards=2`` on nodes whose admission budget is that charge.
3. Bytes: each member's weight and pool bytes, which must equal the dry
   run's fit row (``launch.dryrun.fit_table``: 62.81 GB a member), and
   each member card's ``torch.cuda.max_memory_allocated`` over the
   placement, the serving and the checks, which must stay below 80 GB.
4. Serve 8 requests of 64-512 prompt tokens x 32 new ones, rounds and
   admissions eager (declared: a CUDA graph holds one card's work):
   tokens/s, the upload call's seconds, the cold start's time to first
   token, and an eager round's ms beside the bytes it reads.
5. The pod's kernels held against the plain versions on the same cards
   (``chip_smoke._PlainOps``): prefill logits of the 8 prompts and one
   round's over their pool, the plain versions taking the kernels'
   experts (``chip_smoke.routed_as``), within ``chip_smoke.REF_TOL``;
   served first tokens other only at a near-tie; the plain versions' own
   choice on the kernels' experts theirs but at near-ties, and their
   gates within ``chip_smoke.GATE_TOL`` (``chip_smoke.routing_ties``).
6. The 8-layer cut (``chip_smoke.POD_LAYERS``, its own draw from seed 0)
   as a 2-member pod on one card (graphs) and on two cards (eager): the
   served first tokens, prefill logits and round logits bit for bit.

Usage (a machine with two cards or more; with fewer it exits non-zero):
  PYTHONPATH=src python3 scripts/mixtral_pod_cards.py
"""

from __future__ import annotations

import dataclasses
import gc
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

ARCH = smoke.MIXTRAL_ARCH
CARD_BYTES = 80 * 10**9      # a card's memory, as the dry run's fit table
REQUESTS, NEW_TOKENS = 8, 32
POD = dict(max_batch=8, max_len=1024)
DEVICES = ["cuda:0", "cuda:1"]


def log(msg: str) -> None:
    print(f"[mixtral_pod_cards] {msg}", flush=True)


def sync() -> None:
    for d in DEVICES:
        torch.cuda.synchronize(d)


def n_leaves(tree) -> int:
    return (sum(map(n_leaves, tree.values())) if isinstance(tree, dict)
            else 1)


def stage(model, what: str):
    """``model``'s weights drawn from seed 0 on the first card into the
    pinned host buffer, after checking the host has room for them."""
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.launch import dryrun
    from repro_torch.serving.modelstore import stage_drawn

    meta = dryrun.meta_params(model)
    need = pytree_nbytes(meta)
    # The buffer pads each leaf to 512 bytes, and the pinned host
    # allocator rounds a block up to a power of two.
    pinned = 1 << (need + 512 * n_leaves(meta) - 1).bit_length()
    avail = smoke.host_mem_available()
    if avail < pinned + (16 << 30):
        raise AssertionError(f"{what}: the host has {avail} bytes "
                             f"available, the staging buffer of {need} "
                             f"bytes takes a pinned block of {pinned} "
                             f"and 16 GiB beside it")
    torch.cuda.reset_peak_memory_stats(DEVICES[0])
    t0 = time.perf_counter()
    staged = stage_drawn(model, smoke.SEED, device=DEVICES[0])
    secs = time.perf_counter() - t0
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if staged.buffer.numel() > pinned:
        raise AssertionError(f"{what}: a buffer of {staged.buffer.numel()} "
                             f"bytes, reckoned at most {pinned}")
    log(f"{what}: {model.n_params()} params, {staged.nbytes} bytes drawn "
        f"from seed {smoke.SEED} on {DEVICES[0]} a piece at a time into "
        f"one pinned host buffer ({staged.buffer.numel()} bytes, a pinned "
        f"block of {pinned}) in {secs:.1f}s; the host had {avail} bytes "
        f"available (the block and 16 GiB needed), the "
        f"process's peak resident {peak} bytes; {DEVICES[0]} peak "
        f"allocated while drawing {torch.cuda.max_memory_allocated(0)} "
        f"bytes")
    return staged


def store_of(staged):
    from repro_torch.serving import FleetModelStore
    store = FleetModelStore(host_budget_bytes=staged.nbytes + (1 << 30))
    store.cache(0).put(ARCH, staged)
    return store


def frontend(store, devices, mem_bytes):
    from repro_torch.serving import ClusterFrontend
    return ClusterFrontend(n_nodes=len(devices), mem_bytes=mem_bytes,
                           window=0.2, model_store=store, devices=devices)


def alloc():
    from repro_torch.core.resources import Alloc
    return Alloc(sm=0.5, quota_request=0.5, quota_limit=1.0)


def refusal(model, store) -> int:
    """The frontend's refusals on 80 GB nodes at 1 and 2 members, and the
    charge a member it asked a node to admit.  Returns that charge."""
    fe = frontend(store, DEVICES, CARD_BYTES)
    seen, admits = {}, fe.admits

    def spy(node, fn, mm):
        seen.setdefault(shards, []).append(mm)
        return admits(node, fn, mm)

    fe.admits = spy
    for shards in (1, 2):
        if fe.place_instance(ARCH, model, None, alloc(), shards=shards,
                             **POD) is not None:
            raise AssertionError(f"refusal: placed at shards={shards} on "
                                 f"{CARD_BYTES}-byte nodes")
    charge = {n: max(mm.footprint(1, sharing=True) for mm in mms)
              for n, mms in seen.items()}
    log(f"refusal: on nodes of {CARD_BYTES} bytes the frontend refuses "
        f"{ARCH} at shards=1 (charge {charge[1]} bytes) and at shards=2 "
        f"(charge {charge[2]} bytes a member: the whole "
        f"{store.staged_nbytes(ARCH)} bytes of weights, as JAX's frontend "
        f"charges a member, plus the framework and half the pool)")
    return charge[2]


def serve_prompts(vocab: int) -> list:
    rng = np.random.default_rng(smoke.SEED)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in rng.integers(64, 513, REQUESTS)]


def full_pod(model, store, budget) -> None:
    """Steps 3-5 on all 32 layers."""
    from repro_torch.core.model_sharing import pytree_nbytes
    from repro_torch.distributed.sharding import per_member_bytes
    from repro_torch.launch import dryrun

    cfg = model.cfg
    for d in DEVICES:
        torch.cuda.reset_peak_memory_stats(d)
    fe = frontend(store, DEVICES, budget)
    t0 = time.perf_counter()
    if fe.place_instance(ARCH, model, None, alloc(), shards=2,
                         **POD) is None:
        raise AssertionError(f"placement: refused on {budget}-byte nodes")
    placed = time.perf_counter() - t0
    p, eng, inst = smoke.pod_of(fe)
    (event,) = fe.cold_start_events()
    if not inst.round_graph.always_eager or inst.group.one_device:
        raise AssertionError(f"placement: devices {inst.group.devices}, "
                             f"eager {inst.round_graph.always_eager}")
    log(f"placed {ARCH} ({cfg.n_layers}L) at shards=2 on nodes "
        f"{p.all_nodes()} = {[str(d) for d in inst.group.devices]} in "
        f"{placed:.1f}s (store tier {event.tier}, upload call "
        f"{event.upload_s:.1f}s, {event.mode}); the frontend charges "
        f"{fe.mem_used(p.node)} bytes on the primary's node")

    prompts = serve_prompts(cfg.vocab_size)
    warm = [fe.submit(ARCH, q[:64], max_new_tokens=3) for q in prompts[:2]]
    fe.pump(budget_s=600.0)
    if not all(r.done for r in warm):
        raise AssertionError("warm-up: not served")
    tel0 = dict(eng.telemetry()[p.inst_id])
    t0 = time.perf_counter()
    reqs = [fe.submit(ARCH, q, max_new_tokens=NEW_TOKENS) for q in prompts]
    fe.pump(budget_s=900.0)
    sync()
    wall = time.perf_counter() - t0
    tel = {k: v - tel0[k] for k, v in eng.telemetry()[p.inst_id].items()}
    if not all(r.done and len(r.tokens_out) == NEW_TOKENS for r in reqs) \
            or inst.round_graph.captures or inst.prefill_graphs is not None \
            and inst.prefill_graphs.captures:
        raise AssertionError(f"serve: {sum(r.done for r in reqs)}/"
                             f"{len(reqs)} served, round captures "
                             f"{inst.round_graph.captures}")
    # The pool is made at the first admission.
    weights = per_member_bytes(inst.group, inst.params)
    pool = per_member_bytes(inst.group, inst.cache)
    fit = dryrun.serve_member_bytes(cfg, 2)  # the fit table's row
    if {(weights[n], pool[n]) for n in weights} != {fit}:
        raise AssertionError(f"bytes: weights {weights}, pool {pool} a "
                             f"member, the dry run's fit row {fit}")
    log(f"bytes: weights a member {weights}, pool a member {pool}: the "
        f"dry run's fit row {fit} = {sum(fit) / 1e9:.2f} GB a member")
    n_tok = REQUESTS * NEW_TOKENS
    first = [r.tokens_out[0] for r in reqs]
    (event,) = fe.cold_start_events()  # its first token resolved now
    log(f"serve {ARCH} x2 across {DEVICES}: {REQUESTS} requests of "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} prompt tokens "
        f"x {NEW_TOKENS} new in {wall:.3f}s = {n_tok / wall:.2f} tokens/s; "
        f"prefills {tel['prefills']}, rounds {tel['rounds']}, eager "
        f"(declared, no graph captured); cold start: upload call "
        f"{event.upload_s:.1f}s, time to first token {event.ttft_s:.1f}s")

    # An eager round with every slot live, timed on both cards.
    for q in prompts:
        eng.submit(ARCH, q[:64], max_new_tokens=16)
    inst.run_step()  # the admissions and a round
    if inst.n_active() != inst.max_batch:
        raise AssertionError(f"round: {inst.n_active()} live slots")
    sync()
    t0 = time.perf_counter()
    for _ in range(5):
        inst.run_step()
    sync()
    round_ms = (time.perf_counter() - t0) / 5 * 1e3
    eng.pump(budget_s=300.0)
    embed = pytree_nbytes(inst.params[0]["embed"])
    read = {n: weights[n] - embed + pool[n] for n in weights}
    per_card = max(read.values()) / smoke.PEAK_BYTES * 1e3
    log(f"round {ARCH} x2 across two cards, eager, 8 live slots: "
        f"{round_ms:.2f} ms a round by wall clock over 5 rounds (a host "
        f"sync each); a member reads at most {max(read.values())} bytes "
        f"(its weights but the embedding, and its pool): {per_card:.2f} ms "
        f"at one card's {smoke.PEAK_BYTES / 1e12} TB/s, the two cards in "
        f"parallel ({round_ms / per_card:.2f}x that)")

    routes, (pre, rnd, ker_first) = smoke.pod_routes(
        cfg, lambda: smoke.pod_logits(inst, prompts))
    with smoke._PlainOps():
        own, (ref_pre, ref_rnd, _) = smoke.pod_routes(
            cfg, lambda: smoke.routed_as(routes, lambda: smoke.pod_logits(
                inst, prompts, ker_first)))
    sync()
    routing, _ = smoke.routing_ties(f"{ARCH} x2 plain", cfg, routes[::2],
                                    own, len(prompts), shards=2)
    ref = dict(pre=ref_pre, rnd=ref_rnd, first=ref_pre.argmax(-1).tolist())
    held = smoke.held_against(f"{ARCH} x2 plain", ref, first, pre, rnd,
                              whose="the plain versions' (routed as the "
                              "kernels')")
    log(f"hold {ARCH} x2 across two cards, the kernels against the plain "
        f"versions on the same cards and weights{held}{routing}")
    peaks = {d: torch.cuda.max_memory_allocated(d) for d in DEVICES}
    if max(peaks.values()) >= CARD_BYTES:
        raise AssertionError(f"peak memory {peaks}")
    log(f"peak allocated a member card over the placement, the serving and "
        f"the checks: {peaks} bytes (the dry run's fit row "
        f"{sum(fit)} = {sum(fit) / 1e9:.2f} GB a member; peak / fit row "
        f"{[round(v / sum(fit), 4) for v in peaks.values()]}; a card "
        f"{CARD_BYTES})")
    del fe, eng, inst
    gc.collect()
    for d in DEVICES:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()


def cut_readings(cut, store, devices, prompts) -> dict:
    """The cut as a 2-member pod on ``devices`` (a member's each): its
    served first tokens, and its prefill and round logits
    (``pod_logits``)."""
    fe = frontend(store, devices, 40 << 30)
    if fe.place_instance(ARCH, cut, None, alloc(), shards=2,
                         **POD) is None:
        raise AssertionError(f"cut on {devices}: refused")
    p, eng, inst = smoke.pod_of(fe)
    reqs = [fe.submit(ARCH, q, max_new_tokens=4) for q in prompts]
    fe.pump(budget_s=600.0)
    if not all(r.done for r in reqs):
        raise AssertionError(f"cut on {devices}: not served")
    pre, rnd, _ = smoke.pod_logits(inst, prompts)
    sync()
    out = dict(first=[r.tokens_out[0] for r in reqs], pre=pre.cpu(),
               rnd=rnd.cpu(), eager=inst.round_graph.always_eager,
               devices=[str(d) for d in inst.group.devices])
    del fe, eng, inst
    gc.collect()
    return out


def build_cut():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    return build_model(dataclasses.replace(
        get_config(ARCH), n_layers=smoke.POD_LAYERS[ARCH]))


def cut_pods() -> None:
    """Step 6: the 8-layer cut, one card against two, bit for bit."""
    t0 = time.perf_counter()
    cut = build_cut()
    staged = stage(cut, f"cut {cut.cfg.n_layers}L")
    store = store_of(staged)
    prompts = serve_prompts(cut.cfg.vocab_size)
    one = cut_readings(cut, store, DEVICES[:1] * 2, prompts)
    two = cut_readings(cut, store, DEVICES, prompts)
    same = {"first tokens": one["first"] == two["first"],
            "prefill logits": torch.equal(one["pre"], two["pre"]),
            "round logits": torch.equal(one["rnd"], two["rnd"])}
    if one["eager"] or not two["eager"] or not all(same.values()):
        raise AssertionError(
            f"cut: one card {one['devices']} (eager {one['eager']}) "
            f"against two {two['devices']} (eager {two['eager']}): "
            f"{same}; logits differ by "
            f"{float((one['pre'] - two['pre']).abs().max())} (prefills), "
            f"{float((one['rnd'] - two['rnd']).abs().max())} (round)")
    log(f"cut {cut.cfg.n_layers}L x2: the pod on one card "
        f"{one['devices']} (graphs) and on two {two['devices']} (eager) "
        f"give the same bits: {same}, {len(prompts)} prompts; "
        f"{time.perf_counter() - t0:.1f}s")


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[mixtral_pod_cards] FAIL: a 2-member pod over two cards "
              f"needs two cards, this machine has {n}", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    smoke.load_rates()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} cards; the pod runs on {DEVICES}")
    t_all = time.perf_counter()
    for d in DEVICES:  # each card's allocator, before its peak is reset
        torch.zeros(1, device=d)
    log(f"kernels built: {build.build()}")
    model = build_model(get_config(ARCH))
    staged = stage(model, f"{ARCH} {model.cfg.n_layers}L")
    store = store_of(staged)
    budget = refusal(model, store)
    full_pod(model, store, budget)
    del store, staged
    gc.collect()
    cut_pods()
    log(f"done in {time.perf_counter() - t_all:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
