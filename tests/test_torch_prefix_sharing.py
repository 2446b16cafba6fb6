"""Prefix sharing with copy-on-write in the port's engine, against the JAX
engine (mirrors ``test_prefix_sharing.py``): the same shared-prefix
arrivals give the same greedy streams shared and unshared, paged and
static, in both packages, with the same sharing hits and COW copies; a
shared block is charged once; retiring sharers mid-flight leaks nothing;
``Model.copy_block`` is JAX's bit for bit; and a property over random
shared-prefix mixes holds the streams and the write contract.

Both packages run f32 params of the tiny config on the CPU (bf16 or int8
KV pools; the port's admissions run their graphs' body eagerly here).
Tolerance: identical tokens and counts; ``copy_block`` pools bit for bit.
The families are dense, MoE (4 experts, top-2) and int8-KV dense, as
``test_prefix_sharing.py`` runs them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import tiny_config
from repro.core.resources import Alloc as JaxAlloc
from repro.models import build_model as jax_build
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import _ROW

torch.set_num_threads(2)

FULL = dict(sm=1.0, quota_request=0.9, quota_limit=0.9)
MOE_KW = dict(family="moe", n_experts=4, top_k=2)


def _pair(name, seed=0, **over):
    """JAX and port models of the tiny config under ``name`` (one name per
    int8 variant, so no JAX trace made under the other gate is reused),
    f32 params bridged."""
    jcfg = tiny_config(name=name, **over)
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(seed)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


@pytest.fixture(scope="module")
def models():
    return _pair("tiny-share")


def _shared_arrivals(n=4, prefix_len=12, suffix_len=4, seed=0, vocab=64,
                     max_new=(2, 6, 4, 5), rng=None):
    """``n`` prompts of one shared prefix and a unique suffix each, with
    staggered budgets (releases while shared), as the JAX test draws
    them."""
    rng = np.random.default_rng(seed) if rng is None else rng
    prefix = rng.integers(0, vocab, prefix_len, dtype=np.int32)
    return [(np.concatenate(
        [prefix, rng.integers(0, vocab, suffix_len, dtype=np.int32)]),
        max_new[i % len(max_new)]) for i in range(n)]


def _deploy(eng, model, params, batching, alloc, *, max_batch=2,
            max_len=32, block_size=8, **kw):
    eng.deploy("f", model, params, alloc, max_batch=max_batch,
               max_len=max_len, batching=batching, block_size=block_size,
               **kw)
    return eng


def _serve(eng, arrivals):
    reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    assert eng.pump(budget_s=120.0) == len(reqs)
    assert all(r.done for r in reqs)
    return [r.tokens_out for r in reqs], next(iter(eng.instances.values()))


def _port(tm, tp, batching, arrivals, **kw):
    return _serve(_deploy(ServingEngine(window=0.1, device="cpu"), tm, tp,
                          batching, Alloc(**FULL), **kw), arrivals)


def _jax(jm, jp, batching, arrivals, **kw):
    return _serve(_deploy(JaxEngine(window=0.1), jm, jp, batching,
                          JaxAlloc(**FULL), **kw), arrivals)


# -- streams and counts against the JAX engine -------------------------------


@pytest.mark.parametrize("family", ["dense", "moe", "kv-int8"])
def test_shared_tokens_bit_identical_across_planes(family, monkeypatch,
                                                   repro_rng):
    """Shared paged == unshared paged == static in the port == the JAX
    engine's shared paged streams, with JAX's sharing hits, COW count and
    block high watermark, and a smaller peak than unshared."""
    int8 = family == "kv-int8"
    monkeypatch.setenv("REPRO_KV_INT8", "1" if int8 else "0")
    jm, jp, tm, tp = _pair(f"tiny-share-{family}",
                           **(MOE_KW if family == "moe" else {}))
    arrivals = _shared_arrivals(rng=repro_rng)
    want, jinst = _jax(jm, jp, "paged", arrivals)
    shared, inst_s = _port(tm, tp, "paged", arrivals)
    unshared, inst_u = _port(tm, tp, "paged", arrivals,
                             prefix_sharing=False)
    static, _ = _port(tm, tp, "static", arrivals)
    assert shared == unshared == static == want
    assert inst_s.kv_int8 == int8
    assert inst_s.shared_block_hits > 0
    assert (inst_s.shared_block_hits, inst_s.cow_count) == (
        jinst.shared_block_hits, jinst.cow_count)
    assert inst_u.shared_block_hits == 0
    assert inst_s.allocator.high_watermark == jinst.allocator.high_watermark
    assert inst_s.allocator.high_watermark < inst_u.allocator.high_watermark
    assert inst_s.allocator.blocks_in_use == 0
    assert inst_s.pages.n_spares == 0


@pytest.mark.parametrize("fused", [True, False])
def test_exact_prompt_share_cow_resolves(models, fused):
    """Equal prompts share their tail block too; the first divergent
    append copies it into the reserved spare, as many times as JAX does,
    fused and host-argmax alike."""
    jm, jp, tm, tp = models
    prompt = np.random.default_rng(5).integers(0, 64, 20, dtype=np.int32)
    arrivals = [(prompt.copy(), 4) for _ in range(3)]  # 2 full + tail of 4
    want, jinst = _jax(jm, jp, "paged", arrivals, max_batch=4)
    shared, inst = _port(tm, tp, "paged", arrivals, max_batch=4,
                         fused=fused)
    unshared, _ = _port(tm, tp, "paged", arrivals, max_batch=4,
                        prefix_sharing=False)
    assert shared == unshared == want
    assert inst.cow_count > 0
    assert (inst.shared_block_hits, inst.cow_count) == (
        jinst.shared_block_hits, jinst.cow_count)
    assert inst.allocator.blocks_in_use == 0 and inst.pages.n_spares == 0


def test_kv_bytes_peak_charges_shared_blocks_once(models):
    """``kv_bytes_peak`` is the allocator's byte high watermark: a shared
    block counts once, the peak outlives the drain, it equals JAX's, and
    the telemetry carries the sharing counters."""
    jm, jp, tm, tp = models
    arrivals = _shared_arrivals(n=4, prefix_len=16, suffix_len=2,
                                max_new=(4,), seed=2)
    _, jinst = _jax(jm, jp, "paged", arrivals, max_batch=4)
    eng = _deploy(ServingEngine(window=0.1, device="cpu"), tm, tp, "paged",
                  Alloc(**FULL), max_batch=4)
    _, inst_s = _serve(eng, arrivals)
    _, inst_u = _port(tm, tp, "paged", arrivals, max_batch=4,
                      prefix_sharing=False)
    bb = tm.kv_block_bytes(8, False)
    for inst in (inst_s, inst_u):
        stats = inst.allocator.stats()
        assert inst.kv_bytes_peak == inst.allocator.bytes_high_watermark
        assert stats["bytes_high_watermark"] == stats["high_watermark"] * bb
        assert stats["bytes_in_use"] == 0
        assert inst.kv_bytes_peak > 0
    assert inst_s.kv_bytes_peak == jinst.kv_bytes_peak
    assert inst_s.kv_bytes_peak < inst_u.kv_bytes_peak
    (tel,) = eng.telemetry().values()
    assert (tel["shared_hits"], tel["cow"], tel["expired"]) == (
        inst_s.shared_block_hits, inst_s.cow_count, 0) != (0, 0, 0)


def test_kv_bytes_saved_mid_flight_matches_jax(models):
    """Mid-flight the port saves what JAX saves, in bytes, pass by pass,
    and nothing once drained."""
    jm, jp, tm, tp = models
    arrivals = _shared_arrivals(n=4, prefix_len=16, suffix_len=2,
                                max_new=(8,), seed=3)
    engines = [_deploy(JaxEngine(window=0.1), jm, jp, "paged",
                       JaxAlloc(**FULL), max_batch=4),
               _deploy(ServingEngine(window=0.1, device="cpu"), tm, tp,
                       "paged", Alloc(**FULL), max_batch=4)]
    for eng in engines:
        for p, n in arrivals:
            eng.submit("f", p, max_new_tokens=n)
    insts = [next(iter(e.instances.values())) for e in engines]
    saved = []
    while engines[1].has_work():
        for inst in insts:
            inst.run_step()
        saved.append(tuple(e.kv_bytes_saved() for e in engines))
    assert not engines[0].has_work()
    assert saved[0][0] > 0 and all(j == t for j, t in saved)
    assert saved[-1] == (0, 0)


def test_retire_drain_of_sharers_releases_cleanly(models):
    """Retiring the instance mid-flight drains its sharers with the
    unshared streams; refcounts, COW spares and registrations all unwind,
    and the strays are JAX's."""
    jm, jp, tm, tp = models
    arrivals = _shared_arrivals(n=4, prefix_len=16, suffix_len=2,
                                max_new=(6, 6, 3, 4), seed=7)
    reference, _ = _port(tm, tp, "paged", arrivals, prefix_sharing=False)
    out = []
    for eng in (_deploy(JaxEngine(window=0.1), jm, jp, "paged",
                        JaxAlloc(**FULL)),
                _deploy(ServingEngine(window=0.1, device="cpu"), tm, tp,
                        "paged", Alloc(**FULL))):
        reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
        (iid, inst), = eng.instances.items()
        inst.run_step()
        inst.run_step()
        alloc, pages = inst.allocator, inst.pages
        assert alloc.blocks_in_use > 0 and inst.shared_block_hits > 0
        strays = eng.retire(iid, strip_queue=True)
        eng.pump(budget_s=120.0)
        assert iid not in eng.instances
        assert alloc.blocks_in_use == 0 and pages.n_spares == 0
        assert alloc.registered_blocks == 0
        stray_ids = {r.req_id for r in strays}
        served = {i: r.tokens_out for i, r in enumerate(reqs)
                  if r.req_id not in stray_ids}
        assert served and all(r.done for r in reqs
                              if r.req_id not in stray_ids)
        out.append((sorted(stray_ids), served))
    assert out[0] == out[1]
    assert all(toks == reference[i] for i, toks in out[1][1].items())


# -- Model.copy_block ---------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_copy_block_equals_jax_bit_for_bit(models, int8, monkeypatch):
    """``Model.copy_block`` gives JAX's ``copy_block`` pools bit for bit,
    over pools of random contents, in place (each leaf keeps its
    storage) and touching no other block."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if int8 else "0")
    jm = jax_build(tiny_config(name=f"tiny-copy-{int(int8)}"))
    tm = build_model(ModelConfig(**dataclasses.asdict(jm.cfg)))
    rng = np.random.default_rng(9)
    shapes = jm.paged_cache_shapes(6, 8)
    jpool = {}
    for key, s in shapes.items():
        if s.dtype == jnp.int8:
            jpool[key] = jnp.asarray(rng.integers(-127, 128, s.shape),
                                     jnp.int8)
        else:
            jpool[key] = jnp.asarray(rng.normal(size=s.shape), s.dtype)
    tpool = bridge.to_torch(jax.device_get(jpool))
    assert (tpool["k"].dtype == torch.int8) == int8
    before = {k: v.clone() for k, v in tpool.items()}
    ptrs = {k: v.data_ptr() for k, v in tpool.items()}
    want = jm.copy_block(jpool, jnp.int32(2), jnp.int32(5))
    got = tm.copy_block(tpool, 2, 5)
    assert got is tpool and {k: v.data_ptr() for k, v in got.items()} == ptrs
    for key in shapes:
        ref = bridge.to_torch(jax.device_get({key: want[key]}))[key]
        assert got[key].dtype == ref.dtype and torch.equal(got[key], ref)
        assert torch.equal(got[key][:, 5], before[key][:, 2])
        others = [b for b in range(6) if b != 5]
        assert torch.equal(got[key][:, others], before[key][:, others])


# -- a property over random shared-prefix mixes -------------------------------


def _checked(inst):
    """Wrap the instance's fused admission and dispatch with independent
    checks of the write contract: every block a staged append row names
    (other than the null block and the sink) has refcount 1, and after
    COW so has every block an active slot's round will write."""
    admit, dispatch = inst._admit_fused, inst.dispatch_step
    seen = {"rows": 0}

    def admit_checked(slot, req, done, *plan):
        k = len(inst._pending_prefill)
        admit(slot, req, done, *plan)
        row = inst._args_stage.numpy()[k][_ROW:inst._tok0]
        for b in row.tolist():
            if b != 0 and b < inst.allocator.n_blocks:
                assert inst.allocator.refcount(b) == 1, (b, row)
        seen["rows"] += 1

    def dispatch_checked():
        out = dispatch()
        for slot, req in enumerate(inst.slots):
            if req is not None:
                b = inst._tables[slot][int(inst._pos[slot])
                                       // inst.block_size]
                assert inst.allocator.refcount(int(b)) == 1
        return out

    inst._admit_fused, inst.dispatch_step = admit_checked, dispatch_checked
    return seen


_PREFIX = np.random.default_rng(11).integers(0, 64, 24, dtype=np.int32)

mix_st = st.lists(
    st.tuples(st.integers(0, 24),   # shared prefix tokens taken
              st.integers(0, 5),    # unique suffix tokens after it
              st.integers(1, 6),    # new tokens
              st.booleans()),       # a copy of the previous prompt
    min_size=2, max_size=7)


@settings(max_examples=12, deadline=None)
@given(mix_st, st.integers(0, 2**16))
def test_random_shared_mixes_keep_streams_and_write_contract(models, mix,
                                                             seed):
    """Random mixes of prompts cut from one prefix (some exact repeats):
    the shared engine's streams equal the unshared engine's, no staged
    append row names a shared block, and no round writes one; the pool
    is empty again after the drain."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(seed)
    arrivals = []
    for take, extra, new, repeat in mix:
        if repeat and arrivals:
            arrivals.append((arrivals[-1][0].copy(), new))
            continue
        prompt = np.concatenate([_PREFIX[:take], rng.integers(
            0, 64, extra, dtype=np.int32)])
        if prompt.size == 0:
            prompt = _PREFIX[:1].copy()
        arrivals.append((prompt, new))
    eng = _deploy(ServingEngine(window=0.1, device="cpu"), tm, tp, "paged",
                  Alloc(**FULL), max_batch=3, max_len=48)
    seen = _checked(next(iter(eng.instances.values())))
    shared, inst = _serve(eng, arrivals)
    unshared, _ = _port(tm, tp, "paged", arrivals, max_batch=3, max_len=48,
                        prefix_sharing=False)
    assert shared == unshared
    assert seen["rows"] == len(arrivals)
    assert inst.allocator.blocks_in_use == 0 and inst.pages.n_spares == 0
