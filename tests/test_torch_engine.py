"""The port's ``ServingEngine`` against the JAX one: the same arrivals give
the same greedy token streams, continuous and paged, with one host sync
per pass (mirrors ``test_continuous_batching`` and ``test_paged_kv``).

Both engines run the f32 tiny model (bf16 KV pools) on the CPU; the JAX
side deploys with prefix sharing off, the port's paged instances share
by default, and these random prompts share no block (sharing's own tests
are in ``test_torch_prefix_sharing.py``).  The
int8-KV engines (tiny, f32), the rwkv6 engines (reduced rwkv6-1.6b, f32)
and the hybrid engines (reduced hymba-1.5b, f32) give the same streams
too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro.configs import get_config as jax_config
from repro.core.resources import Alloc as JaxAlloc
from repro.models import build_model as jax_build
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ServingEngine

torch.set_num_threads(2)

FULL = dict(sm=1.0, quota_request=0.9, quota_limit=0.9)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_config()
    jm = jax_build(cfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(0)))
    tm = build_model(ModelConfig(**dataclasses.asdict(cfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


def _arrivals(spec, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, l, dtype=np.int32), n) for l, n in spec]


def _serve_jax(jm, jp, batching, arrivals, **kw):
    eng = JaxEngine(window=0.1)
    eng.deploy("f", jm, jp, JaxAlloc(**FULL), batching=batching,
               prefix_sharing=False, **kw)
    reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    assert eng.pump(budget_s=120.0) == len(reqs)
    return reqs, eng


def _serve_torch(tm, tp, batching, arrivals, overlap=True, **kw):
    eng = ServingEngine(window=0.1, device="cpu")
    eng.deploy("f", tm, tp, Alloc(**FULL), batching=batching, **kw)
    reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    assert eng.pump(budget_s=120.0, overlap=overlap) == len(reqs)
    assert not eng.has_work()
    return reqs, eng


MIXED = [(4, 3), (12, 6), (7, 2), (20, 5), (5, 4), (16, 6), (3, 1)]


@pytest.mark.parametrize("batching", ["continuous", "paged"])
@pytest.mark.parametrize("n_instances,overlap", [(1, True), (2, True),
                                                 (2, False)])
def test_engine_streams_match_jax(models, batching, n_instances, overlap):
    jm, jp, tm, tp = models
    arrivals = _arrivals(MIXED)
    kw = dict(n_instances=n_instances, max_batch=2, max_len=32,
              block_size=8)
    jreqs, _ = _serve_jax(jm, jp, batching, arrivals, **kw)
    treqs, eng = _serve_torch(tm, tp, batching, arrivals, overlap=overlap,
                              **kw)
    assert [r.tokens_out for r in treqs] == [r.tokens_out for r in jreqs]
    assert all(r.done and len(r.tokens_out) == r.max_new_tokens
               for r in treqs)
    # One host pull per pass, prefill tokens included.
    for inst in eng.instances.values():
        assert inst.sync_count == inst.steps > 0
    assert eng.sync_counts() == {k: v["syncs"]
                                 for k, v in eng.telemetry().items()}
    assert eng.memory_bytes() == sum(
        t.numel() * t.element_size() for t in _leaves(tp))
    if batching == "paged":
        for inst in eng.instances.values():
            assert inst.allocator.blocks_in_use == 0
            assert inst.uploads < inst.steps


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_paged_matches_continuous_and_refills(models):
    jm, jp, tm, tp = models
    arrivals = _arrivals([(4, 3), (12, 6), (7, 2), (20, 5), (5, 4),
                          (16, 6)])
    cont, _ = _serve_torch(tm, tp, "continuous", arrivals, max_batch=2,
                           max_len=32)
    paged, eng = _serve_torch(tm, tp, "paged", arrivals, max_batch=2,
                              max_len=32, block_size=8)
    assert [r.tokens_out for r in cont] == [r.tokens_out for r in paged]
    inst = next(iter(eng.instances.values()))
    assert inst.refills > 0, "trace must exercise mid-flight admission"


def test_slot_reuse_matches_solo_runs(models):
    """max_batch=1: each request decodes in the slot the previous one just
    vacated, exactly as if it had the cache to itself."""
    jm, jp, tm, tp = models
    arrivals = _arrivals([(8, 4)] * 3, seed=7)
    reqs, eng = _serve_torch(tm, tp, "continuous", arrivals, max_batch=1,
                             max_len=32)
    inst = next(iter(eng.instances.values()))
    assert inst.steps <= sum(n for _, n in arrivals) + len(arrivals)
    for (p, n), r in zip(arrivals, reqs):
        solo, _ = _serve_torch(tm, tp, "continuous", [(p, n)], max_batch=1,
                               max_len=32)
        assert r.tokens_out == solo[0].tokens_out


def test_block_exhaustion_serializes_admission(models):
    """A pool too small for two concurrent requests serializes them; the
    queue waits for blocks and nothing leaks (test_paged_kv.py:174)."""
    jm, jp, tm, tp = models
    arrivals = _arrivals([(8, 4)] * 4)
    reqs, eng = _serve_torch(tm, tp, "paged", arrivals, max_batch=2,
                             max_len=32, block_size=8, n_kv_blocks=4)
    jreqs, _ = _serve_jax(jm, jp, "paged", arrivals, max_batch=2,
                          max_len=32, block_size=8, n_kv_blocks=4)
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in jreqs]
    inst = next(iter(eng.instances.values()))
    assert inst.allocator.high_watermark <= 3
    assert inst.allocator.stats()["allocs"] == 8
    assert inst.allocator.blocks_in_use == 0


def test_submit_rejects_what_cannot_fit(models):
    _, _, tm, tp = models
    eng = ServingEngine(device="cpu")
    eng.deploy("f", tm, tp, Alloc(**FULL), max_len=16, batching="paged",
               block_size=8, n_kv_blocks=2)
    with pytest.raises(ValueError):
        eng.submit("f", np.zeros(12, np.int32), max_new_tokens=8)
    with pytest.raises(ValueError):  # 2 blocks > 1 usable block
        eng.submit("f", np.zeros(8, np.int32), max_new_tokens=4)
    with pytest.raises(KeyError):
        eng.submit("g", np.zeros(4, np.int32))


def test_unported_modes_raise(models):
    """Prefix sharing is ported (on by default, for paged instances only,
    as in JAX; its tests are in ``test_torch_prefix_sharing.py``), and so
    is static batching (``test_torch_executor.py``); an unknown mode is
    refused."""
    _, _, tm, tp = models
    eng = ServingEngine(device="cpu")
    [paged] = eng.deploy("g", tm, tp, Alloc(**FULL), batching="paged")
    [cont] = eng.deploy("c", tm, tp, Alloc(**FULL), prefix_sharing=True)
    assert eng.instances[paged].prefix_sharing
    assert not eng.instances[cont].prefix_sharing
    with pytest.raises(ValueError):
        eng.deploy("h", tm, tp, Alloc(**FULL), batching="dynamic")


# -- int8 KV, rwkv6 and the hybrid through the engine -------------------------


def _f32_pair(jcfg, seed):
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(seed)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_int8_engine_streams_match_jax(monkeypatch, batching):
    """Under the int8 gate both engines serve from int8 pools; the port's
    instance pins the gate when it is built (a later change of the
    variable does not move it) and paged admission charges int8 blocks."""
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    # A config of its own, so no JAX trace made without the gate is reused.
    jm, jp, tm, tp = _f32_pair(tiny_config(name="tiny-int8-engine"), 0)
    arrivals = _arrivals(MIXED)
    kw = dict(n_instances=2, max_batch=2, max_len=32, block_size=8)
    jreqs, _ = _serve_jax(jm, jp, batching, arrivals, **kw)
    int8_block = jm.kv_block_bytes(8)
    eng = ServingEngine(window=0.1, device="cpu")
    eng.deploy("f", tm, tp, Alloc(**FULL), batching=batching, **kw)
    monkeypatch.setenv("REPRO_KV_INT8", "0")
    treqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    assert eng.pump(budget_s=120.0) == len(treqs)
    assert [r.tokens_out for r in treqs] == [r.tokens_out for r in jreqs]
    for inst in eng.instances.values():
        assert inst.kv_int8 and inst.cache["k"].dtype == torch.int8
        assert inst.sync_count == inst.steps > 0
        if batching == "paged":
            assert inst.allocator.block_bytes == int8_block \
                < tm.kv_block_bytes(8)  # bf16 now that the gate is off
            assert inst.allocator.blocks_in_use == 0


def test_rwkv_engine_streams_match_jax():
    """rwkv6 (reduced, f32) serves continuous batches at exact prompt
    lengths with the same greedy streams as the JAX engine; two instances
    share one weight copy."""
    jm, jp, tm, tp = _f32_pair(jax_config("rwkv6-1.6b", reduced=True), 1)
    arrivals = _arrivals([(5, 4), (9, 6), (5, 3), (9, 5), (5, 2)], seed=3)
    kw = dict(n_instances=2, max_batch=2, max_len=32)
    jreqs, _ = _serve_jax(jm, jp, "continuous", arrivals, **kw)
    treqs, eng = _serve_torch(tm, tp, "continuous", arrivals, **kw)
    assert [r.tokens_out for r in treqs] == [r.tokens_out for r in jreqs]
    tel = eng.telemetry()
    assert sum(v["prefills"] for v in tel.values()) == len(arrivals)
    for inst in eng.instances.values():
        assert not inst.bucketed and set(inst.cache) == {"wkv", "tm_x",
                                                         "cm_x", "pos"}
        assert inst.sync_count == inst.steps > 0
    assert eng.memory_bytes() == sum(
        t.numel() * t.element_size() for t in _leaves(tp))
    with pytest.raises(ValueError):
        eng.deploy("g", tm, tp, Alloc(**FULL), batching="paged")


@pytest.mark.parametrize("n_instances", [1, 2])
def test_hybrid_engine_streams_match_jax(n_instances):
    """hymba (reduced: window 8, 4 meta tokens; f32) serves continuous
    batches at exact prompt lengths with the same greedy streams as the
    JAX engine, prompts of 3-20 tokens passing the window so the rolled
    caches wrap, one host sync per pass and one stored weight copy."""
    jm, jp, tm, tp = _f32_pair(jax_config("hymba-1.5b", reduced=True), 2)
    arrivals = _arrivals([(3, 4), (12, 6), (20, 3), (7, 5), (16, 2)],
                         seed=5)
    kw = dict(n_instances=n_instances, max_batch=2, max_len=32)
    jreqs, _ = _serve_jax(jm, jp, "continuous", arrivals, **kw)
    treqs, eng = _serve_torch(tm, tp, "continuous", arrivals, **kw)
    assert [r.tokens_out for r in treqs] == [r.tokens_out for r in jreqs]
    assert all(r.done and len(r.tokens_out) == r.max_new_tokens
               for r in treqs)
    tel = eng.telemetry()
    assert sum(v["prefills"] for v in tel.values()) == len(arrivals)
    for inst in eng.instances.values():
        assert not inst.bucketed and set(inst.cache) == {"k", "v", "ssm",
                                                         "pos"}
        assert inst.cache["k"].shape[2] == 8  # the window
        assert inst.sync_count == inst.steps > 0
    assert eng.memory_bytes() == sum(
        t.numel() * t.element_size() for t in _leaves(tp))
