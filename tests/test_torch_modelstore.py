"""The port's fleet model store (``repro_torch.serving.modelstore``) and
the two ``Model`` methods it and admission use, against the JAX
package's (``repro.serving.modelstore``, ``repro.models.model``):

* ``stage_params`` gives JAX's shards (the same stacked leaves, split
  per layer, bit for bit, and the same byte count), and
  ``upload_params`` in both modes gives the params back bit for bit;
* ``StagedWeights.copy()`` is deep;
* the ``FleetModelStore`` tier sequence (device, host, peer, cold), its
  pins and telemetry, and the ``HostWeightCache`` eviction order equal
  JAX's under the same acquire / release / drop script (the cache order
  as a hypothesis property);
* ``Model.param_names`` marks JAX's stacked leaves and
  ``Model.kv_cache_bytes`` equals JAX's, bf16 and int8.

Both packages run the tiny config on the CPU.  Tolerance: exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import tiny_config
from repro.models import build_model as jax_build
from repro.serving import modelstore as jstore
from repro_torch import bridge
from repro_torch.core.model_sharing import pytree_nbytes
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serving import modelstore as tstore


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_config(name="tiny-store")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(3))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


def _bits(x):
    """A torch leaf as comparable host bits (bf16 by its pattern)."""
    t = x.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_param_names_mark_jax_stacked_leaves(models):
    jm, _, tm, _ = models
    got = [n[0] == "layers" if n else False
           for n in tstore._name_leaves(tm)]
    want = [bool(n) and n[0] == "layers" for n in jstore._name_leaves(jm)]
    assert got == want and any(got)
    lens = [len(n) for n in tstore._name_leaves(tm)]
    assert lens == [len(n) for n in jstore._name_leaves(jm)]


def test_stage_gives_jax_shards_bit_for_bit(models):
    jm, jp, tm, tp = models
    got = tstore.stage_params(tm, tp)
    want = jstore.stage_params(jm, jp)
    assert got.stacked == want.stacked and got.nbytes == want.nbytes
    assert got.nbytes == pytree_nbytes(tp)
    assert not got.pinned  # no card here; pinned on one
    for a, b in zip(got.leaves, want.leaves):
        if isinstance(b, list):
            assert len(a) == len(b)
            pairs = zip(a, b)
        else:
            pairs = [(a, b)]
        for x, y in pairs:
            assert x.shape == y.shape and x.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(
                x, y.view(np.int16) if y.dtype.name == "bfloat16" else y)


@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_upload_roundtrips_bit_for_bit(models, mode):
    _, _, tm, tp = models
    staged = tstore.stage_params(tm, tp)
    up, ready = tstore.upload_params(staged, mode=mode, device="cpu")
    assert ready is None  # the CPU copies synchronously
    want = tstore._flatten(tp)
    got = tstore._flatten(up)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.data_ptr() != b.data_ptr()
        np.testing.assert_array_equal(_bits(a), _bits(b))
    with pytest.raises(ValueError, match="unknown upload mode"):
        tstore.upload_params(staged, mode="streaming", device="cpu")


def test_staged_copy_is_deep(models):
    _, _, tm, tp = models
    staged = tstore.stage_params(tm, tp)
    clone = staged.copy()
    assert clone.buffer.data_ptr() != staged.buffer.data_ptr()
    assert clone.pinned == staged.pinned and clone.nbytes == staged.nbytes
    i = staged.stacked.index(True)
    clone.leaves[i][1][...] = 7
    assert not np.array_equal(staged.leaves[i][1], clone.leaves[i][1])
    assert (clone.host_tensor(i, 1).view(torch.int16) == 7).all()


def _tier_script(store_mod, model, params, upload_kw):
    """One acquire / release / drop script over a fleet store: each
    step's tier, peer, pins and telemetry."""
    store = store_mod.FleetModelStore()
    out = []

    def acquire(node, **kw):
        _, e = store.acquire(node, "fn", model, **kw, **upload_kw)
        out.append((e.tier, e.node, e.peer, e.nbytes,
                    [store.cache(n).pins("fn") for n in (0, 1, 2)],
                    store.warm_nodes("fn")))

    acquire(0, params=params)              # cold
    acquire(0)                             # host
    acquire(1)                             # peer from 0
    acquire(1, params=None, resident=True)  # device tier
    store.release(0, "fn")
    store.release(1, "fn")
    store.drop_node(0)
    out.append(store.warm_nodes("fn"))
    acquire(2)                             # peer from 1
    with pytest.raises(ValueError, match="cold miss"):
        store.acquire(3, "other", model, **upload_kw)
    t = store.telemetry()
    t.pop("host_used_bytes")
    out.append(t)
    return out


def test_fleet_tier_sequence_equals_jax(models):
    jm, jp, tm, tp = models
    assert _tier_script(tstore, tm, tp, {"device": "cpu"}) == \
        _tier_script(jstore, jm, jp, {})


def _ballast(mod, nbytes):
    """A cheap staged entry of ``nbytes``: the real staging of one flat
    uint8 leaf in each package."""
    if mod is tstore:
        return tstore.stage_params(None, {"w": np.zeros(nbytes, np.uint8)})
    arr = np.zeros(nbytes, dtype=np.uint8)
    return jstore.StagedWeights(jax.tree_util.tree_structure([0]), [arr],
                                [False], arr.nbytes)


_CACHE_OPS = st.lists(st.tuples(
    st.sampled_from(["put", "get", "pin", "unpin", "drop"]),
    st.sampled_from("abcde"), st.sampled_from([10, 20, 30, 40])),
    min_size=1, max_size=30)


def _cache_trace(mod, ops):
    cache = mod.HostWeightCache(capacity_bytes=100)
    out = []
    for op, key, size in ops:
        try:
            if op == "put":
                cache.put(key, _ballast(mod, size))
            elif op == "get" and cache.contains(key):
                cache.get(key)
            elif op == "pin":
                cache.pin(key)
            elif op == "unpin":
                cache.unpin(key)
            elif op == "drop":
                cache.drop(key)
            out.append((cache.keys(), cache.used_bytes(), cache.evictions,
                        [cache.pins(k) for k in "abcde"]))
        except MemoryError as err:
            out.append(("MemoryError", str(err)))
    return out


@settings(max_examples=60, deadline=None)
@given(ops=_CACHE_OPS)
def test_host_cache_eviction_order_equals_jax(ops):
    assert _cache_trace(tstore, ops) == _cache_trace(jstore, ops)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("batching,n_kv_blocks", [
    ("continuous", None), ("paged", None), ("paged", 9)])
def test_kv_cache_bytes_equals_jax(models, monkeypatch, int8, batching,
                                   n_kv_blocks):
    jm, _, tm, _ = models
    if int8:
        monkeypatch.setenv("REPRO_KV_INT8", "1")
    else:
        monkeypatch.delenv("REPRO_KV_INT8", raising=False)
    kw = dict(batching=batching, max_batch=3, max_len=32, block_size=8,
              n_kv_blocks=n_kv_blocks)
    assert tm.kv_cache_bytes(**kw) == jm.kv_cache_bytes(**kw)
    assert tm.kv_cache_bytes(**kw, kv_int8=int8) == jm.kv_cache_bytes(**kw)
