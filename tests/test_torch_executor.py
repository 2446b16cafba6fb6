"""The port's executor layer against the JAX engine, on the CPU: the fused
round (eager here; a CUDA graph on the card), its host-argmax reference
(``fused=False``), static batching, ``close`` and the KV byte accessors.
The port's counterparts of ``test_decode_hot_path.py``,
``test_continuous_batching.py:39-52`` and ``test_paged_kv.py:219-252``.

Both engines run the f32 tiny model (bf16 KV pools; the reduced rwkv6 and
hymba configs in f32 for the family cases); the JAX side disables prefix
sharing, which the port has not ported yet.  Token streams must be
identical.  Where JAX shows donation by a deleted pre-round buffer, the
port shows it by buffers that keep their address across rounds.
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
from repro_torch import bridge, kernels
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ServingEngine

torch.set_num_threads(2)

FULL = dict(sm=1.0, quota_request=0.9, quota_limit=0.9)
ARRIVALS = [(4, 3), (12, 6), (7, 1), (20, 5), (5, 4), (16, 6), (6, 2)]


def _pair(jcfg, seed=0):
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(seed)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


@pytest.fixture(scope="module")
def models():
    return _pair(tiny_config())


def _prompts(spec, seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, l, dtype=np.int32), n) for l, n in spec]


def _kw(batching, **kw):
    out = dict(max_batch=2, max_len=32)
    if batching == "paged":
        out["block_size"] = 8
    return {**out, **kw}


def _jax_engine(jm, jp, batching, **kw):
    eng = JaxEngine(window=0.1)
    eng.deploy("f", jm, jp, JaxAlloc(**FULL), batching=batching,
               prefix_sharing=False, **_kw(batching, **kw))
    return eng


def _torch_engine(tm, tp, batching, **kw):
    eng = ServingEngine(window=0.1, device="cpu")
    eng.deploy("f", tm, tp, Alloc(**FULL), batching=batching,
               **_kw(batching, **kw))
    return eng


def _serve(eng, arrivals):
    reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    assert eng.pump(budget_s=120.0) == len(reqs)
    assert all(r.done and len(r.tokens_out) == r.max_new_tokens
               for r in reqs)
    return [r.tokens_out for r in reqs]


# -- fused == host argmax == JAX ---------------------------------------------


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_fused_matches_host_argmax_and_jax(models, batching):
    """test_decode_hot_path.py::test_fused_matches_host_argmax (dense): the
    fused round, the host-argmax round and the JAX engine emit the same
    streams, with mid-flight admission."""
    jm, jp, tm, tp = models
    arrivals = _prompts(ARRIVALS)
    want = _serve(_jax_engine(jm, jp, batching), arrivals)
    fused = _torch_engine(tm, tp, batching)
    host = _torch_engine(tm, tp, batching, fused=False)
    assert _serve(fused, arrivals) == want
    assert _serve(host, arrivals) == want
    inst = next(iter(fused.instances.values()))
    assert inst.refills > 0, "trace must exercise mid-flight admission"
    assert inst.round_graph.eager_rounds == inst.rounds > 0
    assert inst.round_graph.captures == 0  # no graph on the CPU
    assert next(iter(host.instances.values())).round_graph is None


@pytest.mark.parametrize("family", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrent_families_fused_matches_host_argmax(family):
    """The rwkv6 and hybrid rounds (reduced, f32): fused == host argmax ==
    JAX, continuous."""
    jm, jp, tm, tp = _pair(jax_config(family, reduced=True), 1)
    arrivals = _prompts([(5, 4), (9, 6), (5, 3), (12, 5), (5, 2)], seed=3)
    want = _serve(_jax_engine(jm, jp, "continuous"), arrivals)
    assert _serve(_torch_engine(tm, tp, "continuous"), arrivals) == want
    assert _serve(_torch_engine(tm, tp, "continuous", fused=False),
                  arrivals) == want


def test_free_slot_writes_kept_out_at_five_blocks(models):
    """test_decode_hot_path.py:74-99: a 5-block pool (4 usable) holds A's
    2 blocks or B's 3, never both, so B waits for A's blocks and then
    decodes 9 rounds beside a free slot whose writes must land nowhere
    live (the last block among them)."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(5)
    arrivals = [(rng.integers(0, 64, 8, dtype=np.int32), 3),
                (rng.integers(0, 64, 8, dtype=np.int32), 10)]
    want = _serve(_jax_engine(jm, jp, "paged", n_kv_blocks=5), arrivals)
    for fused in (True, False):
        eng = _torch_engine(tm, tp, "paged", n_kv_blocks=5, fused=fused)
        assert _serve(eng, arrivals) == want
        inst = next(iter(eng.instances.values()))
        assert inst.allocator.high_watermark == 3


def test_one_host_sync_per_pass(models):
    """test_decode_hot_path.py:101-121: syncs == steps fused, continuous
    and paged; the host-argmax reference spends one per round plus one
    per admitted prompt, and the static batch one per prefill and round."""
    _, _, tm, tp = models
    arrivals = _prompts([(6, 4), (6, 1), (6, 3), (6, 5), (6, 2)])
    for batching in ("continuous", "paged"):
        eng = _torch_engine(tm, tp, batching)
        _serve(eng, arrivals)
        (stats,) = eng.telemetry().values()
        assert stats["syncs"] == stats["steps"] > 0
        assert eng.sync_counts() == {k: v["syncs"]
                                     for k, v in eng.telemetry().items()}
    for batching, fused in (("continuous", False), ("paged", False),
                            ("static", True)):
        eng = _torch_engine(tm, tp, batching, fused=fused)
        _serve(eng, arrivals)
        (stats,) = eng.telemetry().values()
        if batching == "static":  # each step a batch prefill or a round
            assert stats["syncs"] == stats["rounds"] + stats["prefills"] \
                == stats["steps"]
        else:
            assert stats["syncs"] == stats["rounds"] + len(arrivals) \
                > stats["steps"]


def test_paged_state_uploaded_only_when_dirty(models):
    """test_decode_hot_path.py:123-133: a solo paged decode of 19 rounds
    uploads its tables and positions once, at admission."""
    _, _, tm, tp = models
    eng = _torch_engine(tm, tp, "paged")
    _serve(eng, _prompts([(4, 20)]))
    (stats,) = eng.telemetry().values()
    assert stats["steps"] >= 19 and stats["rounds"] == 19
    assert stats["uploads"] == 1


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_round_buffers_keep_their_addresses(models, batching):
    """The port's version of the donation tests (test_decode_hot_path.py:
    135-170): the slot tokens, positions, tables, active mask and KV pools
    are the same storage in every round, written in place — what a
    captured graph needs."""
    _, _, tm, tp = models
    eng = _torch_engine(tm, tp, batching)
    for p, n in _prompts([(8, 8), (5, 6)]):
        eng.submit("f", p, max_new_tokens=n)
    inst = next(iter(eng.instances.values()))

    def buffers():
        bufs = {"tok": inst._slot_tok_dev,
                **{f"cache.{k}": v for k, v in inst.cache.items()}}
        if batching == "paged":
            bufs.update(tables=inst._tables_dev, pos=inst._pos_dev,
                        active=inst._active_dev)
        return {k: v.data_ptr() for k, v in bufs.items()}

    inst.run_step()  # admission + the first round
    first = buffers()
    seen = [inst.cache["pos"].clone() if batching == "continuous"
            else inst._pos_dev.clone()]
    while eng.has_work():
        inst.run_step()
        if inst.cache is not None:
            assert buffers() == first
            seen.append(inst.cache["pos"].clone() if batching ==
                        "continuous" else inst._pos_dev.clone())
    assert len(seen) > 4
    # The positions advanced in place: each round's differ from the last.
    assert all(not torch.equal(a, b) for a, b in zip(seen, seen[1:]))


# -- static batching ----------------------------------------------------------


def test_static_matches_continuous_and_jax(models):
    """test_continuous_batching.py:39-52: the same arrivals with mixed
    output lengths give the static batch's streams in continuous mode, and
    the port's static batch gives JAX's."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(0)
    arrivals = [(rng.integers(0, 64, 8, dtype=np.int32), n)
                for n in (3, 6, 4, 5, 2, 6)]
    static = _torch_engine(tm, tp, "static")
    got = _serve(static, arrivals)
    cont = _torch_engine(tm, tp, "continuous")
    assert _serve(cont, arrivals) == got
    assert _serve(_jax_engine(jm, jp, "static"), arrivals) == got
    assert next(iter(cont.instances.values())).refills > 0
    inst = next(iter(static.instances.values()))
    assert inst.round_graph is None and not inst.fused
    assert inst.prefills == 3 and inst.cache is None and not inst.active


@pytest.mark.parametrize("family", ["rwkv6-1.6b", "hymba-1.5b"])
def test_static_recurrent_families_match_jax(family):
    jm, jp, tm, tp = _pair(jax_config(family, reduced=True), 2)
    rng = np.random.default_rng(4)
    arrivals = [(rng.integers(0, 64, 6, dtype=np.int32), n)
                for n in (2, 5, 3)]
    want = _serve(_jax_engine(jm, jp, "static"), arrivals)
    assert _serve(_torch_engine(tm, tp, "static"), arrivals) == want
    assert _serve(_torch_engine(tm, tp, "continuous"), arrivals) == want


# -- KV byte accessors and close ----------------------------------------------


def _accessors(inst):
    return (inst.kv_bytes_in_use(), inst.dense_kv_reserved(),
            inst.kv_bytes_peak, inst.kv_bytes_saved())


@pytest.mark.parametrize("batching", ["continuous", "paged", "static"])
def test_kv_byte_accessors_match_jax(models, batching):
    """The accessors (engine.py:405-435) and the node sums (:1476-1488)
    give JAX's numbers before, during and after serving, stepped pass by
    pass in lockstep."""
    jm, jp, tm, tp = models
    arrivals = _prompts([(8, 3), (14, 6), (6, 2)], seed=3)
    kw = dict(n_instances=2, max_batch=2) if batching != "static" else {}
    jeng = _jax_engine(jm, jp, batching, **kw)
    teng = _torch_engine(tm, tp, batching, **kw)
    if batching == "static":
        arrivals = [(p[:6], n) for p, n in arrivals]
    for eng in (jeng, teng):
        for p, n in arrivals:
            eng.submit("f", p, max_new_tokens=n)
    pairs = list(zip(jeng.instances.values(), teng.instances.values()))
    peaks = set()
    while teng.has_work():
        for ji, ti in pairs:
            assert _accessors(ti) == _accessors(ji)
            peaks.add(ti.kv_bytes_peak)
            ji.run_step()
            ti.run_step()
        for name in ("kv_bytes_in_use", "dense_kv_reserved",
                     "kv_bytes_saved"):
            assert getattr(teng, name)() == getattr(jeng, name)()
    assert not jeng.has_work()
    for ji, ti in pairs:
        assert _accessors(ti) == _accessors(ji)
        if batching == "paged":
            assert 0 < ti.kv_bytes_peak < ti.dense_kv_reserved()
            assert ti.kv_bytes_in_use() == ti.kv_bytes_saved() == 0
    assert len(peaks) > 1


def test_close_releases_blocks_and_weights(models):
    """close (engine.py:396-401) on a live paged instance frees its blocks
    and hands its reference to the stored weights back."""
    _, _, tm, tp = models
    eng = _torch_engine(tm, tp, "paged", n_instances=2)
    for p, n in _prompts([(8, 6), (12, 6)]):
        eng.submit("f", p, max_new_tokens=n)
    insts = list(eng.instances.values())
    for inst in insts:
        inst.run_step()
        assert inst.allocator.blocks_in_use > 0
    assert eng.store.refcount("f") == 2
    for k, inst in enumerate(insts):
        inst.close()
        assert inst.allocator.blocks_in_use == 0
        assert inst.kv_bytes_in_use() == 0
        assert eng.store.refcount("f") == 1 - k
    assert eng.kv_bytes_in_use() == 0


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_dropped_engine_frees_its_pools_at_once(models, batching):
    """An instance holds its round graph and the graph keeps no reference
    back (it takes the round per call), so a dropped engine frees its KV
    pools at once, not whenever the cycle collector runs: on the card a
    pool is hundreds of MB."""
    import gc
    import weakref
    _, _, tm, tp = models
    eng = _torch_engine(tm, tp, batching)
    _serve(eng, _prompts([(8, 4), (6, 3)]))
    inst = next(iter(eng.instances.values()))
    refs = [weakref.ref(inst), weakref.ref(inst.cache["k"])]
    gc.disable()
    try:
        del eng, inst
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_launch_counters_take_a_replayed_delta():
    """``counter_values``/``add_launches`` (what a replayed graph adds):
    one entry per counter, applied in order, refused at another length."""
    kernels.reset_launch_counts()
    delta = list(range(1, len(kernels.COUNTED) + 1))
    kernels.add_launches(delta)
    kernels.add_launches(delta)
    assert kernels.counter_values() == [2 * n for n in delta]
    assert kernels.launch_counts()["decode_attention"] == 2 * (
        list(kernels.KERNELS).index("decode_attention") + 1)
    with pytest.raises(ValueError):
        kernels.add_launches(delta[:-1])
    kernels.reset_launch_counts()
    assert not any(kernels.counter_values())


# -- the overlapped pump: who dispatches early --------------------------------


HALF = dict(sm=0.5, quota_request=1.0, quota_limit=1.0)


def _logged_passes(eng):
    """Wrap the scheduler's grants and every instance's dispatch and sync:
    returns the log, a list of passes, each [granted ids, events]."""
    passes = []
    grant = eng.scheduler.dispatch

    def dispatch(now):
        granted = grant(now)
        if granted:
            passes.append([[t.pod_id for t in granted], []])
        return granted

    eng.scheduler.dispatch = dispatch
    for inst_id, inst in eng.instances.items():
        for name in ("dispatch_step", "sync_step"):
            def logged(fn=getattr(inst, name), name=name, inst_id=inst_id):
                passes[-1][1].append((name, inst_id))
                return fn()
            setattr(inst, name, logged)
    return passes


def _jax_order(granted, fused):
    """JAX engine.py:1382-1404: with overlap, fused instances dispatch in
    a first pass; the sync pass dispatches the others just before their
    own sync."""
    out = [("dispatch_step", g) for g in granted if fused[g]]
    for g in granted:
        if not fused[g]:
            out.append(("dispatch_step", g))
        out.append(("sync_step", g))
    return out


@pytest.mark.parametrize("host_batching", ["continuous", "static"])
def test_overlapped_pump_times_host_synchronous_steps_in_their_own_leg(
        models, host_batching):
    """One fused and one host-synchronous instance (``fused=False``
    continuous, or static) at half the SMs each, so one pass grants both.
    With ``overlap=True`` only the fused one dispatches early; the other
    runs its whole step in the sync pass, just before its own sync, so its
    wall time lands in its own ``elapsed`` and ``Q_used``.  The JAX engine
    and the port follow that order pass by pass, and serve the same
    streams."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(7)
    arrivals = [(rng.integers(0, 64, 6, dtype=np.int32), n)
                for n in (4, 3, 5, 2)]
    streams = {}
    for side in ("jax", "torch"):
        if side == "jax":
            eng = JaxEngine(window=10.0)
            deploy = dict(prefix_sharing=False)
            m, p, alloc = jm, jp, JaxAlloc(**HALF)
        else:
            eng = ServingEngine(window=10.0, device="cpu")
            deploy = {}
            m, p, alloc = tm, tp, Alloc(**HALF)
        eng.deploy("a", m, p, alloc, max_batch=2, max_len=32, **deploy)
        eng.deploy("b", m, p, alloc, max_batch=2, max_len=32,
                   batching=host_batching, fused=False, **deploy)
        fused = {k: i.fused for k, i in eng.instances.items()}
        assert sorted(fused.values()) == [False, True]
        passes = _logged_passes(eng)
        reqs = [eng.submit(fn, q, max_new_tokens=n)
                for q, n in arrivals for fn in ("a", "b")]
        assert eng.pump(budget_s=120.0, overlap=True) == len(reqs)
        for granted, events in passes:
            assert events == _jax_order(granted, fused), (side, granted)
        assert any(len(g) == 2 for g, _ in passes), "no pass granted both"
        streams[side] = [r.tokens_out for r in reqs]
    assert streams["torch"] == streams["jax"]
