"""The instance lifecycle of the port's engine against the JAX engine
(mirrors the engine half of ``test_lifecycle.py`` and ``test_chaos.py``):
migration by ``export_slot``/``import_slot`` mid-decode, pausing,
``retire`` and ``fail``, deadline expiry and the batch lane, the health
EWMA, ``first_token_at``, admission without prefill buckets, and that a
closed instance is collected with its graphs.

Both packages run f32 params of the tiny config on the CPU (bf16 KV
pools).  Tolerance: identical tokens, counts and request ids; health to
1e-12 (the same float arithmetic in another package).
"""

import dataclasses
import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro.core.resources import Alloc as JaxAlloc
from repro.models import build_model as jax_build
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ServeRequest, ServingEngine

torch.set_num_threads(2)

FULL = dict(sm=1.0, quota_request=0.9, quota_limit=0.9)


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_config(name="tiny-lifecycle")
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(0)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


def _engines(models, batching="continuous", **kw):
    """A JAX and a port engine, each with one instance of ``f``."""
    jm, jp, tm, tp = models
    kw = dict(max_batch=2, max_len=32, batching=batching, block_size=8,
              **kw)
    jeng = JaxEngine(window=0.1)
    jeng.deploy("f", jm, jp, JaxAlloc(**FULL), **kw)
    teng = ServingEngine(window=0.1, device="cpu")
    teng.deploy("f", tm, tp, Alloc(**FULL), **kw)
    return jeng, teng


def _cohort(seed=4, n=3, prefix=16, suffix=2, new=8, dup=False):
    """Prompts of one 16-token prefix (two full blocks of 8) and a suffix
    each, or (``dup``) one prompt repeated."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 64, prefix, dtype=np.int32)
    tail = rng.integers(0, 64, suffix, dtype=np.int32)
    return [(np.concatenate([head, tail if dup else rng.integers(
        0, 64, suffix, dtype=np.int32)]), new) for _ in range(n)]


# -- migration ----------------------------------------------------------------


def _migrated(eng_cls_args, arrivals, migrate):
    """Serve ``arrivals`` on a source instance for two passes, then (if
    ``migrate``) move every occupied slot and the queue into a target
    instance on another engine, as ``ClusterFrontend.migrate`` does, and
    retire the source.  Returns the streams and the target instance."""
    make, deploy = eng_cls_args
    src, dst = make(), make()
    deploy(src)
    deploy(dst)
    reqs = [src.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    (iid, inst), = src.instances.items()
    inst.run_step()
    inst.run_step()
    assert inst.n_active() > 0 and inst.queue
    (tgt,) = dst.instances.values()
    if migrate:
        inst.paused = True
        for slot, req in enumerate(inst.slots):
            if req is None:
                continue
            tgt.import_slot(slot, *inst.export_slot(slot))
            inst.slots[slot] = None
            if inst.batching == "paged":
                inst._release_paged(slot)
        tgt.queue.extend(inst.queue)
        inst.queue.clear()
        src.retire(iid)
        assert not src.instances
        dst.pump(budget_s=120.0)
    else:
        src.pump(budget_s=120.0)
    assert all(r.done for r in reqs)
    return [r.tokens_out for r in reqs], tgt


def _factories(models, pkg, batching, sharing):
    jm, jp, tm, tp = models
    kw = dict(max_batch=2, max_len=32, batching=batching, block_size=8,
              prefix_sharing=sharing)
    if pkg == "jax":
        return (lambda: JaxEngine(window=0.1),
                lambda e: e.deploy("f", jm, jp, JaxAlloc(**FULL), **kw))
    return (lambda: ServingEngine(window=0.1, device="cpu"),
            lambda e: e.deploy("f", tm, tp, Alloc(**FULL), **kw))


@pytest.mark.parametrize("batching,sharing", [
    ("continuous", True), ("paged", False), ("paged", True)])
@pytest.mark.parametrize("dup", [False, True], ids=["suffixes", "repeats"])
def test_migration_mid_decode_equals_unmigrated_and_jax(models, batching,
                                                        sharing, dup):
    """Slots moved mid-decode between two port engines give the streams
    of the unmigrated run and of the same migration between two JAX
    engines; the targets' sharing hits agree."""
    arrivals = _cohort(dup=dup)
    port = _factories(models, "torch", batching, sharing)
    moved, tgt = _migrated(port, arrivals, migrate=True)
    stayed, _ = _migrated(port, arrivals, migrate=False)
    want, jtgt = _migrated(_factories(models, "jax", batching, sharing),
                           arrivals, migrate=True)
    assert moved == stayed == want
    assert tgt.shared_block_hits == jtgt.shared_block_hits
    assert tgt.prefix_sharing == (sharing and batching == "paged")


@pytest.mark.parametrize("dup", [False, True], ids=["suffixes", "repeats"])
def test_import_reshares_full_blocks_and_keeps_the_tail_private(models,
                                                                dup):
    """Two sharers of a 16-token prefix imported into a paged instance:
    the second maps the first's two full prompt blocks, while each holds
    its own tail block (it holds decode rows), even when the prompts are
    equal."""
    arrivals = _cohort(n=2, dup=dup)
    _, src = _engines(models, "paged")
    _, dst = _engines(models, "paged")
    for p, n in arrivals:
        src.submit("f", p, max_new_tokens=n)
    (inst,), (tgt,) = src.instances.values(), dst.instances.values()
    inst.run_step()
    inst.run_step()
    for slot in (0, 1):
        tgt.import_slot(slot, *inst.export_slot(slot))
    a, b = tgt.pages.blocks(0), tgt.pages.blocks(1)
    assert a[:2] == b[:2] and tgt.shared_block_hits == 2
    assert all(tgt.allocator.refcount(x) == 2 for x in a[:2])
    assert a[2] != b[2] and tgt.allocator.refcount(a[2]) == 1
    assert tgt.allocator.refcount(b[2]) == 1 and tgt.pages.n_spares == 0
    assert all(tgt._tables[s][i] == blk for s, blocks in enumerate((a, b))
               for i, blk in enumerate(blocks))


def test_export_and_import_refuse_mid_pass_and_static(models):
    """A static instance absorbs no slot, an occupied slot takes no
    import, and export and import run only between passes (after the
    pass's sync, when the host mirrors are current)."""
    _, teng = _engines(models, "paged")
    _, static = _engines(models, "static")
    _, other = _engines(models, "paged")
    (inst,), (st,) = teng.instances.values(), static.instances.values()
    (tgt,) = other.instances.values()
    with pytest.raises(ValueError, match="empty"):
        inst.export_slot(0)
    for p, n in _cohort(n=2):
        teng.submit("f", p, max_new_tokens=n)
    inst.run_step()
    exported = inst.export_slot(0)
    with pytest.raises(ValueError, match="static"):
        st.import_slot(0, *exported)
    with pytest.raises(ValueError, match="occupied"):
        inst.import_slot(1, *exported)
    inst.dispatch_step()
    with pytest.raises(RuntimeError, match="between passes"):
        inst.export_slot(0)
    other.submit("f", np.arange(5, dtype=np.int32), max_new_tokens=4)
    tgt.dispatch_step()
    with pytest.raises(RuntimeError, match="between passes"):
        tgt.import_slot(1, *exported)
    inst.sync_step()
    tgt.sync_step()
    tgt.import_slot(1, *inst.export_slot(0))
    assert tgt.n_active() == 2


def test_paged_export_lies_on_the_pools_device(models):
    """``gather_pages`` puts every leaf of the entry, ``pos`` too, on the
    pools' device, as ``gather_slot`` does (and JAX's ``jnp`` pos): a slot
    pool then merges it at a device slot index.  Shown on ``meta`` pools,
    a device other than the host's; ``pos`` on the host made the merge
    raise."""
    _, _, tm, _ = models
    pages = tm.init_paged_cache(5, 8, "meta", kv_int8=False)
    entry = tm.gather_pages(pages, [1, 2, 0, 0], 9)
    assert {v.device.type for v in entry.values()} == {"meta"}
    assert entry["pos"].shape == () and entry["pos"].dtype == torch.int32
    pool = tm.init_slot_cache(2, 32, "meta", kv_int8=False)
    tm.merge_slot(pool, entry, torch.tensor([1], device="meta"))


def test_paused_instance_dispatches_nothing(models):
    """A paused instance dispatches no step, asks for no token and takes
    no new request; unpaused, it serves as before (JAX's protocol)."""
    jeng, teng = _engines(models)
    for eng in (jeng, teng):
        (inst,) = eng.instances.values()
        eng.submit("f", np.arange(6, dtype=np.int32), max_new_tokens=3)
        inst.paused = True
        assert inst.dispatch_step() is False and inst.steps == 0
        assert inst.run_step() == [] and eng.pump(budget_s=5.0) == 0
        with pytest.raises(KeyError):
            eng.submit("f", np.arange(4, dtype=np.int32))
        inst.paused = False
        assert eng.pump(budget_s=60.0) == 1
    assert (next(iter(teng.instances.values())).steps
            == next(iter(jeng.instances.values())).steps)


# -- retire and fail ----------------------------------------------------------


@pytest.mark.parametrize("strip_queue", [True, False])
@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_retire_drains_closes_and_fires_the_callback(models, strip_queue,
                                                     batching):
    """``retire`` returns the queue (or keeps it), the occupants drain to
    JAX's streams, the instance closes after its last sync, its blocks
    and store reference are released, and ``on_instance_closed`` fires
    once, as in JAX."""
    arrivals = _cohort(n=4, new=5)
    out = []
    for eng in _engines(models, batching):
        closed = []
        eng.on_instance_closed = closed.append
        reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
        (iid, inst), = eng.instances.items()
        inst.run_step()
        strays = eng.retire(iid, strip_queue=strip_queue)
        assert iid in eng.instances and closed == []
        with pytest.raises(KeyError):
            eng.submit("f", arrivals[0][0])
        eng.pump(budget_s=120.0)
        assert closed == [iid] and iid not in eng.instances
        assert eng.store.refcount("f") == 0 and not eng.scheduler.pods
        if batching == "paged":
            assert inst.allocator.blocks_in_use == 0
        out.append(([r.req_id for r in strays],
                    [(r.done, r.tokens_out) for r in reqs]))
    assert out[0] == out[1]
    assert len(out[1][0]) == (2 if strip_queue else 0)


def test_retire_of_an_idle_instance_closes_at_once(models):
    for eng in _engines(models):
        closed = []
        eng.on_instance_closed = closed.append
        (iid,) = eng.instances
        assert eng.retire(iid) == [] and closed == [iid]
        assert not eng.instances and eng.store.refcount("f") == 0


@pytest.mark.parametrize("batching", ["continuous", "paged", "static"])
def test_fail_returns_reset_strays_and_empties_the_store(models, batching):
    """A node crash returns every unfinished request, occupants with
    their tokens reset, as JAX does; the store is empty, no callback
    fires, the node serves and deploys nothing more, and its health is
    0."""
    jm, jp, tm, tp = models
    arrivals = ([(np.arange(8, dtype=np.int32) + i, 6) for i in range(4)]
                if batching == "static" else _cohort(n=4, new=6))
    out = []
    for eng, (m, p, a) in zip(_engines(models, batching),
                              [(jm, jp, JaxAlloc(**FULL)),
                               (tm, tp, Alloc(**FULL))]):
        closed = []
        eng.on_instance_closed = closed.append
        reqs = [eng.submit("f", q, max_new_tokens=n) for q, n in arrivals]
        (inst,) = eng.instances.values()
        inst.run_step()
        inst.run_step()
        assert any(r.tokens_out for r in reqs)
        strays = eng.fail()
        assert strays and all(r.tokens_out == [] for _, r in strays)
        assert not eng.instances and not eng.scheduler.pods
        assert eng.store.used_bytes() == 0 and not eng.store.contains("f")
        assert closed == [] and not eng.alive and eng.health() == 0.0
        assert eng.pump(budget_s=1.0) == 0
        with pytest.raises(RuntimeError, match="failed node"):
            eng.deploy("g", m, p, a)
        out.append([(fn, r.req_id) for fn, r in strays])
    assert out[0] == out[1]


# -- deadlines, lanes, health -------------------------------------------------


def test_queued_requests_expire_past_their_deadline_but_guaranteed(models):
    """Queued requests past their deadline expire before taking a slot,
    with the typed outcome, no tokens and a recorder count, except the
    guaranteed tier; in-time requests are recorded as met (JAX's
    accounting, request for request)."""
    out = []
    for eng in _engines(models):
        now = eng.now()
        spec = [(None, "best_effort"), (now - 1.0, "best_effort"),
                (now - 1.0, "guaranteed"), (now - 1.0, "batch"),
                (now + 600.0, "best_effort")]
        reqs = [eng.submit("f", np.arange(5, dtype=np.int32) + i,
                           max_new_tokens=3, deadline=d, tier=t)
                for i, (d, t) in enumerate(spec)]
        done = eng.pump(budget_s=120.0)
        rec = eng.recorders["f"]
        (tel,) = eng.telemetry().values()
        out.append(([(r.done, r.outcome, r.tokens_out) for r in reqs], done,
                    tel["expired"], rec.expired, rec.deadline_met,
                    rec.deadline_missed))
    assert out[0] == out[1]
    outcomes = [o for _, o, _ in out[1][0]]
    assert outcomes == [None, "expired", None, "expired", None]
    assert out[1][1:] == (3, 2, 2, 2, 1)  # the guaranteed one is late


def test_enqueue_puts_the_batch_lane_last(models):
    """Non-batch requests queue ahead of parked batch-tier ones; one tier
    is plain FIFO (``test_chaos.py::test_live_batch_lane_ordering``)."""
    jeng, teng = _engines(models)
    tiers = ["batch", "best_effort", "batch", "guaranteed", "best_effort",
             "batch"]
    orders = []
    for eng in (jeng, teng):
        (inst,) = eng.instances.values()
        for i, t in enumerate(tiers):
            eng.submit("f", np.arange(4, dtype=np.int32) + i, tier=t,
                       attempts=i)
        orders.append([(r.req_id, r.tier, r.attempts) for r in inst.queue])
    assert orders[0] == orders[1]
    assert [i for i, _, _ in orders[1]] == [1, 3, 4, 0, 2, 5]
    lane = types.SimpleNamespace(queue=[])
    for i in range(3):
        ServingEngine.enqueue(lane, ServeRequest(
            req_id=i, prompt=np.zeros(2, np.int32), tier="best_effort"))
    assert [r.req_id for r in lane.queue] == [0, 1, 2]


def test_health_tracks_jax_over_the_same_pass_times():
    """The same pass latencies give the same health score, step for step:
    1.0 before any sample and while passes keep their baseline, falling
    when they slow down, recovering after."""
    times = [0.01] * 20 + [0.05] * 8 + [0.01] * 30
    jeng, teng = JaxEngine(window=0.1), ServingEngine(window=0.1,
                                                      device="cpu")
    assert jeng.health() == teng.health() == 1.0
    scores = []
    for t in times:
        for eng in (jeng, teng):
            eng._observe_pass(t)
        scores.append((jeng.health(), teng.health()))
    for j, t in scores:
        assert t == pytest.approx(j, abs=1e-12)
    assert min(t for _, t in scores) < 0.5 and scores[-1][1] > 0.9


def test_pump_delay_slows_passes_and_health_sees_it(models):
    """The injected per-pass stall lands in the timed region: every pass
    latency the health EWMAs (and ``Q_used``) see includes it, and health
    falls against a fast baseline."""
    _, teng = _engines(models)
    assert teng.idle_sleep_s > 0 and not teng.quarantined
    assert teng.pump_delay_s == 0.0
    seen, observe = [], teng._observe_pass
    teng._observe_pass = lambda e: (seen.append(e), observe(e))
    teng._lat_fast = teng._lat_slow = 0.001  # a 1 ms baseline
    teng.pump_delay_s = 0.05
    teng.submit("f", np.arange(6, dtype=np.int32), max_new_tokens=4)
    assert teng.pump(budget_s=120.0) == 1
    assert len(seen) == 3 and all(e >= 0.05 for e in seen)  # 3 passes
    assert teng.health() < 0.5


def test_first_token_at_is_set_on_every_path(models):
    """The instance records when its first token reached the host:
    fused, host-argmax and static."""
    for kw in ({}, {"fused": False}, {"batching": "static"}):
        _, teng = _engines(models, **kw)
        (inst,) = teng.instances.values()
        assert inst.first_token_at is None
        teng.submit("f", np.arange(6, dtype=np.int32), max_new_tokens=2)
        inst.dispatch_step()
        if inst.fused:
            assert inst.first_token_at is None  # lands at the sync
        inst.sync_step()
        assert inst.first_token_at is not None


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_exact_length_admission_without_buckets(models, batching):
    """``prefill_buckets=False``: the dense family admits at the exact
    prompt length, eagerly, with no prefill graphs, and emits the
    bucketed engine's and JAX's streams."""
    arrivals = [(np.random.default_rng(i).integers(0, 64, n, dtype=np.int32),
                 k) for i, (n, k) in enumerate([(5, 4), (11, 3), (3, 6),
                                                (17, 2), (9, 5)])]
    jeng, teng = _engines(models, batching, prefill_buckets=False)
    _, bucketed = _engines(models, batching)
    streams = []
    for eng in (jeng, teng, bucketed):
        reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
        assert eng.pump(budget_s=120.0) == len(reqs)
        streams.append([r.tokens_out for r in reqs])
    assert streams[0] == streams[1] == streams[2]
    (inst,) = teng.instances.values()
    assert not inst.bucketed and inst.prefill_graphs is None
    assert inst.prefills == len(arrivals)
    assert next(iter(bucketed.instances.values())).prefill_graphs is not None


# -- a closed instance is collected -------------------------------------------


@pytest.mark.parametrize("how", ["retire", "fail"])
@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_closed_instance_and_its_graphs_are_collected(models, how,
                                                      batching):
    """Once retired and drained (closed), or failed, the instance, its
    round graph, its prefill graphs and its KV pool die as soon as the
    caller drops them, with the cycle collector off: no reference cycle
    keeps device memory alive, and ``close`` drops the graphs and pools
    even while the instance is still held."""
    _, teng = _engines(models, batching)
    teng.submit("f", np.arange(6, dtype=np.int32), max_new_tokens=3)
    (iid, inst), = teng.instances.items()
    inst.run_step()
    refs = [weakref.ref(x) for x in (inst, inst.round_graph,
                                     inst.prefill_graphs, inst.cache["k"])]
    gc.collect()
    gc.disable()
    try:
        if how == "retire":
            teng.retire(iid)
            teng.pump(budget_s=60.0)
            assert iid not in teng.instances
        else:
            teng.fail()
        assert inst.cache is None and inst.round_graph is None
        assert inst.prefill_graphs is None and inst.params is None
        assert all(r() is None for r in refs[1:])
        del inst
        assert refs[0]() is None
    finally:
        gc.enable()
