"""The port's live fleet (``repro_torch.serving.ClusterFrontend`` under
``repro_torch.control``) against the JAX package's fleet and simulator:

* ``decision_signature`` of the torch live fleet equals JAX's simulator
  and JAX's live fleet in the scenarios of
  ``test_control_plane.py::test_sim_and_live_identical_decision_sequences``
  (a ramp), ``test_lifecycle.py`` (failure injection),
  ``test_cold_start_control.py`` (the fleet model store on) and
  ``test_chaos.py`` (a seeded fault schedule);
* greedy streams through the torch ``ClusterFrontend`` equal JAX's for
  the same placements and prompts: JSQ routing, ``evict`` mid-decode
  with zero dropped requests, ``fail_node`` re-injection, ``migrate``;
* ``measure_engine_profile`` returns JAX's grid and stamps;
* the options not ported yet raise ``NotImplementedError``.

Both packages serve the tiny config on the CPU; the streams compare f32
params (bf16 greedy streams are not portable, ROADMAP.md Queue 3).
Tolerance: identical decisions, streams, routing and counts.
"""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro import control as jctl
from repro.core import chaos as jchaos
from repro.core import cluster as jcluster
from repro.core import profiler as jprof
from repro.core.resources import Alloc as JaxAlloc
from repro.core.scaling import ProfilePoint as JaxPoint
from repro.core.workload import ServiceCurve as JaxCurve
from repro.models import build_model as jax_build
from repro.serving import ClusterFrontend as JaxFrontend
from repro.serving import FleetModelStore as JaxStore
from repro_torch import bridge
from repro_torch import control as tctl
from repro_torch.core import chaos as tchaos
from repro_torch.core import cluster as tcluster
from repro_torch.core import profiler as tprof
from repro_torch.core.resources import Alloc
from repro_torch.core.scaling import ProfilePoint
from repro_torch.core.workload import ServiceCurve
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ClusterFrontend, FleetModelStore

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    """The tiny config in both packages: bf16 JAX params, their bridge,
    and f32 copies of both (for token-exact streams)."""
    jcfg = tiny_config(name="tiny-fleet")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return dict(jm=jm, jp=jp, jp32=jp32, tm=tm,
                tp=bridge.to_torch(jax.device_get(jp)),
                tp32=bridge.to_torch(jax.device_get(jp32)))


# -- decision signatures -------------------------------------------------------

# (profile, ramp, ticks): test_control_plane.py keeps an SLO-infeasible
# decoy point; the lifecycle, cold-start and chaos tests share one ramp.
_CONTROL = (((0.25, 0.4, 2.0, 0.05), (0.45, 0.8, 5.0, 0.03),
             (0.1, 0.1, 3.0, 0.5)), [(0.0, 1.0), (2.0, 11.0), (5.0, 1.0)], 8)
_LIFECYCLE = (((0.25, 0.4, 2.0, 0.05), (0.45, 0.8, 5.0, 0.03)),
              [(0.0, 1.0), (2.0, 8.0), (6.0, 1.0)], 9)
SCENARIOS = {"ramp": _CONTROL, "failure": _LIFECYCLE,
             "cold_start": _LIFECYCLE, "chaos": _LIFECYCLE}


def _parity_schedule(ch):
    return ch.ChaosSchedule(seed=0, events=(
        ch.FaultEvent(at=1.0, kind="straggler", node=0, magnitude=3.0,
                      duration=4.0),
        ch.FaultEvent(at=3.0, kind="kill", node=0),
        ch.FaultEvent(at=4.0, kind="link", node=1, magnitude=2.0,
                      duration=2.0),
    ))


def _busiest(plane, backend) -> int:
    counts = Counter(backend.node_of(p) for p in plane.placed["chat"])
    return counts.most_common(1)[0][0]


def _run(scenario, pkg, live, models):
    """One scenario on one fleet; returns (signature, final instances)."""
    profile, steps, ticks = SCENARIOS[scenario]
    ctl, point_cls, curve_cls = {
        "torch": (tctl, ProfilePoint, ServiceCurve),
        "jax": (jctl, JaxPoint, JaxCurve)}[pkg]
    ch, cl = {"torch": (tchaos, tcluster), "jax": (jchaos, jcluster)}[pkg]
    if live:
        factory = ((lambda: (models["tm"], models["tp"])) if pkg == "torch"
                   else (lambda: (models["jm"], models["jp"])))
    else:
        factory = None
    extra = {"cold_start_s": 0.8} if scenario == "cold_start" else {}
    spec = ctl.FunctionSpec(
        name="chat", profile=tuple(point_cls(sm=s, quota=q, throughput=t,
                                             p99_latency=l)
                                   for s, q, t, l in profile),
        slo_latency=0.1, target_rps=ctl.ramp(steps), headroom=1.2,
        min_instances=1, max_instances=5, model_factory=factory,
        max_batch=2, max_len=32, framework_bytes=32 * 1024 * 1024,
        curve=curve_cls(name="chat", r_max=5.0, sm_sat=0.45, p=1.0,
                        weight_bytes=1 << 20, framework_bytes=32 << 20),
        **extra)
    if live:
        store_cls = FleetModelStore if pkg == "torch" else JaxStore
        kw = ({"model_store": store_cls()} if scenario == "cold_start"
              else {})
        if pkg == "torch":
            kw["device"] = "cpu"
        fleet = (ClusterFrontend if pkg == "torch" else JaxFrontend)(
            n_nodes=2, window=0.05, **kw)
        backend = ctl.LiveBackend(fleet)
        target = ch.LiveChaosTarget(fleet)
        fail = fleet.fail_node
    else:
        fleet = cl.Cluster(n_nodes=2, sharing=True)
        backend = ctl.SimBackend(fleet)
        target = ch.SimChaosTarget(fleet)
        fail = fleet.fail_node
    plane = ctl.ControlPlane(backend)
    plane.register(spec)
    inj = (ch.ChaosInjector(_parity_schedule(ch), target)
           if scenario == "chaos" else None)
    for tick in range(ticks):
        if inj is not None:
            inj.advance(float(tick))
        if scenario == "failure" and tick == 3:
            fail(_busiest(plane, backend))
        plane.reconcile(now=float(tick))
    if scenario == "cold_start" and live and pkg == "torch":
        tiers = [e.tier for e in fleet.cold_start_events()]
        assert tiers[0] == "cold" and set(tiers[1:]) <= {"device", "host",
                                                         "peer"}
    return ctl.decision_signature(plane.log), plane.instances("chat")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_live_fleet_signature_equals_jax_sim_and_jax_live(models, scenario):
    got = _run(scenario, "torch", True, models)
    assert got[0], "the scenario must scale"
    assert got == _run(scenario, "jax", False, models)
    assert got == _run(scenario, "jax", True, models)
    assert got == _run(scenario, "torch", False, models)


# -- greedy streams through the frontends -------------------------------------

ALLOCS = ((0.5, 0.8), (0.5, 0.8), (0.3, 0.4))


def _fleet(models, pkg, batching="continuous", n_nodes=2, allocs=ALLOCS):
    """A frontend of ``n_nodes`` with one function placed at ``allocs``
    (f32 params); returns the frontend and the placement handles."""
    if pkg == "torch":
        fe = ClusterFrontend(n_nodes=n_nodes, window=0.05, device="cpu")
        model, params, alloc_cls = models["tm"], models["tp32"], Alloc
    else:
        fe = JaxFrontend(n_nodes=n_nodes, window=0.05)
        model, params, alloc_cls = models["jm"], models["jp32"], JaxAlloc
    handles = [fe.place_instance("f", model, params,
                                 alloc_cls(sm=s, quota_request=q,
                                           quota_limit=q),
                                 max_batch=2, max_len=32, batching=batching,
                                 block_size=8)
               for s, q in allocs]
    return fe, handles


def _prompts(n=8, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, int(rng.integers(3, 14)), dtype=np.int32)
            for _ in range(n)]


def _where(fe, reqs):
    """(node, instance) queue that holds each request."""
    out = []
    for r in reqs:
        out.append(next((n, k) for n, eng in enumerate(fe.engines)
                        for k, inst in eng.instances.items()
                        if any(q is r for q in inst.queue)))
    return out


def _step_all(fe, n):
    """``n`` deterministic passes of every live instance (no wall clock)."""
    for _ in range(n):
        for eng in fe.engines:
            for inst in list(eng.instances.values()):
                if inst.has_work() and not inst.paused:
                    inst.run_step()


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_jsq_routing_and_streams_equal_jax(models, batching):
    out = {}
    for pkg in ("torch", "jax"):
        fe, handles = _fleet(models, pkg, batching)
        reqs = [fe.submit("f", p, max_new_tokens=5) for p in _prompts()]
        routed = _where(fe, reqs)
        fe.pump(budget_s=60.0)
        assert all(r.done and len(r.tokens_out) == 5 for r in reqs)
        out[pkg] = (handles, routed, [r.tokens_out for r in reqs],
                    fe.inflight("f"), [fe.mem_used(n) for n in (0, 1)])
    assert out["torch"][0] == out["jax"][0]  # same nodes and instance ids
    assert out["torch"][1:] == out["jax"][1:]


def _evict_run(models, pkg, batching):
    fe, handles = _fleet(models, pkg, batching)
    reqs = [fe.submit("f", p, max_new_tokens=6) for p in _prompts(10)]
    _step_all(fe, 2)  # slots mid-decode, queues non-empty
    fe.evict(handles[0])
    fe.pump(budget_s=60.0)
    assert all(r.done and len(r.tokens_out) == 6 for r in reqs), \
        "eviction dropped a request"
    return ([r.tokens_out for r in reqs], len(fe.placements),
            fe.pool.total_used_area(),
            sum(e.store.refcount("f") for e in fe.engines))


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_evict_mid_decode_drops_nothing_and_equals_jax(models, batching):
    got = _evict_run(models, "torch", batching)
    assert got == _evict_run(models, "jax", batching)
    assert got[1] == 2 and got[3] == 2


def _fail_run(models, pkg):
    fe, handles = _fleet(models, pkg)
    reqs = [fe.submit("f", p, max_new_tokens=6) for p in _prompts(10)]
    _step_all(fe, 1)
    victim = int(handles[0].split(":")[0])
    lost = fe.fail_node(victim)
    stray_nodes = sorted(n for n, _ in _where(
        fe, [r for r in reqs if not r.done and not r.tokens_out
             and any(r is q for e in fe.engines
                     for i in e.instances.values() for q in i.queue)]))
    fe.pump(budget_s=60.0)
    assert all(r.done and len(r.tokens_out) == 6 for r in reqs), \
        "a failure dropped a request"
    return ([r.tokens_out for r in reqs], lost, stray_nodes,
            [e.alive for e in fe.engines], len(fe.placements))


def test_fail_node_reinjects_and_streams_equal_jax(models):
    got = _fail_run(models, "torch")
    assert got == _fail_run(models, "jax")
    assert got[1] == 2 and got[3] == [False, True]


def _migrate_run(models, pkg, batching, migrate):
    fe, (handle,) = _fleet(models, pkg, batching, allocs=((0.5, 0.8),))
    reqs = [fe.submit("f", p, max_new_tokens=5) for p in _prompts(4)]
    _step_all(fe, 2)
    if migrate:
        model, params = ((models["tm"], models["tp32"]) if pkg == "torch"
                         else (models["jm"], models["jp32"]))
        new = fe.migrate("f", handle, model, params, 1)
        assert new is not None and new.startswith("1:")
        assert not fe.engines[0].instances and len(fe.placements) == 1
    fe.pump(budget_s=60.0)
    assert all(r.done for r in reqs)
    return [r.tokens_out for r in reqs]


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_migrate_streams_equal_unmigrated_and_jax(models, batching):
    moved = _migrate_run(models, "torch", batching, True)
    assert moved == _migrate_run(models, "torch", batching, False)
    assert moved == _migrate_run(models, "jax", batching, True)


def test_fleet_store_placements_serve_and_resolve_ttft(models):
    """Placements sourced through the fleet tier (cold, then a device
    hit on the warm node, then a peer copy) serve the direct deploy's
    streams, pin and release their host entries, and resolve TTFT."""
    store = FleetModelStore()
    fe = ClusterFrontend(n_nodes=2, window=0.05, device="cpu",
                         model_store=store)
    alloc = Alloc(sm=0.5, quota_request=0.8, quota_limit=0.8)
    handles = [fe.place_instance("f", models["tm"], models["tp32"], alloc,
                                 max_batch=2, max_len=32) for _ in range(3)]
    assert [h.split(":")[0] for h in handles] == ["0", "0", "1"]
    assert [e.tier for e in fe.cold_start_events()] == ["cold", "device",
                                                        "peer"]
    reqs = [fe.submit("f", p, max_new_tokens=5) for p in _prompts()]
    fe.pump(budget_s=60.0)
    ref, _ = _fleet(models, "torch")
    want = [ref.submit("f", p, max_new_tokens=5) for p in _prompts()]
    ref.pump(budget_s=60.0)
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in want]
    assert all(e.ttft_s is not None and e.ttft_s > 0
               for e in fe.cold_start_events())
    assert store.cache(0).pins("f") == 2 and store.cache(1).pins("f") == 1
    fe.evict(handles[2])
    assert store.cache(1).pins("f") == 0
    assert fe.fail_node(0) == 2 and store.warm_nodes("f") == [1]


# -- the FaST-Profiler ------------------------------------------------------------


def test_measure_engine_profile_grid_and_stamps_equal_jax(models,
                                                         monkeypatch):
    kw = dict(spatial=(0.25, 0.5), temporal=(0.4, 0.8), max_batch=2,
              max_len=32, batching="paged", prompt_len=6, new_tokens=3,
              window=0.05, n_windows=2, kv_budget_bytes=1 << 20,
              kv_block_bytes=models["tm"].kv_block_bytes(16),
              kv_shared_frac=0.25, sm_scale=lambda sm: min(sm / 0.45, 1.0))
    got = tprof.measure_engine_profile(models["tm"], models["tp32"],
                                       device="cpu", **kw)
    want = jprof.measure_engine_profile(models["jm"], models["jp32"], **kw)
    stamps = [(p.sm, p.quota, p.kv_blocks, p.kv_shared_frac, p.spec_k,
               p.acceptance, p.shards) for p in got]
    assert stamps == [(p.sm, p.quota, p.kv_blocks, p.kv_shared_frac,
                       p.spec_k, p.acceptance, p.shards) for p in want]
    assert all(p.throughput > 0 and p.p99_latency > 0 for p in got)
    # The window is widened from a timed step to hold STEPS_PER_WINDOW
    # steps at the lowest quota (one tiny step takes far more than 10 us).
    windows, trial = [], tprof.measure_callable_trial

    def spy(*args, window, **kwargs):
        windows.append(window)
        return trial(*args, window=window, **kwargs)

    monkeypatch.setattr(tprof, "measure_callable_trial", spy)
    sized = tprof.measure_engine_profile(
        models["tm"], models["tp32"], device="cpu", spatial=(0.5,),
        temporal=(0.4, 0.8), max_batch=2, max_len=32, prompt_len=6,
        new_tokens=3, window=1e-4, n_windows=1)
    assert len(windows) == 2 and windows[0] == windows[1] > 1e-4
    assert all(p.throughput > 0 for p in sized)


# -- options the port does not have yet ---------------------------------------


@pytest.mark.parametrize("option,item", [
    (dict(sampling=object()), "item 7"), (dict(speculate=object()), "item 7"),
    (dict(draft_params={}), "item 7"), (dict(shards=2), "item 11")])
def test_unported_options_raise(models, option, item):
    fe = ClusterFrontend(n_nodes=2, window=0.05, device="cpu")
    alloc = Alloc(sm=0.5, quota_request=0.5, quota_limit=0.5)
    with pytest.raises(NotImplementedError, match=item):
        fe.place_instance("f", models["tm"], models["tp"], alloc, **option)
    with pytest.raises(NotImplementedError, match=item):
        fe.deploy("f", models["tm"], models["tp"], alloc, **option)
    assert not fe.placements and fe.pool.total_used_area() == 0
    if "shards" not in option:
        with pytest.raises(NotImplementedError, match=item):
            tprof.measure_engine_profile(models["tm"], models["tp"],
                                         device="cpu", **option)


def test_unported_spec_axes_raise_through_the_live_backend(models):
    point = ProfilePoint(sm=0.5, quota=0.5, throughput=1.0)
    for kw, item in ((dict(shards=2), "item 11"),
                     (dict(speculate=type("S", (), {"k": 2})(),
                           draft_factory=lambda: {}), "item 7")):
        spec = tctl.FunctionSpec(
            name="f", profile=(point,),
            model_factory=lambda: (models["tm"], models["tp"]), **kw)
        plane = tctl.ControlPlane(tctl.LiveBackend(
            ClusterFrontend(n_nodes=1, device="cpu")))
        with pytest.raises(NotImplementedError, match=item):
            plane.register(spec)
    from repro_torch.serving.modelstore import (stage_params,
                                                upload_params)
    staged = stage_params(models["tm"], models["tp"])
    with pytest.raises(NotImplementedError, match="item 11"):
        upload_params(staged, device="cpu", shardings=[None])
    with pytest.raises(NotImplementedError, match="item 11"):
        FleetModelStore().acquire(0, "f", models["tm"], models["tp"],
                                  sharding_for=lambda n, s: None,
                                  device="cpu")
