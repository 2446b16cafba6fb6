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
* ``measure_engine_profile`` returns JAX's grid and stamps, the
  speculation axis (``spec_k``, the measured acceptance) included;
* ``place_instance``/``deploy`` take ``sampling``, ``speculate`` and
  ``draft_params`` (the draft stored under ``"{fn}#draft"`` and charged),
  and the speculating fleet's ``decision_signature`` equals JAX's;
* a sharded pod of the rwkv family places, deploys and registers
  through the live backend, and serves one device's streams.

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
from repro.serving.speculative import SpecConfig as JaxSpecConfig
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
from repro_torch.core.model_sharing import pytree_nbytes
from repro_torch.serving import ClusterFrontend, FleetModelStore
from repro_torch.serving.speculative import SamplingConfig, SpecConfig

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


# -- sampling and speculation through the fleet and the profiler ---------------


def _spec(models, k=2):
    return SpecConfig(draft_cfg=models["tm"].cfg, k=k)


@pytest.mark.parametrize("store", [False, True])
def test_place_and_deploy_accept_sampling_and_speculate(models, store):
    """``place_instance`` and ``deploy`` take ``sampling``, ``speculate``
    and ``draft_params``: the draft is stored under ``"{fn}#draft"`` on
    the node (through the fleet store's tiers when there is one), its
    bytes are charged with the function's, and the placed instances serve
    the bare engine's greedy speculative streams."""
    fleet_store = FleetModelStore() if store else None
    fe = ClusterFrontend(n_nodes=2, window=0.05, device="cpu",
                         model_store=fleet_store)
    alloc = Alloc(sm=0.5, quota_request=0.8, quota_limit=0.8)
    spec = _spec(models)
    handle = fe.place_instance("f", models["tm"], models["tp32"], alloc,
                               max_batch=2, max_len=32, speculate=spec,
                               draft_params=models["tp32"])
    more = fe.deploy("f", models["tm"], models["tp32"], alloc,
                     n_instances=2, max_batch=2, max_len=32, speculate=spec,
                     draft_params=models["tp32"])
    sampled = fe.place_instance("g", models["tm"], models["tp32"], alloc,
                                max_batch=2, max_len=32,
                                sampling=SamplingConfig(temperature=0.7,
                                                        seed=3))
    assert handle and len(more) == 2 and sampled
    nbytes = pytree_nbytes(models["tp32"])
    assert fe._fn_mm["f"].weight_bytes == 2 * nbytes
    assert fe._fn_mm["g"].weight_bytes == nbytes
    for n in fe.nodes_for("f"):
        eng = fe.engines[n]
        assert eng.store.contains("f#draft")
        insts = [i for k, i in eng.instances.items() if k.startswith("f/")]
        assert all(i.speculate == spec and i.draft_key == "f#draft"
                   for i in insts)
        assert eng.store.refcount("f#draft") == len(insts)
    if store:
        assert fleet_store.staged_nbytes("f#draft") is not None
    reqs = [fe.submit("f", p, max_new_tokens=5) for p in _prompts()]
    fe.pump(budget_s=60.0)
    ref, _ = _fleet(models, "torch")
    want = [ref.submit("f", p, max_new_tokens=5) for p in _prompts()]
    ref.pump(budget_s=60.0)
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in want]
    tele = [t for e in fe.engines for k, t in e.telemetry().items()
            if k.startswith("f/")]
    assert sum(t["spec_proposed"] for t in tele) > 0
    assert all(t["spec_accepted"] == t["spec_proposed"] for t in tele)
    # Closing every speculating instance releases the draft's pins too.
    for h in [handle, *more]:
        fe.evict(h)
    fe.pump(budget_s=10.0)
    assert "f" not in fe._fn_draft and not fe.nodes_for("f")
    if store:
        assert all(fleet_store.cache(n).pins("f#draft") == 0
                   for n in (0, 1))


def test_speculating_placement_needs_draft_weights(models):
    fe = ClusterFrontend(n_nodes=1, window=0.05, device="cpu")
    alloc = Alloc(sm=0.5, quota_request=0.8, quota_limit=0.8)
    with pytest.raises(ValueError, match="no draft"):
        fe.place_instance("f", models["tm"], models["tp32"], alloc,
                          speculate=_spec(models))
    assert not fe.placements and fe.pool.total_used_area() == 0


def test_sampled_instance_migrates_with_its_sampling(models):
    """A migrated sampling instance keeps sampling on the target (its
    key stream starts again from the seed there: the key does not
    travel); JAX's ``migrate`` deploys the target without ``sampling``
    (ROADMAP.md, Queue 3)."""
    fe = ClusterFrontend(n_nodes=2, window=0.05, device="cpu")
    alloc = Alloc(sm=0.5, quota_request=0.8, quota_limit=0.8)
    sampling = SamplingConfig(temperature=0.8, top_k=8, seed=4)
    handle = fe.place_instance("f", models["tm"], models["tp32"], alloc,
                               max_batch=2, max_len=32, sampling=sampling)
    reqs = [fe.submit("f", p, max_new_tokens=6) for p in _prompts(2)]
    _step_all(fe, 2)
    new = fe.migrate("f", handle, models["tm"], models["tp32"], 1)
    (inst,) = fe.engines[1].instances.values()
    assert new is not None and inst.sampling == sampling
    fe.pump(budget_s=30.0)
    assert all(r.done and len(r.tokens_out) == 6 for r in reqs)


def test_speculating_instance_does_not_migrate(models):
    fe = ClusterFrontend(n_nodes=2, window=0.05, device="cpu")
    alloc = Alloc(sm=0.5, quota_request=0.8, quota_limit=0.8)
    handle = fe.place_instance("f", models["tm"], models["tp32"], alloc,
                               max_batch=2, max_len=32,
                               speculate=_spec(models),
                               draft_params=models["tp32"])
    fe.submit("f", _prompts(1)[0], max_new_tokens=8)
    _step_all(fe, 1)
    assert fe.migrate("f", handle, models["tm"], models["tp32"], 1) is None
    assert fe.alive(handle)


def test_measure_engine_profile_stamps_speculation_as_jax(models):
    """The profiler takes ``sampling``, ``speculate`` and
    ``draft_params``: every point carries ``spec_k`` and the instance's
    measured acceptance (1.0 with draft == target, as JAX's)."""
    kw = dict(spatial=(0.5,), temporal=(0.4, 0.8), max_batch=2, max_len=32,
              prompt_len=6, new_tokens=4, window=0.05, n_windows=1)
    got = tprof.measure_engine_profile(
        models["tm"], models["tp32"], device="cpu", speculate=_spec(models),
        draft_params=models["tp32"], **kw)
    want = jprof.measure_engine_profile(
        models["jm"], models["jp32"],
        speculate=JaxSpecConfig(draft_cfg=models["jm"].cfg, k=2),
        draft_params=models["jp32"], **kw)
    assert [(p.sm, p.quota, p.spec_k, p.acceptance) for p in got] == \
        [(p.sm, p.quota, p.spec_k, p.acceptance) for p in want]
    assert got[0].spec_k == 2 and got[0].acceptance == 1.0
    sampled = tprof.measure_engine_profile(
        models["tm"], models["tp32"], device="cpu",
        sampling=SamplingConfig(temperature=0.8, top_k=8, seed=1), **kw)
    assert all(p.throughput > 0 and p.spec_k == 0 for p in sampled)
    with pytest.raises(ValueError, match="draft_params"):
        tprof.measure_engine_profile(models["tm"], models["tp32"],
                                     device="cpu", speculate=_spec(models),
                                     **kw)


def test_sim_live_decision_signature_with_speculate(models):
    """``test_speculative_decoding.py::test_sim_live_decision_signature_
    with_speculate`` on the torch live fleet: its decisions equal JAX's
    simulator's and JAX's live fleet's on the same speculating spec, and
    the torch fleet then serves through the speculative round."""
    def plane(pkg, live):
        ctl, point, curve_cls, spec_cls, cfg = {
            "torch": (tctl, ProfilePoint, ServiceCurve, SpecConfig,
                      models["tm"].cfg),
            "jax": (jctl, JaxPoint, JaxCurve, JaxSpecConfig,
                    models["jm"].cfg)}[pkg]
        model, params = ((models["tm"], models["tp32"]) if pkg == "torch"
                         else (models["jm"], models["jp32"]))
        profile = (point(sm=0.25, quota=0.4, throughput=2.0,
                         p99_latency=0.05, spec_k=4, acceptance=0.8),
                   point(sm=0.45, quota=0.8, throughput=5.0,
                         p99_latency=0.03, spec_k=4, acceptance=0.8))
        spec = ctl.FunctionSpec(
            name="chat", profile=profile, slo_latency=0.1,
            target_rps=ctl.ramp([(0.0, 1.0), (2.0, 11.0), (5.0, 1.0)]),
            headroom=1.2, min_instances=1, max_instances=5,
            model_factory=(lambda: (model, params)) if live else None,
            max_batch=2, max_len=32, framework_bytes=32 * 1024 * 1024,
            curve=curve_cls(name="chat", r_max=5.0, sm_sat=0.45, p=1.0,
                            weight_bytes=1 << 20, framework_bytes=32 << 20),
            speculate=spec_cls(draft_cfg=cfg, k=4),
            draft_factory=lambda: params)
        if live:
            kw = {"device": "cpu"} if pkg == "torch" else {}
            fleet = (ClusterFrontend if pkg == "torch" else JaxFrontend)(
                n_nodes=2, window=0.1, **kw)
            backend = ctl.LiveBackend(fleet)
        else:
            fleet = (tcluster if pkg == "torch" else jcluster).Cluster(
                n_nodes=2, sharing=True)
            backend = ctl.SimBackend(fleet)
        cp = ctl.ControlPlane(backend)
        cp.register(spec)
        for tick in range(8):
            cp.reconcile(now=float(tick))
        return ctl.decision_signature(cp.log), fleet

    got, fe = plane("torch", True)
    assert got and got == plane("jax", False)[0] == plane("jax", True)[0]
    rng = np.random.default_rng(0)
    reqs = [fe.submit("chat", rng.integers(0, 64, 6, dtype=np.int32),
                      max_new_tokens=4) for _ in range(3)]
    fe.pump(budget_s=60.0)
    assert all(r.done for r in reqs)
    tele = [t for e in fe.engines for t in e.telemetry().values()]
    assert sum(t["spec_proposed"] for t in tele) > 0


# -- sharded pods of the rwkv family -------------------------------------------


def _rwkv():
    """rwkv6's reduced cut and its params, in f32 (a pod's streams are one
    device's in f32)."""
    from repro_torch.configs import get_config
    from repro_torch.training.tree import tree_map

    model = build_model(get_config("rwkv6-1.6b", reduced=True))
    return model, tree_map(lambda t: t.float(),
                           model.init(torch.Generator().manual_seed(0)))


def _served(fe, fn="f"):
    """Serve three prompts through ``fe``: the streams."""
    rng = np.random.default_rng(0)
    reqs = [fe.submit(fn, rng.integers(0, 200, 6, dtype=np.int32),
                      max_new_tokens=4) for _ in range(3)]
    fe.pump(budget_s=60.0)
    assert all(r.done for r in reqs)
    return [list(r.tokens_out) for r in reqs]


@pytest.mark.parametrize("option", [dict(shards=2)])
def test_sharded_rwkv_places_and_deploys(option):
    """A sharded pod of the rwkv family places and deploys: one rectangle
    on each member node, and the streams of one device."""
    model, params = _rwkv()
    alloc = Alloc(sm=0.5, quota_request=0.5, quota_limit=0.5)
    fe = ClusterFrontend(n_nodes=2, window=0.05, device="cpu")
    fe.place_instance("f", model, params, alloc)
    one = _served(fe)
    for place in ("place_instance", "deploy"):
        fe = ClusterFrontend(n_nodes=2, window=0.05, device="cpu")
        assert getattr(fe, place)("f", model, params, alloc, **option)
        [p] = fe.placements
        assert p.member_nodes == (0, 1)
        assert [len(n.placements) for n in fe.pool.nodes] == [1, 1]
        assert _served(fe) == one


def test_sharded_spec_serves_through_the_live_backend(models):
    """A ``shards=2`` spec of an rwkv function registers through the live
    backend, which places it as a pod on both nodes, and serves one
    device's streams; a sharded upload whose shardings do not align with
    the staged leaves raises before any copy."""
    point = ProfilePoint(sm=0.5, quota=0.5, throughput=1.0)
    fe = ClusterFrontend(n_nodes=2, device="cpu")
    tctl.ControlPlane(tctl.LiveBackend(fe)).register(tctl.FunctionSpec(
        name="f", profile=(point,), model_factory=_rwkv))
    one = _served(fe)
    spec = tctl.FunctionSpec(
        name="f", profile=(point,), shards=2, model_factory=_rwkv)
    fe = ClusterFrontend(n_nodes=2, device="cpu")
    plane = tctl.ControlPlane(tctl.LiveBackend(fe))
    plane.register(spec)
    [p] = fe.placements
    assert p.member_nodes == (0, 1)
    assert _served(fe) == one
    from repro_torch.serving.modelstore import (stage_params,
                                                upload_params)
    staged = stage_params(models["tm"], models["tp"])
    with pytest.raises(ValueError, match="align"):
        upload_params(staged, device="cpu", shardings=[None])
