"""Sharded pods in the port (``repro_torch.distributed``, the engine's
``group=``, ``ClusterFrontend(shards > 1)``) against the JAX package's
(``tests/test_sharded_pods.py``), on the CPU: a port ``TPGroup`` of
``["cpu"] * n`` stands in for n members, JAX runs on the four forced host
devices, and the kernels run their plain versions.

* greedy streams of the tiny config in f32 at 2 and 4 members,
  continuous and paged, equal JAX's pods and the port's ``shards=1``;
  sampled streams equal the port's ``shards=1`` (the two packages' key
  streams differ, ROADMAP.md conventions);
* a prefill's and a round's logits equal JAX's under a 2-device mesh
  within 2e-5 (tests/test_kernels.py:23-25, f32);
* each member's weight and KV bytes equal JAX's ``per_device_bytes``;
* placement, admission, eviction, failure, the refusals and the live
  fleet's decisions as in JAX; ``shards=1`` builds no group;
* starcoder2's reduced cut with its biases filled; the fleet store's
  sharded upload; the sequence-sharded paged decode against JAX's;
  the options and families a pod does not serve yet raise naming
  ROADMAP.md Queue 1 item 11b.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro.control import ControlPlane as JaxPlane
from repro.control import FunctionSpec as JaxSpec
from repro.control import LiveBackend as JaxLive
from repro.control import SimBackend as JaxSim
from repro.control import decision_signature as jax_signature
from repro.control import ramp as jax_ramp
from repro.core.cluster import Cluster as JaxCluster
from repro.core.links import NetworkLinks as JaxLinks
from repro.core.resources import Alloc as JaxAlloc
from repro.core.scaling import ProfilePoint as JaxPoint
from repro.core.workload import ServiceCurve as JaxCurve
from repro.distributed import seqshard as jseq
from repro.distributed.sharding import serve_pspec as jax_serve_pspec
from repro.distributed.sharding import shard_put as jax_shard_put
from repro.distributed.sharding import tp_mesh, use_mesh
from repro.kernels import ops as jops
from repro.models import build_model as jax_build
from repro.serving import ClusterFrontend as JaxFrontend
from repro.serving.engine import per_device_bytes
from repro_torch import bridge
from repro_torch import control as tctl
from repro_torch.configs import get_config
from repro_torch.core.links import NetworkLinks
from repro_torch.core.model_sharing import SERVER_CONTEXT_OVERHEAD
from repro_torch.core.resources import Alloc
from repro_torch.core.scaling import ProfilePoint
from repro_torch.core.workload import ServiceCurve
from repro_torch.distributed import (TPGroup, per_member_bytes,
                                     serve_pspec, shard_put, tp_group)
from repro_torch.distributed.seqshard import paged_decode_attention_seqshard
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import PodModel
from repro_torch.serving import ClusterFrontend, FleetModelStore
from repro_torch.serving.modelstore import stage_params, upload_params
from repro_torch.serving.speculative import SamplingConfig, SpecConfig

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (forced host) devices")

torch.set_num_threads(2)
TOL = 2e-5  # f32, tests/test_kernels.py:23-25
ALLOC = Alloc(sm=0.25, quota_request=0.25, quota_limit=0.5)
JAX_ALLOC = JaxAlloc(sm=0.25, quota_request=0.25, quota_limit=0.5)
PROMPTS = [np.array([3, 1, 4, 1, 5], dtype=np.int32),
           np.array([9, 2, 6, 5, 3, 5, 8, 9, 7], dtype=np.int32),
           np.array([2, 7, 1], dtype=np.int32)]
SAMPLING = SamplingConfig(temperature=0.8, top_k=8, seed=7)


@pytest.fixture(scope="module")
def models():
    """The tiny config in both packages with f32 params (column-only TP
    is exact; f32 keeps near-tie argmaxes stable, the documented recipe),
    the port's bridged from JAX's."""
    jcfg = tiny_config(name="tiny-pods")
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(0)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return dict(jm=jm, jp=jp, tm=tm, tp=bridge.to_torch(jax.device_get(jp)))


def serve(model, params, shards, *, pkg="torch", links=None, n_nodes=4,
          batching="continuous", sampling=None, max_new=6, **kw):
    """Place one instance of ``shards`` members, serve PROMPTS; returns
    (frontend, streams)."""
    if pkg == "torch":
        fe = ClusterFrontend(n_nodes=n_nodes, links=links, device="cpu",
                             **kw)
        alloc = ALLOC
    else:
        fe = JaxFrontend(n_nodes=n_nodes, links=links, **kw)
        alloc = JAX_ALLOC
    h = fe.place_instance("f", model, params, alloc, max_batch=4,
                          max_len=32, batching=batching, sampling=sampling,
                          shards=shards)
    assert h is not None, f"placement failed for shards={shards}"
    reqs = [fe.submit("f", p, max_new_tokens=max_new) for p in PROMPTS]
    fe.pump(budget_s=60.0)
    assert all(r.done for r in reqs)
    return fe, [list(r.tokens_out) for r in reqs]


def instance(fe):
    [p] = fe.placements
    return p, fe.engines[p.node].instances[p.inst_id]


@pytest.fixture(scope="module")
def reference(models):
    """The port's one-device streams, greedy and sampled, per batching."""
    return {(b, s is not None): serve(models["tm"], models["tp"], 1,
                                      batching=b, sampling=s)[1]
            for b in ("continuous", "paged") for s in (None, SAMPLING)}


# -- streams ------------------------------------------------------------------


@pytest.mark.parametrize("batching", ["continuous", "paged"])
@pytest.mark.parametrize("shards", [2, 4])
def test_greedy_streams_equal_jax_pods_and_one_device(models, reference,
                                                      batching, shards):
    fe, toks = serve(models["tm"], models["tp"], shards, batching=batching)
    _, jax_toks = serve(models["jm"], models["jp"], shards, pkg="jax",
                        batching=batching)
    assert toks == jax_toks == reference[(batching, False)]
    p, inst = instance(fe)
    assert len(set(p.member_nodes)) == shards
    assert inst.group.nodes == p.member_nodes
    assert set(inst.hbm_bytes_by_member()) == set(p.member_nodes)


@pytest.mark.parametrize("batching", ["continuous", "paged"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sampled_streams_equal_one_device(models, reference, batching,
                                          shards):
    _, toks = serve(models["tm"], models["tp"], shards, batching=batching,
                    sampling=SAMPLING)
    ref = reference[(batching, True)]
    assert toks == ref
    assert len(set(map(tuple, ref))) > 1  # really stochastic output


def test_logits_equal_jax_under_a_mesh(models):
    """A prefill's and two rounds' logits of a 2-member pod equal JAX's
    model under a 2-device serving mesh within 2e-5.  JAX's prefill
    returns its cache in the params' dtype; its engine merges it into the
    bf16 pool, as the port's prefill writes it, so the rounds here read
    it cast to bf16."""
    jm, tm = models["jm"], models["tm"]
    mesh = tp_mesh(2, devices=jax.devices()[:2])
    jparams = jax_shard_put(models["jp"], jm.param_names(), mesh,
                            resolver=jax_serve_pspec)
    group = tp_group(2, devices=["cpu", "cpu"])
    members = shard_put(models["tp"], tm.param_names(), group, serve_pspec)
    pod = PodModel(tm, group, False)
    tokens = np.array([[5, 9, 2, 7, 1, 3, 8]], np.int32)
    with use_mesh(mesh):
        jl, jcache = jm.prefill(jparams, jnp.asarray(tokens), max_len=16)
        jcache = {k: v if k == "pos" else v.astype(jnp.bfloat16)
                  for k, v in jcache.items()}
        steps = [jl]
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        for _ in range(2):
            jl, jcache = jm.decode_step(jparams, tok, jcache)
            steps.append(jl)
            tok = jnp.argmax(jl, -1).astype(jnp.int32)
    tl, caches = pod.prefill(members, torch.as_tensor(tokens), max_len=16)
    got = [tl]
    tok = torch.argmax(tl, -1).to(torch.int32)
    for _ in range(2):
        tl, caches = pod.decode_step(members, tok, caches)
        got.append(tl)
        tok = torch.argmax(tl, -1).to(torch.int32)
    for a, b in zip(got, steps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


# -- bytes --------------------------------------------------------------------


@pytest.mark.parametrize("batching", ["continuous", "paged"])
@pytest.mark.parametrize("shards", [2, 4])
def test_member_bytes_equal_jax_per_device_bytes(models, batching, shards):
    """Each member's weight bytes equal JAX's ``per_device_bytes`` of the
    pod's params, and its k/v pool bytes JAX's of the pool its engine
    places (``_init_cache``; the port's paged pool holds one sink block
    more, whose share is taken off); every member holds less than the
    one-device footprint.  (Where the kv heads do not divide the group,
    JAX's pool is placed replicated, but the jitted round's output may
    take another layout that XLA picks: at 4 members the tiny config's
    pool comes back split 2 ways by kv head and replicated 2 ways.  The
    port keeps the placement.)"""
    fe, _ = serve(models["tm"], models["tp"], shards, batching=batching)
    jfe, _ = serve(models["jm"], models["jp"], shards, pkg="jax",
                   batching=batching)
    p, inst = instance(fe)
    jp, jinst = instance(jfe)
    assert p.member_nodes == jp.member_nodes
    assert per_member_bytes(inst.group, inst.params) == \
        per_device_bytes(jinst.params)
    kv = per_member_bytes(inst.group, inst.cache)
    jkv = per_device_bytes(jinst._init_cache())
    if batching == "paged":
        sink = {n: b // (inst.allocator.n_blocks + 1) for n, b in kv.items()}
        kv = {n: b - sink[n] for n, b in kv.items()}
    assert kv == jkv
    one, one_inst = instance(serve(models["tm"], models["tp"], 1,
                                   batching=batching)[0])
    whole = sum(one_inst.hbm_bytes_by_member().values())
    by_member = inst.hbm_bytes_by_member()
    assert all(b < whole for b in by_member.values())
    group = inst.group
    wk = [m["layers"]["attn"]["wk"].shape for m in inst.params]
    k = [c["k"].shape for c in inst.cache]
    kv_dim = models["tm"].cfg.kv_dim
    assert all(s[-1] == kv_dim // shards for s in wk)  # mid-head at 4
    heads = models["tm"].cfg.n_kv_heads
    assert all(s[-2] == (heads // shards if heads % shards == 0 else heads)
               for s in k)
    assert group.one_device and not inst.round_graph.always_eager


# -- placement, admission and the lifecycle -----------------------------------


def test_kv_overflow_admits_only_as_sharded_pod(models):
    tm, params = models["tm"], models["tp"]
    kv = tm.kv_cache_bytes(batching="continuous", max_batch=4, max_len=32)
    weights = sum(t.numel() * t.element_size()
                  for t in jax.tree_util.tree_leaves(params))
    mem = weights + SERVER_CONTEXT_OVERHEAD + (3 * kv) // 4

    def frontend():
        return ClusterFrontend(n_nodes=4, mem_bytes=mem, device="cpu")

    assert frontend().place_instance(
        "f", tm, params, ALLOC, max_batch=4, max_len=32,
        framework_bytes=0) is None
    fe = frontend()
    assert fe.place_instance("f", tm, params, ALLOC, max_batch=4,
                             max_len=32, framework_bytes=0,
                             shards=2) is not None
    req = fe.submit("f", PROMPTS[0], max_new_tokens=4)
    fe.pump(budget_s=60.0)
    assert req.done and len(req.tokens_out) == 4


def test_placement_picks_highest_bandwidth_group(models, reference):
    links = NetworkLinks(4, default_bps=1e9)
    links.set_link(2, 3, 64e9)
    fe, toks = serve(models["tm"], models["tp"], 2, links=links)
    assert fe.placements[0].member_nodes == (2, 3)
    assert toks == reference[("continuous", False)]


def test_evict_releases_every_member_rectangle(models):
    fe, _ = serve(models["tm"], models["tp"], 2)
    [p] = fe.placements
    fe.evict(f"{p.node}:{p.inst_id}")
    fe.pump(budget_s=10.0)
    assert not fe.placements
    assert all(abs(v) < 1e-9 for v in fe.node_load().values())
    assert not fe.engines[p.node].instances


def test_secondary_failure_folds_pod_and_heals(models, reference):
    fe, _ = serve(models["tm"], models["tp"], 2)
    [p] = fe.placements
    primary, secondary = p.member_nodes
    stranded = fe.submit("f", PROMPTS[0], max_new_tokens=6)
    assert fe.fail_node(secondary) == 1
    assert not fe.placements
    assert p.inst_id not in fe.engines[primary].instances
    assert not fe.alive(f"{primary}:{p.inst_id}")
    # The stranded request parked; a replacement drains it with the
    # reference tokens.
    assert fe.place_instance("f", models["tm"], models["tp"], ALLOC,
                             max_batch=4, max_len=32) is not None
    fe.pump(budget_s=60.0)
    assert stranded.done
    assert list(stranded.tokens_out) == reference[("continuous", False)][0]


def test_primary_failure_releases_surviving_rectangles(models):
    fe, _ = serve(models["tm"], models["tp"], 2)
    [p] = fe.placements
    fe.fail_node(p.member_nodes[0])
    assert not fe.placements
    assert all(abs(v) < 1e-9 for v in fe.node_load().values())
    assert fe.place_instance("f", models["tm"], models["tp"], ALLOC,
                             max_batch=4, max_len=32, shards=2) is not None


def test_quarantined_member_reads_the_pod_dead(models):
    fe, _ = serve(models["tm"], models["tp"], 2)
    [p] = fe.placements
    handle = f"{p.node}:{p.inst_id}"
    assert fe.alive(handle)
    assert fe.quarantine(p.member_nodes[1]) == 1
    assert not fe.alive(handle)


def test_sharded_pod_refuses_speculation_and_migration(models):
    fe = ClusterFrontend(n_nodes=4, device="cpu")
    with pytest.raises(ValueError, match="speculate"):
        fe.place_instance("f", models["tm"], models["tp"], ALLOC,
                          speculate=SpecConfig(draft_cfg=models["tm"].cfg,
                                               k=2),
                          draft_params=models["tp"], shards=2)
    assert not fe.placements and fe.pool.total_used_area() == 0
    fe, _ = serve(models["tm"], models["tp"], 2)
    p, inst = instance(fe)
    spare = next(n for n in range(4) if n not in p.member_nodes)
    assert fe.migrate("f", f"{p.node}:{p.inst_id}", models["tm"],
                      models["tp"], spare) is None
    with pytest.raises(ValueError, match="export"):
        inst.export_slot(0)


def test_shards1_adds_no_group_graph_or_store_entry(models):
    """A ``shards=1`` placement is the one-device path: no group, the
    model itself as the runner, graphs that may capture, and the intact
    tree under ``"f"``; a pod beside it stores its members under
    ``"{fn}@tp2"`` and leaves that tree as it was."""
    fe, _ = serve(models["tm"], models["tp"], 1)
    p, inst = instance(fe)
    assert inst.group is None and inst.runner is models["tm"]
    assert not inst.round_graph.always_eager
    assert not inst.prefill_graphs.always_eager
    assert inst.weights_key == "f" and p.member_nodes == ()
    keys = lambda: {k for e in fe.engines for k in e.store._entries}
    assert keys() == {"f"}
    tree = inst.params
    assert fe.place_instance("g", models["tm"], models["tp"], ALLOC,
                             max_batch=4, max_len=32,
                             shards=2) is not None
    assert keys() == {"f", "g@tp2"} and inst.params is tree


def test_weights_key_names_member_devices(models):
    """Two pods of one function on one primary share member trees only
    when their members lie on the same devices: the key is JAX's
    ``"{fn}@tp{n}"`` on one device and names the member devices when they
    span devices.  Through the frontend, pods on nodes (0, 1) and then
    (0, 2) of one device share node 0's one entry."""
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    keys = [TPGroup(devs, nodes).weights_key("f") for devs, nodes in [
        ((d0, d0), (0, 1)), ((d0, d1), (0, 1)), ((d0, d0), (0, 2)),
        ((d0, d1, d1, d0), (0, 1, 2, 3)), ((d0, d0, d1, d1), (0, 1, 2, 3))]]
    assert keys == ["f@tp2", "f@tp2:cuda:0,cuda:1", "f@tp2",
                    "f@tp4:cuda:0,cuda:1,cuda:1,cuda:0",
                    "f@tp4:cuda:0,cuda:0,cuda:1,cuda:1"]
    links = NetworkLinks(4, default_bps=8e9)
    links.set_link(0, 1, 64e9)
    fe = ClusterFrontend(n_nodes=4, links=links, device="cpu")
    place = lambda: fe.place_instance("f", models["tm"], models["tp"],
                                      ALLOC, max_batch=4, max_len=32,
                                      shards=2)
    assert place() is not None
    links.set_link(0, 1, 1e9)
    links.set_link(0, 2, 64e9)
    assert place() is not None
    assert [p.member_nodes for p in fe.placements] == [(0, 1), (0, 2)]
    a, b = (fe.engines[0].instances[p.inst_id] for p in fe.placements)
    assert a.weights_key == b.weights_key == "f@tp2" and a.params is b.params
    assert set(fe.engines[0].store._entries) == {"f@tp2"}


def test_live_signature_equals_jax_sim_and_live_with_shards_and_links(
        models):
    def run(pkg, live):
        ctl = tctl if pkg == "torch" else None
        point = ProfilePoint if pkg == "torch" else JaxPoint
        curve = ServiceCurve if pkg == "torch" else JaxCurve
        profile = (point(sm=0.2, quota=0.3, throughput=2.0,
                         p99_latency=0.05),
                   point(sm=0.4, quota=0.6, throughput=5.0,
                         p99_latency=0.03))
        cv = curve(name="f", r_max=5.0, sm_sat=0.4, p=1.0,
                   weight_bytes=1 << 20, framework_bytes=32 << 20,
                   allreduce_bytes=1 << 16)
        ramp = tctl.ramp if pkg == "torch" else jax_ramp
        demand = ramp([(0.0, 2.0), (2.0, 9.0), (6.0, 2.0)])
        links = (NetworkLinks if pkg == "torch" else JaxLinks)(
            4, default_bps=8e9)
        links.set_link(0, 1, 64e9)
        model, params = ((models["tm"], models["tp"]) if pkg == "torch"
                         else (models["jm"], models["jp"]))
        spec = (ctl.FunctionSpec if ctl else JaxSpec)(
            name="f", profile=profile, slo_latency=0.1, target_rps=demand,
            min_instances=1, max_instances=4,
            model_factory=(lambda: (model, params)) if live else None,
            max_batch=2, max_len=32, framework_bytes=32 << 20, shards=2,
            curve=cv)
        if live:
            fleet = (ClusterFrontend(n_nodes=4, window=0.05, links=links,
                                     device="cpu") if ctl else
                     JaxFrontend(n_nodes=4, window=0.05, links=links))
            backend = (ctl.LiveBackend if ctl else JaxLive)(fleet)
        else:
            fleet = JaxCluster(n_nodes=4, sharing=True, links=links)
            backend = JaxSim(fleet)
        plane = (ctl.ControlPlane if ctl else JaxPlane)(backend)
        plane.register(spec)
        for tick in range(9):
            plane.reconcile(now=float(tick))
        sig = (ctl.decision_signature if ctl else jax_signature)(plane.log)
        return sig, plane, fleet

    got, plane, fe = run("torch", True)
    want, jplane, cluster = run("jax", False)
    assert got and got == want == run("jax", True)[0]
    assert plane.instances("f") == jplane.instances("f")
    assert fe.placements[0].member_nodes == (0, 1)
    assert plane.backend.links() == jplane.backend.links()


# -- the fleet store's sharded upload -----------------------------------------


@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_sharded_upload_equals_shard_put(models, mode):
    tm, params = models["tm"], models["tp"]
    group = tp_group(4, devices=["cpu"] * 4)
    staged = stage_params(tm, params)
    names = [n for _, n in sorted(_flat(tm.param_names()).items())]
    shapes = [((len(leaf),) + leaf[0].shape) if st else leaf.shape
              for leaf, st in zip(staged.leaves, staged.stacked)]
    from repro_torch.distributed import Sharding
    shardings = [Sharding(group, serve_pspec(n, s, group.axis_sizes))
                 for n, s in zip(names, shapes)]
    got, ready = upload_params(staged, mode=mode, device="cpu",
                               shardings=shardings)
    want = shard_put(params, tm.param_names(), group, serve_pspec)
    assert ready is None and len(got) == 4
    for g, w in zip(got, want):
        for key, leaf in _flat(w).items():
            assert torch.equal(_flat(g)[key], leaf), key


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_fleet_store_places_a_pod_from_one_staged_tree(models, reference):
    store = FleetModelStore()
    fe = ClusterFrontend(n_nodes=4, model_store=store, device="cpu")
    assert fe.place_instance("f", models["tm"], models["tp"], ALLOC,
                             max_batch=4, max_len=32, shards=2) is not None
    reqs = [fe.submit("f", p, max_new_tokens=6) for p in PROMPTS]
    fe.pump(budget_s=60.0)
    assert [r.tokens_out for r in reqs] == reference[("continuous", False)]
    p, inst = instance(fe)
    assert store.warm_nodes("f") == [p.node]  # staged whole, under "f"
    assert inst.weights_key == "f@tp2"
    [event] = fe.cold_start_events()
    assert event.tier == "cold" and event.ttft_s is not None
    fe.evict(f"{p.node}:{p.inst_id}")
    fe.pump(budget_s=10.0)
    assert store.cache(p.node).pins("f") == 0


# -- starcoder2's biases ------------------------------------------------------


def test_starcoder2_reduced_biases_shard(reference):
    """starcoder2-15b's reduced cut, its column-sharded ``b_up`` and qkv
    biases filled, serves the ``shards=1`` streams at 2 members, f32."""
    cfg = get_config("starcoder2-15b", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for lp in (params["layers"]["attn"], params["layers"]["mlp"]):
        for key in [k for k in lp if k.startswith("b")]:
            lp[key].copy_(torch.randn(lp[key].shape, generator=gen) * 0.1)
    params = jax.tree_util.tree_map(lambda t: t.float(), params)
    one = serve(model, params, 1, batching="paged")[1]
    fe, two = serve(model, params, 2, batching="paged")
    assert two == one
    _, inst = instance(fe)
    assert [m["layers"]["mlp"]["b_up"].shape[-1] for m in inst.params] == \
        [cfg.d_ff // 2] * 2


# -- the sequence-sharded paged decode ----------------------------------------


def jax_seqshard(q, kp, vp, tables, lens, shards):
    """JAX's sequence-sharded decode, its own ``_local_partials`` per slab
    and ``softmax_combine`` under ``vmap`` over the slab axis.  (Its
    ``shard_map`` wrapper cannot run on the installed jax 0.9, which
    renamed ``check_rep``; the seam's math is these two functions.)"""
    n_loc = kp.shape[0] // shards
    parts = [jseq._local_partials(q, kp[j * n_loc:(j + 1) * n_loc],
                                  vp[j * n_loc:(j + 1) * n_loc], tables,
                                  lens, j) for j in range(shards)]
    num, m, den = (jnp.stack(x) for x in zip(*parts))
    out = jax.vmap(lambda a, b, c: jseq.softmax_combine(a, b, c, "slab"),
                   axis_name="slab")(num, m, den)[0]
    return out.reshape(q.shape).astype(q.dtype)


@pytest.mark.parametrize("shards", [2, 4])
def test_seqshard_decode_equals_jax(shards):
    rng = np.random.default_rng(shards)
    b, h, kv, dh, bs, n_blocks, m = 3, 4, 2, 8, 4, 16, 5
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, bs, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, kv, dh)).astype(np.float32)
    tables = rng.permutation(n_blocks)[:b * m].reshape(b, m).astype(np.int32)
    lens = np.array([17, 3, 20], np.int32)
    want = jax_seqshard(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                        jnp.asarray(tables), jnp.asarray(lens), shards)
    slabs = lambda a: list(torch.as_tensor(a).chunk(shards))
    got = paged_decode_attention_seqshard(
        torch.as_tensor(q), slabs(kp), slabs(vp), torch.as_tensor(tables),
        torch.as_tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    plain = jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), rtol=TOL,
                               atol=TOL)


# -- what a pod does not serve yet --------------------------------------------


OUT_OF_SCOPE = [("the rwkv family", "rwkv6-1.6b"),
                ("the hybrid family", "hymba-1.5b")]


@pytest.mark.parametrize("what,arch", OUT_OF_SCOPE)
def test_out_of_scope_pods_raise_naming_item_11b(what, arch):
    model = build_model(get_config(arch, reduced=True))
    params = {"unused": torch.zeros(1)}
    fe = ClusterFrontend(n_nodes=4, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{what}.*item 11b"):
        fe.place_instance("f", model, params, ALLOC, shards=2)
    assert not fe.placements and fe.pool.total_used_area() == 0
    with pytest.raises(NotImplementedError, match="item 11b"):
        PodModel(model, tp_group(2, devices=["cpu"] * 2), False)
