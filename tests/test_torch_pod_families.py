"""Sharded pods of int8 KV, windowed and dual caches and the MoE family in
the port (``PodModel``, the ``*_tp`` seams, ``moe.moe_tp``,
``ClusterFrontend(shards > 1)``) against the JAX package's pods, on the
CPU: a port ``TPGroup`` of ``["cpu"] * n`` stands in for n members, JAX
runs on the four forced host devices, the kernels run their plain
versions, and the params are f32, bridged from JAX's.

The pods: the reduced qwen2-7b under ``REPRO_KV_INT8=1`` (continuous and
paged), gemma3-27b's reduced cut (dual caches, window 8; continuous),
mixtral-8x7b's (moe on a rolled cache, window 16; continuous) and
qwen2-moe-a2.7b's (continuous and paged).  At 2 and 4 members:

* greedy streams equal JAX's pods and the port's ``shards=1``; sampled
  streams equal the port's ``shards=1``;
* each member's weight and KV bytes equal JAX's ``per_device_bytes``
  (gemma3's and mixtral's 2 kv heads replicate at 4 members), and the
  frontend charges each member what JAX's charges;
* a prefill's and two rounds' logits equal JAX's under a 2-device mesh
  within 2e-5 (tests/test_kernels.py:23-25, f32);
* ``moe_tp`` equals ``moe_apply`` and JAX's ``moe_apply`` under a
  serving mesh, at an overflowing capacity too;
* every member's decode kernels split S as one device's (``plan_kv``);
* the fleet store's sharded upload of the 3-D expert leaves equals
  ``shard_put``; the context families are refused at any ``shards``
  before any rectangle is taken.
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.resources import Alloc as JaxAlloc
from repro.distributed.sharding import serve_pspec as jax_serve_pspec
from repro.distributed.sharding import shard_put as jax_shard_put
from repro.distributed.sharding import tp_mesh, use_mesh
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro.serving import ClusterFrontend as JaxFrontend
from repro.serving.engine import per_device_bytes
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.resources import Alloc
from repro_torch.distributed import (Sharding, per_member_bytes, serve_pspec,
                                     shard_put, tp_group)
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models import build_model, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import PodModel
from repro_torch.serving import ClusterFrontend
from repro_torch.serving.modelstore import stage_params, upload_params
from repro_torch.serving.speculative import SamplingConfig

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (forced host) devices")

torch.set_num_threads(2)
TOL = 2e-5  # f32, tests/test_kernels.py:23-25
ALLOC = Alloc(sm=0.25, quota_request=0.25, quota_limit=0.5)
JAX_ALLOC = JaxAlloc(sm=0.25, quota_request=0.25, quota_limit=0.5)
MAX_LEN = 32
NEW_TOKENS = 8
# 19 + 8 tokens run past mixtral's window of 16 and gemma3's of 8.
PROMPTS = [np.array([3, 1, 4, 1, 5], dtype=np.int32),
           np.array([9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4, 6, 2, 6,
                     4], dtype=np.int32),
           np.array([2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5], dtype=np.int32)]
SAMPLING = SamplingConfig(temperature=0.8, top_k=8, seed=7)

# (arch, int8 KV, batching): the pods this slice serves.
PODS = [("qwen2-7b", True, "continuous"), ("qwen2-7b", True, "paged"),
        ("gemma3-27b", False, "continuous"),
        ("mixtral-8x7b", False, "continuous"),
        ("qwen2-moe-a2.7b", False, "continuous"),
        ("qwen2-moe-a2.7b", False, "paged")]
POD_IDS = [f"{a}-{'int8-' if q else ''}{b}" for a, q, b in PODS]


@contextlib.contextmanager
def kv_int8(on: bool):
    """``REPRO_KV_INT8`` set for the block (both packages read it where a
    cache is made and where a prefill is traced)."""
    old = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_KV_INT8"]
        else:
            os.environ["REPRO_KV_INT8"] = old


_MODELS: dict = {}


def models(arch: str) -> dict:
    """The reduced config in both packages with f32 params (column-only
    TP is exact in f32), the port's bridged from JAX's."""
    if arch not in _MODELS:
        jcfg = jax_config(arch, reduced=True)
        jm = jax_build(jcfg)
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                    jm.init(jax.random.key(0)))
        tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
        _MODELS[arch] = dict(jm=jm, jp=jp, tm=tm,
                             tp=bridge.to_torch(jax.device_get(jp)))
    return _MODELS[arch]


_SERVED: dict = {}


def served(arch, int8, batching, shards, pkg="torch", sampling=None):
    """Place one instance of ``shards`` members on a 4-node frontend and
    serve PROMPTS (memoized): (frontend, streams)."""
    key = (arch, int8, batching, shards, pkg, sampling is not None)
    if key in _SERVED:
        return _SERVED[key]
    m = models(arch)
    with kv_int8(int8):
        if pkg == "torch":
            fe = ClusterFrontend(n_nodes=4, device="cpu")
            model, params, alloc = m["tm"], m["tp"], ALLOC
        else:
            fe = JaxFrontend(n_nodes=4)
            model, params, alloc = m["jm"], m["jp"], JAX_ALLOC
        h = fe.place_instance("f", model, params, alloc, max_batch=4,
                              max_len=MAX_LEN, batching=batching,
                              sampling=sampling, shards=shards)
        assert h is not None, f"placement failed for shards={shards}"
        reqs = [fe.submit("f", p, max_new_tokens=NEW_TOKENS)
                for p in PROMPTS]
        fe.pump(budget_s=120.0)
    assert all(r.done for r in reqs)
    _SERVED[key] = fe, [list(r.tokens_out) for r in reqs]
    return _SERVED[key]


def instance(fe):
    [p] = fe.placements
    return p, fe.engines[p.node].instances[p.inst_id]


# -- streams ------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("arch,int8,batching", PODS, ids=POD_IDS)
def test_greedy_streams_equal_jax_pods_and_one_device(arch, int8, batching,
                                                      shards):
    fe, toks = served(arch, int8, batching, shards)
    _, jax_toks = served(arch, int8, batching, shards, pkg="jax")
    _, one = served(arch, int8, batching, 1)
    assert toks == jax_toks == one
    p, inst = instance(fe)
    assert len(set(p.member_nodes)) == shards
    assert inst.group.nodes == p.member_nodes
    assert inst.kv_int8 == int8
    assert all(("k_scale" in c) == int8 for c in inst.cache)
    if inst.model.cfg.local_global_ratio:
        assert all("global_k" in c for c in inst.cache)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("arch,int8,batching", PODS, ids=POD_IDS)
def test_sampled_streams_equal_one_device(arch, int8, batching, shards):
    _, toks = served(arch, int8, batching, shards, sampling=SAMPLING)
    _, one = served(arch, int8, batching, 1, sampling=SAMPLING)
    assert toks == one
    assert len(set(map(tuple, one))) > 1  # really stochastic output


# -- bytes --------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("arch,int8,batching", PODS, ids=POD_IDS)
def test_member_bytes_equal_jax_per_device_bytes(arch, int8, batching,
                                                 shards):
    """Each member's weight bytes equal JAX's ``per_device_bytes`` of the
    pod's params, its pool bytes JAX's of the pool its engine places
    (the port's paged pool holds one sink block more, taken off), and
    the frontend charges each member JAX's KV share; the int8 scales,
    the dual caches' global leaves and the pool split by kv head where
    the heads divide the group, replicated where they do not."""
    fe, _ = served(arch, int8, batching, shards)
    jfe, _ = served(arch, int8, batching, shards, pkg="jax")
    p, inst = instance(fe)
    jp, jinst = instance(jfe)
    assert p.member_nodes == jp.member_nodes
    assert per_member_bytes(inst.group, inst.params) == \
        per_device_bytes(jinst.params)
    kv = per_member_bytes(inst.group, inst.cache)
    with kv_int8(int8):
        jcache = jinst._init_cache()
    assert sorted(jcache) == sorted(inst.cache[0])
    if batching == "paged":
        sink = {n: b // (inst.allocator.n_blocks + 1) for n, b in kv.items()}
        kv = {n: b - sink[n] for n, b in kv.items()}
    assert kv == per_device_bytes(jcache)
    assert fe._fn_mm["f"].framework_bytes == jfe._fn_mm["f"].framework_bytes
    cfg = inst.model.cfg
    heads = cfg.n_kv_heads // shards if cfg.n_kv_heads % shards == 0 \
        else cfg.n_kv_heads
    for c in inst.cache:
        assert all(leaf.shape[-2] == heads for k, leaf in c.items()
                   if k != "pos")
    whole = sum(instance(served(arch, int8, batching, 1)[0])[1]
                .hbm_bytes_by_member().values())
    assert all(b < whole for b in inst.hbm_bytes_by_member().values())


# -- the decode kernels' split of S -------------------------------------------


DECODE_KERNELS = ("decode_attention", "paged_decode_attention",
                  "decode_attention_quant", "paged_decode_attention_quant")


@pytest.mark.parametrize("shards", [2, 4])
def test_member_decode_plan_is_one_devices_with_plan_kv(shards):
    """A member's cache, planned for the whole model's kv heads, splits S
    as one device's cache does (so its heads attend as one device's on
    the card, where each CTA walks one kv head), over bf16 K/V and int8
    codes alike (one ``cluster_plan`` for all four kernels); planned for
    its own heads it splits S otherwise.  qwen2-moe-a2.7b's round: B=8,
    S=1024, 16 kv heads of 128."""
    tables = torch.empty(8, 64, dtype=torch.int32, device="meta")
    for dtype in (torch.bfloat16, torch.int8):
        whole = torch.empty(8, 1024, 16, 128, dtype=dtype, device="meta")
        member = torch.empty(8, 1024, 16 // shards, 128, dtype=dtype,
                             device="meta")
        pages = torch.empty(513, 16, 16 // shards, 128, dtype=dtype,
                            device="meta")
        assert da.decode_plan(member, plan_kv=16) == da.decode_plan(whole)
        assert da.decode_plan(member) != da.decode_plan(whole)
        assert da.decode_plan(pages, tables, plan_kv=16) == \
            da.decode_plan(whole)


# mixtral's reduced cut attends its rolled cache in plain torch on every
# layer: its rounds launch no decode kernel.
KERNEL_PODS = [p for p in PODS if p[0] != "mixtral-8x7b"]


@pytest.mark.parametrize("arch,int8,batching", KERNEL_PODS,
                         ids=[i for i in POD_IDS if "mixtral" not in i])
def test_members_plan_the_decode_split_for_the_whole_model(
        arch, int8, batching, monkeypatch):
    """Every decode kernel call of a 2-member pod's rounds plans its split
    of S for the model's kv heads (``plan_kv``), whatever heads the
    member holds."""
    plans = []
    for name in DECODE_KERNELS:
        def spy(*args, _fn=getattr(ops, name), **kw):
            plans.append(kw.get("plan_kv"))
            return _fn(*args, **kw)
        monkeypatch.setattr(ops, name, spy)
    m = models(arch)
    with kv_int8(int8):
        fe = ClusterFrontend(n_nodes=4, device="cpu")
        fe.place_instance("f", m["tm"], m["tp"], ALLOC, max_batch=4,
                          max_len=MAX_LEN, batching=batching, shards=2)
        [req] = [fe.submit("f", PROMPTS[0], max_new_tokens=3)]
        fe.pump(budget_s=120.0)
    assert req.done
    assert plans and set(plans) == {m["tm"].cfg.n_kv_heads}


# -- logits against JAX under a mesh ------------------------------------------


ARCHS = [("qwen2-7b", True), ("gemma3-27b", False), ("mixtral-8x7b", False),
         ("qwen2-moe-a2.7b", False)]


@pytest.mark.parametrize("arch,int8", ARCHS, ids=[a for a, _ in ARCHS])
def test_logits_equal_jax_under_a_mesh(arch, int8):
    """A prefill's and two rounds' logits of a 2-member pod equal JAX's
    model under a 2-device serving mesh within 2e-5, and so does the
    prefill's cache, leaf by leaf.  JAX's prefill returns its K/V in the
    params' dtype; its engine merges them into the bf16 pool, as the
    port's prefill writes them, so the rounds here read them cast to
    bf16 (int8 codes as they are)."""
    m = models(arch)
    jm, tm = m["jm"], m["tm"]
    mesh = tp_mesh(2, devices=jax.devices()[:2])
    jparams = jax_shard_put(m["jp"], jm.param_names(), mesh,
                            resolver=jax_serve_pspec)
    group = tp_group(2, devices=["cpu", "cpu"])
    members = shard_put(m["tp"], tm.param_names(), group, serve_pspec)
    pod = PodModel(tm, group, int8)
    tokens = PROMPTS[1][None]
    with kv_int8(int8), use_mesh(mesh):
        jl, jcache = jm.prefill(jparams, jnp.asarray(tokens), max_len=MAX_LEN)
        jcache = {k: (v.astype(jnp.bfloat16)
                      if jnp.issubdtype(v.dtype, jnp.floating) else v)
                  for k, v in jcache.items()}
        want_cache = jax.device_get(jcache)
        steps = [jl]
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        for _ in range(2):
            jl, jcache = jm.decode_step(jparams, tok, jcache)
            steps.append(jl)
            tok = jnp.argmax(jl, -1).astype(jnp.int32)
    tl, caches = pod.prefill(members, torch.as_tensor(tokens),
                             max_len=MAX_LEN)
    heads = caches[0]["k"].shape[-2]
    for key, want in want_cache.items():
        if key == "pos":
            continue
        got = torch.cat([c[key] for c in caches], dim=-2) \
            if heads < tm.cfg.n_kv_heads else caches[0][key]
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=TOL,
                                   atol=TOL, err_msg=key)
    got = [tl]
    tok = torch.argmax(tl, -1).to(torch.int32)
    for _ in range(2):
        tl, caches = pod.decode_step(members, tok, caches)
        got.append(tl)
        tok = torch.argmax(tl, -1).to(torch.int32)
    for a, b in zip(got, steps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


# -- moe_tp -------------------------------------------------------------------


MOES = ["qwen2-moe-a2.7b", "mixtral-8x7b"]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("arch", MOES)
@pytest.mark.parametrize("factor", [None, 0.5], ids=["eval", "overflow"])
def test_moe_tp_equals_moe_apply_and_jax(arch, shards, factor):
    """``moe_tp`` over a member group equals ``moe_apply`` on one device
    and JAX's ``moe_apply`` under a 2-device serving mesh (its
    single-device path on column-split experts), at the serving
    capacity factor and at 0.5, where pairs overflow (and the aux loss
    with it).  Every member's routing is one device's: ``dest``/``keep``
    of its router copy on its token copy."""
    m = models(arch)
    cfg = m["tm"].cfg
    cf = cfg.moe_cf_eval if factor is None else factor
    lp = {k: v[0] for k, v in m["tp"]["layers"]["moe"].items()
          if not isinstance(v, dict)}
    if "shared" in m["tp"]["layers"]["moe"]:
        lp["shared"] = {k: v[0] for k, v in
                        m["tp"]["layers"]["moe"]["shared"].items()}
    names = {k: (v[1:] if isinstance(v, tuple) else
                 {kk: vv[1:] for kk, vv in v.items()})
             for k, v in m["tm"].param_names()["layers"]["moe"].items()}
    rng = np.random.default_rng(shards)
    x_np = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    x = torch.as_tensor(x_np)
    want, aux = moe.moe_apply(lp, x, cfg, cf)
    group = tp_group(shards, devices=["cpu"] * shards)
    lps = shard_put(lp, names, group, serve_pspec)
    assert lps[0]["w_gate"].shape[-1] == cfg.expert_d_ff // shards
    assert lps[0]["w_down"].shape == lp["w_down"].shape
    got, got_aux = moe.moe_tp(lps, [x.clone() for _ in range(shards)], cfg,
                              group, cf)
    for g in got:
        assert torch.equal(g, want)
    assert torch.equal(got_aux, aux)
    t = x_np.shape[0] * x_np.shape[1]
    cap = moe._capacity(t, cfg, cf)
    r = moe.route(lp["router"], x.reshape(t, -1), cfg, cap)
    for member in lps:
        rm = moe.route(member["router"], x.reshape(t, -1), cfg, cap)
        assert torch.equal(rm["dest"], r["dest"])
        assert torch.equal(rm["keep"], r["keep"])
    assert bool(r["keep"].all()) == (factor is None)
    mesh = tp_mesh(2, devices=jax.devices()[:2])
    jlp = jax.tree_util.tree_map(lambda a: a[0], m["jp"]["layers"]["moe"])
    jnames = jax.tree_util.tree_map(
        lambda n: n[1:], m["jm"].param_names()["layers"]["moe"],
        is_leaf=lambda n: isinstance(n, tuple))
    with use_mesh(mesh):
        jy, jaux = jmoe.moe_apply(
            jax_shard_put(jlp, jnames, mesh, resolver=jax_serve_pspec),
            jnp.asarray(x_np), m["jm"].cfg, cf)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(got_aux), float(jaux), rtol=TOL,
                               atol=TOL)


# -- the fleet store's sharded upload of the expert leaves ----------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_upload_of_expert_leaves_equals_shard_put(shards):
    """qwen2-moe's staged tree (the stacked (L, E, d, fe) expert leaves,
    the f32 router) uploaded as each member's slices equals
    ``shard_put`` by ``serve_pspec``, leaf for leaf and dtype for
    dtype."""
    m = models("qwen2-moe-a2.7b")
    tm, params = m["tm"], m["tp"]
    group = tp_group(shards, devices=["cpu"] * shards)
    staged = stage_params(tm, params)
    names = [n for _, n in sorted(_flat(tm.param_names()).items())]
    shapes = [((len(leaf),) + leaf[0].shape) if st else leaf.shape
              for leaf, st in zip(staged.leaves, staged.stacked)]
    shardings = [Sharding(group, serve_pspec(n, s, group.axis_sizes))
                 for n, s in zip(names, shapes)]
    got, _ = upload_params(staged, mode="blocking", device="cpu",
                           shardings=shardings)
    want = shard_put(params, tm.param_names(), group, serve_pspec)
    for g, w in zip(got, want):
        gf = _flat(g)
        for key, leaf in _flat(w).items():
            assert gf[key].dtype == leaf.dtype and torch.equal(gf[key],
                                                               leaf), key
    assert want[0]["layers"]["moe"]["w_up"].shape[-1] == \
        tm.cfg.expert_d_ff // shards


# -- the context families -----------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_context_families_refused_at_any_shards(arch, shards):
    """A family that prefills with a context raises the engine's context
    refusal whatever ``shards`` is (the reference has no pods of it: its
    engine prefills with the prompt alone), before any rectangle or
    memory model is taken."""
    model = build_model(get_config(arch, reduced=True))
    fe = ClusterFrontend(n_nodes=4, device="cpu")
    with pytest.raises(ValueError, match="prefills with a context"):
        fe.place_instance("f", model, {"unused": torch.zeros(1)}, ALLOC,
                          shards=shards)
    assert not fe.placements and fe.pool.total_used_area() == 0
    assert not fe._fn_mm
