"""Sharded pods of the rwkv and hybrid families in the port (``PodModel``,
``rwkv6.prefill_tp``/``decode_step_tp``, ``hybrid.prefill_tp``/
``decode_step_tp``, ``ClusterFrontend(shards > 1)``) against the JAX
package's pods, on the CPU: a port ``TPGroup`` of ``["cpu"] * n`` stands
in for n members, JAX runs on the four forced host devices, the kernels
run their plain versions, and the params are f32, bridged from JAX's.

The pods, continuous batching, each pool split by head where its heads
divide the group and replicated where they do not:

* rwkv6-1.6b's reduced cut (2 heads of 64): ``wkv`` split at 2 members,
  replicated at 4, where every column leaf still splits into 32 columns,
  half a head;
* an rwkv6 cut with 4 heads (d=256): split at 2 and at 4, as the full
  width's 32 heads are;
* hymba-1.5b's reduced cut (4 heads, 2 kv): K/V and ``ssm`` split at 2;
  at 4 K/V replicated and ``ssm`` split;
* a hymba cut with 5 q heads over 1 kv head at d=80: every pool
  replicated at 2 and 4, with the ``w_in`` and q columns ending mid-head,
  as the full width's 25 heads over 5 are.

At 2 and 4 members:

* greedy streams equal JAX's pods and the port's ``shards=1``; sampled
  streams equal the port's ``shards=1``;
* each member's weight and state bytes equal JAX's ``per_device_bytes``,
  and the frontend charges each member what JAX's charges;
* a prefill's state leaves and logits and two rounds' logits equal JAX's
  under a 2-device mesh within 2e-5 (tests/test_kernels.py:23-25, f32).
"""

import dataclasses

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
from repro.serving import ClusterFrontend as JaxFrontend
from repro.serving.engine import per_device_bytes
from repro_torch import bridge
from repro_torch.core.resources import Alloc
from repro_torch.distributed import (per_member_bytes, serve_pspec,
                                     shard_put, tp_group)
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import PodModel
from repro_torch.serving import ClusterFrontend
from repro_torch.serving.speculative import SamplingConfig

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (forced host) devices")

torch.set_num_threads(2)
TOL = 2e-5  # f32, tests/test_kernels.py:23-25
ALLOC = Alloc(sm=0.25, quota_request=0.25, quota_limit=0.5)
JAX_ALLOC = JaxAlloc(sm=0.25, quota_request=0.25, quota_limit=0.5)
MAX_LEN = 32
NEW_TOKENS = 8
PROMPTS = [np.array([3, 1, 4, 1, 5], dtype=np.int32),
           np.array([9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4, 6, 2, 6,
                     4], dtype=np.int32),
           np.array([2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5], dtype=np.int32)]
SAMPLING = SamplingConfig(temperature=0.8, top_k=8, seed=7)

# name -> (arch, the cut's overrides, {shards: heads a member's pools
# hold, leaf by leaf}).
CUTS = {
    "rwkv6": ("rwkv6-1.6b", {},
              {2: {"wkv": 1}, 4: {"wkv": 2}}),
    "rwkv6-4heads": ("rwkv6-1.6b",
                     dict(d_model=256, n_heads=4, n_kv_heads=4),
                     {2: {"wkv": 2}, 4: {"wkv": 1}}),
    "hymba": ("hymba-1.5b", {},
              {2: {"k": 1, "v": 1, "ssm": 2},
               4: {"k": 2, "v": 2, "ssm": 1}}),
    "hymba-5q1kv": ("hymba-1.5b", dict(d_model=80, n_heads=5, n_kv_heads=1),
                    {2: {"k": 1, "v": 1, "ssm": 5},
                     4: {"k": 1, "v": 1, "ssm": 5}}),
}
# The head axis of each pool leaf.
HEAD_AXIS = {"wkv": 2, "ssm": 2, "k": 3, "v": 3}

_MODELS: dict = {}


def models(name: str) -> dict:
    """The cut in both packages with f32 params (column-only TP is exact
    in f32), the port's bridged from JAX's."""
    if name not in _MODELS:
        arch, over, _ = CUTS[name]
        jcfg = dataclasses.replace(jax_config(arch, reduced=True), **over)
        jm = jax_build(jcfg)
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                    jm.init(jax.random.key(0)))
        tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
        _MODELS[name] = dict(jm=jm, jp=jp, tm=tm,
                             tp=bridge.to_torch(jax.device_get(jp)))
    return _MODELS[name]


_SERVED: dict = {}


def served(name, shards, pkg="torch", sampling=None):
    """Place one continuous instance of ``shards`` members on a 4-node
    frontend and serve PROMPTS (memoized): (frontend, streams)."""
    key = (name, shards, pkg, sampling is not None)
    if key in _SERVED:
        return _SERVED[key]
    m = models(name)
    if pkg == "torch":
        fe = ClusterFrontend(n_nodes=4, device="cpu")
        model, params, alloc = m["tm"], m["tp"], ALLOC
    else:
        fe = JaxFrontend(n_nodes=4)
        model, params, alloc = m["jm"], m["jp"], JAX_ALLOC
    h = fe.place_instance("f", model, params, alloc, max_batch=4,
                          max_len=MAX_LEN, sampling=sampling, shards=shards)
    assert h is not None, f"placement failed for shards={shards}"
    reqs = [fe.submit("f", p, max_new_tokens=NEW_TOKENS) for p in PROMPTS]
    fe.pump(budget_s=120.0)
    assert all(r.done for r in reqs)
    _SERVED[key] = fe, [list(r.tokens_out) for r in reqs]
    return _SERVED[key]


def instance(fe):
    [p] = fe.placements
    return p, fe.engines[p.node].instances[p.inst_id]


# -- streams ------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", list(CUTS))
def test_greedy_streams_equal_jax_pods_and_one_device(name, shards):
    fe, toks = served(name, shards)
    _, jax_toks = served(name, shards, pkg="jax")
    _, one = served(name, 1)
    assert toks == jax_toks == one
    p, inst = instance(fe)
    assert len(set(p.member_nodes)) == shards
    assert inst.group.nodes == p.member_nodes
    assert isinstance(inst.runner, PodModel)
    assert inst.round_graph.captures == 0  # the CPU runs rounds eagerly
    assert inst.prefill_graphs is None     # exact-length prefill


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", list(CUTS))
def test_sampled_streams_equal_one_device(name, shards):
    _, toks = served(name, shards, sampling=SAMPLING)
    _, one = served(name, 1, sampling=SAMPLING)
    assert toks == one
    assert len(set(map(tuple, one))) > 1  # really stochastic output


# -- bytes --------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", list(CUTS))
def test_member_bytes_equal_jax_per_device_bytes(name, shards):
    """Each member's weight bytes equal JAX's ``per_device_bytes`` of the
    pod's params and its state bytes JAX's of the pool its engine places
    (the pools split by head where the heads divide the group, whole on
    every member where they do not), and the frontend charges each
    member JAX's share of the pool, 1/shards of it, whole or not."""
    fe, _ = served(name, shards)
    jfe, _ = served(name, shards, pkg="jax")
    p, inst = instance(fe)
    jp, jinst = instance(jfe)
    assert p.member_nodes == jp.member_nodes
    assert per_member_bytes(inst.group, inst.params) == \
        per_device_bytes(jinst.params)
    jcache = jinst._init_cache()
    assert sorted(jcache) == sorted(inst.cache[0])
    assert per_member_bytes(inst.group, inst.cache) == \
        per_device_bytes(jcache)
    assert fe._fn_mm["f"].framework_bytes == jfe._fn_mm["f"].framework_bytes
    for c in inst.cache:
        assert {k: leaf.shape[HEAD_AXIS[k]] for k, leaf in c.items()
                if k in HEAD_AXIS} == CUTS[name][2][shards]
    whole = sum(instance(served(name, 1)[0])[1]
                .hbm_bytes_by_member().values())
    assert all(b < whole for b in inst.hbm_bytes_by_member().values())


# -- logits and state against JAX under a mesh --------------------------------


def _member_leaf(caches, key, full_heads):
    """A pool leaf as one device holds it: the members' heads concatenated
    where the pool splits them, else the primary's (every member's equal
    to it)."""
    axis = HEAD_AXIS.get(key)
    if axis is not None and caches[0][key].shape[axis] < full_heads:
        return torch.cat([c[key] for c in caches], dim=axis)
    for c in caches[1:]:
        assert torch.equal(c[key], caches[0][key]), key
    return caches[0][key]


@pytest.mark.parametrize("name", list(CUTS))
def test_logits_and_state_equal_jax_under_a_mesh(name):
    """A prefill's state leaves and logits and two rounds' logits of a
    2-member pod equal JAX's model under a 2-device serving mesh within
    2e-5.  JAX's prefill and decode step return the token-shift rows and
    K/V in the params' dtype; its engine keeps them in the bf16 pool, as
    the port's steps write them, so each round here reads every leaf
    cast to the pool's dtype."""
    m = models(name)
    jm, tm = m["jm"], m["tm"]
    cfg = tm.cfg
    mesh = tp_mesh(2, devices=jax.devices()[:2])
    jparams = jax_shard_put(m["jp"], jm.param_names(), mesh,
                            resolver=jax_serve_pspec)
    group = tp_group(2, devices=["cpu", "cpu"])
    members = shard_put(m["tp"], tm.param_names(), group, serve_pspec)
    pod = PodModel(tm, group, False)
    dtypes = {k: jnp.dtype(str(d).removeprefix("torch."))
              for k, (_, d) in tm.cache_specs(1, MAX_LEN).items()}
    tokens = PROMPTS[1][None]

    def pooled(cache):
        return {k: v.astype(dtypes[k]) if k in dtypes else v
                for k, v in cache.items()}

    with use_mesh(mesh):
        jl, jcache = jm.prefill(jparams, jnp.asarray(tokens), max_len=MAX_LEN)
        jcache = pooled(jcache)
        want_cache = jax.device_get(jcache)
        steps = [jl]
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        for _ in range(2):
            jl, jcache = jm.decode_step(jparams, tok, jcache)
            jcache = pooled(jcache)
            steps.append(jl)
            tok = jnp.argmax(jl, -1).astype(jnp.int32)
    tl, caches = pod.prefill(members, torch.as_tensor(tokens),
                             max_len=MAX_LEN)
    heads = {"wkv": cfg.d_model // 64, "ssm": cfg.n_heads,
             "k": cfg.n_kv_heads, "v": cfg.n_kv_heads}
    for key, want in want_cache.items():
        if key == "pos":
            assert all(int(c["pos"]) == int(want) for c in caches)
            continue
        got = _member_leaf(caches, key, heads.get(key))
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


@pytest.mark.parametrize("name", ["rwkv6", "hymba"])
def test_pod_prefill_refuses_length(name):
    """A pod of these families prefills at the exact prompt length, as
    one device does: a bucketed ``length`` is refused."""
    m = models(name)
    group = tp_group(2, devices=["cpu", "cpu"])
    members = shard_put(m["tp"], m["tm"].param_names(), group, serve_pspec)
    with pytest.raises(NotImplementedError, match="exact prompt length"):
        PodModel(m["tm"], group, False).prefill(
            members, torch.as_tensor(PROMPTS[0][None]), max_len=MAX_LEN,
            length=3)
