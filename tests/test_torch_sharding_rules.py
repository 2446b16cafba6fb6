"""The port's logical sharding rules (``repro_torch.distributed.sharding``)
against JAX's (``repro.distributed.sharding``): every case of
``tests/test_sharding_rules.py`` (divisibility fallbacks, axis
exclusivity, the KV cache's context-parallel moves, column-only serving
placement), entry for entry, the JAX side under meshes of the four forced
host devices; and the serving placement of every parameter leaf of every
registered config, at 2 and 4 members.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jshard
from repro.models import build_model as jax_build
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.distributed import sharding as tshard
from repro_torch.models import build_model

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (forced host) devices")


def mesh_of(axes):
    sizes = [s for _, s in axes]
    devs = np.asarray(jax.devices()[: int(np.prod(sizes))]).reshape(sizes)
    return Mesh(devs, tuple(n for n, _ in axes))


MODEL4 = (("model", 4),)
RESOLVE = [
    (MODEL4, ("batch", "seq", "heads", None), (2, 16, 7, 8)),
    (MODEL4, ("d_ff",), (64,)),
    (MODEL4, ("vocab", "d_model"), (128, 30)),
    (MODEL4, ("heads",), (8,)),
    (MODEL4, ("kv_heads",), (2,)),
    (MODEL4, ("kv_heads",), (4,)),
    ((("model", 2), (jshard.SERVE_AXIS, 2)), ("heads", "kv_heads"), (8, 8)),
    ((("model", 2), (jshard.SERVE_AXIS, 2)), ("heads", "kv_heads"), (2, 2)),
    (((jshard.SERVE_AXIS, 4),), ("layers", "batch", "seq", "kv_heads",
                                 None), (2, 3, 16, 4, 8)),
]
CACHE = [
    ((("pod", 4),), (2, 1, 16, 4, 8)),
    ((("pod", 4),), (2, 4, 16, 4, 8)),
    (MODEL4, (2, 4, 16, 2, 8)),
    (MODEL4, (2, 4, 6, 2, 8)),
]
SERVE = [
    (("d_model", "tp"), (32, 64)),
    (("tp", "d_model"), (64, 32)),
    (("vocab", "d_model"), (64, 32)),
    (("d_model", "tp"), (32, 30)),
]


def sizes(axes):
    return dict(axes)


@pytest.mark.parametrize("axes,names,shape", RESOLVE)
def test_resolve_pspec_equals_jax(axes, names, shape):
    want = jshard.resolve_pspec(names, shape, mesh_of(axes))
    assert tshard.resolve_pspec(names, shape, sizes(axes)) == tuple(want)


@pytest.mark.parametrize("axes,shape", CACHE)
def test_cache_pspec_equals_jax(axes, shape):
    want = jshard.cache_pspec(shape, mesh_of(axes))
    assert tshard.cache_pspec(shape, sizes(axes)) == tuple(want)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("names,shape", SERVE)
def test_serve_pspec_equals_jax(names, shape, shards):
    want = jshard.serve_pspec(names, shape, jshard.tp_mesh(shards))
    got = tshard.serve_pspec(names, shape, {tshard.SERVE_AXIS: shards})
    assert got == tuple(want)


def test_tp_group_mirrors_tp_mesh():
    assert tshard.tp_group(1) is None and jshard.tp_mesh(1) is None
    for bad in (lambda: tshard.tp_group(0),
                lambda: tshard.tp_group(3, devices=["cpu"] * 2),
                lambda: tshard.tp_group(2, devices=["cpu"] * 2,
                                        nodes=[0])):
        with pytest.raises(ValueError):
            bad()
    g = tshard.tp_group(2, devices=["cpu", "cpu"], nodes=[3, 1])
    assert (g.n, g.nodes, g.one_device) == (2, (3, 1), True)
    assert tshard.serve_tp(g) == 2 and tshard.serve_tp(None) == 1
    assert tshard.sharding_for(("d_model", "tp"), (4, 8), None) is None


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", all_arch_ids())
def test_param_names_and_serving_placement_equal_jax(arch):
    """``Model.param_names()`` and the cache names equal JAX's for every
    registered config at its reduced size, and ``serve_pspec`` places
    every param leaf as JAX does at 2 and 4 members."""
    jm = jax_build(jax_config(arch, reduced=True))
    tm = build_model(get_config(arch, reduced=True))
    jnames = dict(_leaves(jm.param_names()))
    tnames = dict(_leaves(tm.param_names()))
    assert tnames == jnames
    assert tm.cache_names(3, 32) == jm.cache_names(3, 32)
    if tm.supports_paged():
        assert tm.paged_cache_names(9, 16) == jm.paged_cache_names(9, 16)
    shapes = dict(_leaves(jax.tree_util.tree_map(
        lambda s: s.shape, jm.abstract_params())))
    for shards in (2, 4):
        mesh = jshard.tp_mesh(shards)
        for key, names in jnames.items():
            want = jshard.serve_pspec(names, shapes[key], mesh)
            got = tshard.serve_pspec(names, shapes[key],
                                     {tshard.SERVE_AXIS: shards})
            assert got == tuple(want), (key, shards)


def test_shard_put_slices_every_member():
    """``shard_put`` gives each member its slice of a split dim and a copy
    of a replicated leaf, on its device."""
    group = tshard.tp_group(2, devices=["cpu", "cpu"])
    w = torch.arange(24.0).reshape(4, 6)
    tree = {"col": w, "row": w.T.contiguous(), "norm": torch.ones(4)}
    names = {"col": ("fsdp", "tp"), "row": ("tp", "fsdp"), "norm": (None,)}
    a, b = tshard.shard_put(tree, names, group, tshard.serve_pspec)
    assert torch.equal(a["col"], w[:, :3]) and torch.equal(b["col"], w[:, 3:])
    assert torch.equal(a["row"], w.T) and torch.equal(b["row"], w.T)
    assert a["norm"].data_ptr() != b["norm"].data_ptr()  # a real copy
    assert tshard.per_member_bytes(group, [a, b]) == {
        0: (12 + 24 + 4) * 4, 1: (12 + 24 + 4) * 4}
