"""mixtral-8x7b at its full widths in the port, on the CPU, with no
full-width weight drawn (the card's runs are ``chip_smoke.py``'s
``mixtral_phase`` and ``scripts/mixtral_pod_cards.py``):

* **Sizes:** the params, weight bytes (the f32 router included) and
  ``dense_kv_bytes`` at (8, 1024) and (8, 4608) of all 32 layers and of
  the smoke's 8-layer cut, reckoned from the port's specs, equal JAX's
  (``jax.eval_shape`` of its init) and ``chip_smoke.py``'s
  ``MIXTRAL_SIZES``.
* **Members:** a 2- and a 4-member pod's weight and pool bytes a member,
  as the port places them (``dryrun.serve_member_bytes``: ``shard_put``
  by ``serve_pspec``, ``PodModel.init_slot_cache``, on meta), equal
  JAX's ``per_device_bytes`` of the same placement (reckoned from each
  leaf's shard shape; the reckoning equals ``per_device_bytes`` of real
  arrays on the reduced config) and the dry run's fit row.
* **Admission:** both frontends charge a mixtral pod's member the same
  memory model (the whole weights, as JAX's frontend.py:299-307 does,
  and a 1/shards share of the pool), so on 80 GB nodes both refuse it at
  1, 2 and 4 members, though a 2-member pod's member holds 62.81 GB.
* **Staging:** ``stage_drawn`` stages ``model.init``'s weights bit for
  bit from a seed, a piece at a time, the same for the same seed and
  other for another, and a pod placed from them through the fleet store
  holds ``shard_put``'s slices of ``model.init``'s tree.
* **The card checks' helpers** (``chip_smoke.py``): its byte constants
  equal the dry run's reckoning at the depth it serves each pod;
  ``routed_as`` takes another run's experts, and within ``pod_routes``
  records the run's own choices on them; ``routing_ties`` allows a flip
  only at a near-tie and holds the gates within ``GATE_TOL``;
  ``held_against`` frees at most ``1 - MIN_KEPT`` of the prompts' first
  tokens; the kernel phase's window check (``window_probe``) passes the
  windowed plain version and fails the windowless one and one a key
  short.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.configs import get_config as jax_config
from repro.core.resources import Alloc as JaxAlloc
from repro.distributed.sharding import resolve_pspec as jax_resolve_pspec
from repro.distributed.sharding import serve_pspec as jax_serve_pspec
from repro.distributed.sharding import shard_put as jax_shard_put
from repro.distributed.sharding import tp_mesh
from repro.models import build_model as jax_build
from repro.serving import ClusterFrontend as JaxFrontend
from repro.serving.engine import per_device_bytes
from repro_torch.configs import get_config
from repro_torch.core.resources import Alloc
from repro_torch.distributed import serve_pspec, shard_put, tp_group
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.serving import ClusterFrontend, FleetModelStore
from repro_torch.serving.modelstore import stage_drawn, stage_params

ARCH = "mixtral-8x7b"
HBM_BYTES = 80 * 10**9  # a card's memory, as the dry run's fit table
# (params, weight bytes, dense_kv_bytes(8, 1024), dense_kv_bytes(8, 4608))
# by depth, as chip_smoke.py's MIXTRAL_SIZES; C = min(4096, max_len)
SIZES = {32: (46_702_792_704, 93_407_682_560, 1_073_741_828,
              4_294_967_300),
         8: (11_872_309_248, 23_745_142_784, 268_435_460, 1_073_741_828)}
# (weights, 8 x 1024 pool) a member, by depth and members: all 32 layers
# the dry run's fit table's row, 8 chip_smoke.py's POD_MEMBER_BYTES
MEMBERS = {32: {2: (62_275_461_120, 536_870_944),
                4: (46_709_350_400, 268_435_488)},
           8: {2: (15_765_479_424, 134_217_760),
               4: (11_775_647_744, 67_108_896)}}

needs_4 = pytest.mark.skipif(len(jax.devices()) < 4,
                             reason="needs 4 (forced host) devices")


def cut(cfg, layers):
    return dataclasses.replace(cfg, n_layers=layers)


def _spec_bytes(model) -> tuple[int, int]:
    leaves = []

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        else:
            leaves.append(tree)
    walk(model.specs)
    return (sum(int(np.prod(s.shape)) for s in leaves),
            sum(int(np.prod(s.shape)) * s.dtype.itemsize for s in leaves))


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None)))
                                        for i in x)


def _jax_shard_bytes(names_tree, shapes, mesh, resolver) -> int:
    """Bytes one device of ``mesh`` holds of a tree of shapes placed by
    ``resolver``: each leaf's shard shape (even splits: every device holds
    one shard of it), what ``per_device_bytes`` counts of real arrays."""
    total = []
    jax.tree_util.tree_map(
        lambda names, s: total.append(int(np.prod(NamedSharding(
            mesh, resolver(names, s.shape, mesh)).shard_shape(s.shape)))
            * s.dtype.itemsize),
        names_tree, shapes, is_leaf=_is_names)
    return sum(total)


def jax_member_bytes(jcfg, shards, n_slots=8, max_len=1024):
    """(weights, pool) one device of a JAX pod of ``shards`` holds: the
    params by ``serve_pspec``, the slot pool as its engine places it
    (engine.py:487-507: ``resolve_pspec``, per-slot ``pos`` replicated),
    reckoned from ``jax.eval_shape``."""
    jm = jax_build(jcfg)
    mesh = tp_mesh(shards)
    params = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    pool = jax.eval_shape(lambda: jm.init_slot_cache(n_slots, max_len))
    names = dict(jm.cache_names(n_slots, max_len))
    names["pos"] = (None,)
    return (_jax_shard_bytes(jm.param_names(), params, mesh,
                             jax_serve_pspec),
            _jax_shard_bytes(names, pool, mesh, jax_resolve_pspec))


# -- sizes --------------------------------------------------------------------


@pytest.mark.parametrize("layers", [32, 8])
def test_full_width_sizes_equal_jax(layers):
    model = build_model(cut(get_config(ARCH), layers))
    jm = jax_build(cut(jax_config(ARCH), layers))
    shapes = jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jm.init(jax.random.key(0))))
    jax_sizes = (sum(int(np.prod(s.shape)) for s in shapes),
                 sum(int(np.prod(s.shape)) * s.dtype.itemsize
                     for s in shapes),
                 jm.dense_kv_bytes(8, 1024), jm.dense_kv_bytes(8, 4608))
    sizes = (*_spec_bytes(model), model.dense_kv_bytes(8, 1024, False),
             model.dense_kv_bytes(8, 4608, False))
    assert sizes == jax_sizes == SIZES[layers]
    assert model.n_params() == sizes[0]
    # the router is the one f32 leaf: 2 bytes a param more than bf16
    e = model.cfg.n_experts * model.cfg.d_model * layers
    assert sizes[1] == 2 * sizes[0] + 2 * e


# -- a pod's members ----------------------------------------------------------


@needs_4
def test_jax_reckoning_equals_per_device_bytes_of_real_arrays():
    """The shard-shape reckoning of ``jax_member_bytes`` equals JAX's
    ``per_device_bytes`` of real arrays placed by its pods' rules, on the
    reduced config (head and expert dims split, the 2 kv heads replicated
    at 4 members)."""
    jcfg = jax_config(ARCH, reduced=True)
    jm = jax_build(jcfg)
    for shards in (2, 4):
        mesh = tp_mesh(shards)
        params = jax_shard_put(jm.init(jax.random.key(0)), jm.param_names(),
                               mesh, jax_serve_pspec)
        names = dict(jm.cache_names(8, 64))
        names["pos"] = (None,)
        pool = jax_shard_put(jm.init_slot_cache(8, 64), names, mesh)
        want = (set(per_device_bytes(params).values()),
                set(per_device_bytes(pool).values()))
        got = jax_member_bytes(jcfg, shards, 8, 64)
        assert want == ({got[0]}, {got[1]}), shards


@needs_4
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("layers", [32, 8])
def test_member_bytes_equal_jax_and_the_fit_row(layers, shards):
    port = dryrun.serve_member_bytes(cut(get_config(ARCH), layers), shards)
    assert port == jax_member_bytes(cut(jax_config(ARCH), layers),
                                    shards) == MEMBERS[layers][shards]
    if layers == 32:
        row = {r["arch"]: r for r in dryrun.fit_table([ARCH])}[ARCH]
        assert row["members"][shards] == port and row["fewest"] == 2
        assert sum(port) < HBM_BYTES


# -- the frontends' admission -------------------------------------------------


def _charged(fe, place) -> tuple:
    """``place()``'s result and every memory model the frontend asked a
    node to admit."""
    seen, admits = [], fe.admits

    def spy(node, fn, mm):
        seen.append(mm)
        return admits(node, fn, mm)

    fe.admits = spy
    return place(), seen


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_frontend_charge_refuses_on_80_gb_nodes_as_jax(shards):
    """Neither frontend places a mixtral pod on 80 GB nodes at 1, 2 or 4
    members, and both charge each member the same memory model: the
    whole weights (93.4 GB; JAX's frontend.py:299-307 keeps weights
    charged in full a member) and the pool's 1/shards.  A 2-member pod's
    member holds 62.28 GB of weights: the charge over-counts it by the
    columns the member does not hold (recorded in ROADMAP.md, Queue 3)."""
    model = build_model(get_config(ARCH))
    jm = jax_build(jax_config(ARCH))
    meta = dryrun.meta_params(model)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    jparams = jax.tree_util.tree_map(
        lambda s: types.SimpleNamespace(
            nbytes=int(np.prod(s.shape)) * s.dtype.itemsize), shapes)
    fe = ClusterFrontend(n_nodes=4, mem_bytes=HBM_BYTES, device="cpu")
    jfe = JaxFrontend(n_nodes=4, mem_bytes=HBM_BYTES)
    kw = dict(max_batch=8, max_len=1024, shards=shards)
    got, seen = _charged(fe, lambda: fe.place_instance(
        ARCH, model, meta, Alloc(sm=0.25, quota_request=0.5,
                                 quota_limit=1.0), **kw))
    jgot, jseen = _charged(jfe, lambda: jfe.place_instance(
        ARCH, jm, jparams, JaxAlloc(sm=0.25, quota_request=0.5,
                                    quota_limit=1.0), **kw))
    assert got is None and jgot is None
    assert seen and jseen
    charge = {(mm.weight_bytes, mm.framework_bytes) for mm in seen}
    assert charge == {(mm.weight_bytes, mm.framework_bytes) for mm in jseen}
    ((weights, framework),) = charge
    assert weights == SIZES[32][1]
    assert framework == 64 * 1024**2 + SIZES[32][2] // shards
    assert not fe.placements and not fe._fn_mm
    if shards > 1:
        member = sum(dryrun.serve_member_bytes(get_config(ARCH), shards))
        assert seen[0].footprint(1, sharing=True) > HBM_BYTES > member


# -- the weight staging -------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "qwen2-moe-a2.7b"])
def test_stage_drawn_is_init_staged_bit_for_bit(arch):
    model = build_model(get_config(arch, reduced=True))
    drawn = stage_drawn(model, 5, device="cpu")
    staged = stage_params(model, model.init(
        torch.Generator().manual_seed(5)))
    assert (drawn.layout, drawn.stacked, drawn.dtypes, drawn.nbytes,
            drawn.treedef) == (staged.layout, staged.stacked,
                               staged.dtypes, staged.nbytes, staged.treedef)
    n = len(drawn.layout)
    assert all(torch.equal(drawn.host_tensor(i), staged.host_tensor(i))
               for i in range(n))
    again = stage_drawn(model, 5, device="cpu")
    other = stage_drawn(model, 6, device="cpu")
    assert all(torch.equal(drawn.host_tensor(i), again.host_tensor(i))
               for i in range(n))
    assert not all(torch.equal(drawn.host_tensor(i), other.host_tensor(i))
                   for i in range(n))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("shards", [2, 4])
def test_drawn_weights_placed_as_a_pod_are_shard_puts_slices(shards):
    """A pod placed through the fleet store from ``stage_drawn``'s host
    buffer holds, member by member, ``shard_put``'s ``serve_pspec``
    slices of ``model.init``'s tree from the same seed: every layer
    slice landed where ``sharding_for`` places it."""
    model = build_model(get_config(ARCH, reduced=True))
    staged = stage_drawn(model, 7, device="cpu")
    store = FleetModelStore(host_budget_bytes=staged.nbytes + (1 << 20))
    store.cache(0).put(ARCH, staged)
    fe = ClusterFrontend(n_nodes=4, model_store=store, device="cpu")
    assert fe.place_instance(ARCH, model, None,
                             Alloc(sm=0.25, quota_request=0.5,
                                   quota_limit=1.0),
                             max_batch=2, max_len=32, shards=shards)
    (p,) = fe.placements
    inst = fe.engines[p.node].instances[p.inst_id]
    want = shard_put(model.init(torch.Generator().manual_seed(7)),
                     model.param_names(), tp_group(shards, ["cpu"] * shards),
                     serve_pspec)
    assert len(inst.params) == shards
    for got, exp in zip(inst.params, want):
        g = _flat(got)
        for key, leaf in _flat(exp).items():
            assert g[key].dtype == leaf.dtype and torch.equal(g[key], leaf), \
                key


# -- the card checks' routing helpers -----------------------------------------


def _smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_smoke_byte_constants_equal_the_dry_runs_reckoning():
    """Every byte constant ``chip_smoke.py`` serves by (its pods' member
    bytes at the depth it serves them, ``POD_LAYERS``; params and
    slot-pool bytes) equals the dry run's reckoning on the meta device,
    as its analysis phase holds them on the card; mixtral's served at 8
    of 32 layers."""
    smoke = _smoke()
    checks = smoke.byte_reckonings()
    assert "mixtral-8x7b member of 4" in checks
    assert {k: v for k, v in checks.items()
            if tuple(v[0]) != tuple(v[1])} == {}
    assert smoke.POD_MEMBER_BYTES[ARCH] == {
        n: MEMBERS[8][n] for n in (2, 4)} | {1: (SIZES[8][1],
                                                 SIZES[8][2] + 28)}


def _reduced_run():
    model = build_model(get_config(ARCH, reduced=True))
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 256, (1, 20),
                           generator=torch.Generator().manual_seed(1))
    return model, lambda: model.prefill(params, tokens, max_len=32)[0]


def test_routed_as_takes_the_recorded_experts():
    """``chip_smoke.routed_as`` runs a model with every routing call's
    experts replaced by a record's, call for call: with the run's own
    record it changes no bit; with one token-layer's experts changed,
    the run routes that token to them and its logits move."""
    smoke = _smoke()
    model, run = _reduced_run()
    record, logits = smoke.pod_routes(model.cfg, run)
    assert torch.equal(smoke.routed_as(record, run), logits)
    other = [(e.clone(), g) for e, g in record]
    mine = other[1][0][-1].tolist()
    other[1][0][-1] = torch.tensor([x for x in range(4) if x not in mine])
    calls, moved = smoke.routed_as(
        other, lambda: smoke.pod_routes(model.cfg, run))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(calls, other))
    assert not torch.equal(moved, logits)


def test_routing_ties_allows_flips_at_near_ties_only():
    """``chip_smoke.routing_ties`` passes a run's own routing, counts a
    flip where the reference's top-k margin is within twice the row's
    gate deviation, names a prompt whose last row flipped, and raises on
    a flip above such a margin."""
    smoke = _smoke()
    model, run = _reduced_run()
    cfg = model.cfg
    record, _ = smoke.pod_routes(cfg, run)
    calls = record[:cfg.n_layers] * 2  # one prefill and a "round"
    text, last = smoke.routing_ties("own", cfg, calls, calls, 1)
    assert "0 flips" in text and last == set()
    e, g = calls[0]
    k = cfg.top_k
    order = g[-1].argsort(descending=True)
    swapped = e.clone()
    swapped[-1, k - 1] = order[k]  # the last row takes its (k+1)-th
    near = g.clone()
    near[-1, order[k]] = near[-1, order[k - 1]]  # a tie: margin 0
    tied = [(swapped, near)] + calls[1:]
    text, last = smoke.routing_ties("tie", cfg, [(e, near)] + calls[1:],
                                    tied, 1)
    assert "1 flips" in text and last == {0}
    with pytest.raises(AssertionError, match="routes other experts"):
        smoke.routing_ties("far", cfg, calls, [(swapped, g)] + calls[1:], 1)


def test_routed_as_within_pod_routes_records_the_runs_own_choices():
    """``pod_routes`` around ``routed_as`` records, at each routing call,
    the experts the run would have taken by its own gates, while it
    takes the imposed ones: its own record where the imposed experts
    are its own, and the same where one token-layer's are changed,
    though the logits move."""
    smoke = _smoke()
    model, run = _reduced_run()
    record, logits = smoke.pod_routes(model.cfg, run)
    own, same = smoke.pod_routes(model.cfg,
                                 lambda: smoke.routed_as(record, run))
    assert torch.equal(same, logits)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(own, record))
    other = [(e.clone(), g) for e, g in record]
    mine = other[1][0][-1].tolist()
    other[1][0][-1] = torch.tensor([x for x in range(4) if x not in mine])
    own, moved = smoke.pod_routes(model.cfg,
                                  lambda: smoke.routed_as(other, run))
    assert not torch.equal(moved, logits)
    assert torch.equal(own[1][0], record[1][0])


def test_routing_ties_bounds_the_gate_deviation():
    """``chip_smoke.routing_ties`` logs the largest gate deviation and
    raises where a row's gates move from the reference's by more than
    ``GATE_TOL``, the experts unchanged."""
    smoke = _smoke()
    model, run = _reduced_run()
    cfg = model.cfg
    record, _ = smoke.pod_routes(cfg, run)
    calls = record[:cfg.n_layers] * 2
    e, g = calls[0]
    near = g.clone()
    near[0] += smoke.GATE_TOL / 2
    text, _ = smoke.routing_ties("within", cfg, calls,
                                 [(e, near)] + calls[1:], 1)
    assert f"gates within {smoke.GATE_TOL / 2:.4g}" in text
    far = g.clone()
    far[0] += 2 * smoke.GATE_TOL
    with pytest.raises(AssertionError, match="limit"):
        smoke.routing_ties("far", cfg, calls, [(e, far)] + calls[1:], 1)


@pytest.mark.parametrize("n_exempt,ok", [(1, True), (2, False)])
def test_held_against_caps_the_exempt_prompts(n_exempt, ok):
    """``chip_smoke.held_against`` frees the first tokens of at most
    ``1 - MIN_KEPT`` of the prompts (their last rows routed otherwise at
    a near-tie): 1 of 4 passes, 2 of 4 raise."""
    smoke = _smoke()
    gen = torch.Generator().manual_seed(3)
    pre, rnd = torch.randn(4, 64, generator=gen), torch.randn(4, 64,
                                                              generator=gen)
    ref = dict(pre=pre, rnd=rnd, first=pre.argmax(-1).tolist())
    first = [(t + 1) % 64 for t in ref["first"][:n_exempt]] + ref[
        "first"][n_exempt:]
    call = lambda: smoke.held_against(  # noqa: E731
        "exempt", ref, first, pre, rnd, exempt=frozenset(range(n_exempt)))
    if ok:
        assert f"{4 - n_exempt}/4 requests" in call()
    else:
        with pytest.raises(AssertionError, match="exempt"):
            call()


@pytest.mark.parametrize("served", ["windowed", "windowless", "a key short",
                                    "a key long"])
def test_window_probe_sees_the_window(served):
    """The kernel phase's inputs at mixtral's prefill past its window
    (4160 rows, 32 q / 8 kv of 128, window 4096) make ``window_probe``
    pass the windowed plain version's rows past the window and fail the
    windowless version's and those whose window is a key short or long,
    each of which would also fail ``close`` against the windowed
    version."""
    from repro_torch.kernels import flash_attention as fa
    smoke = _smoke()
    window = 4096
    q, k, v = smoke.window_inputs("cpu", window=window)
    w = {"windowed": window, "windowless": None, "a key short": window - 1,
         "a key long": window + 1}[served]
    out = torch.zeros_like(q)
    out[:, window:] = fa.flash_attention_plain(q[:, window:], k, v,
                                               window=w, q_offset=window)
    if served == "windowed":
        assert "rows 4096-4159 each within" in smoke.window_probe(
            "cpu", q, k, v, window, out)
        return
    with pytest.raises(AssertionError, match="flash cpu: rows 4096-4159"):
        smoke.window_probe("cpu", q, k, v, window, out)
    with pytest.raises(AssertionError):
        smoke.close("cpu", out[:, window:], fa.flash_attention_plain(
            q[:, window:], k, v, window=window, q_offset=window))


def test_window_probe_reads_every_prefill_flash_call():
    """``chip_smoke._WindowProbe`` reads each flash call of a prefill past
    the reduced mixtral's window of 16, one a layer, on the CPU's plain
    versions: the windowless version differs there, the windowed one
    not at all; it fails where fewer calls were probed than expected."""
    smoke = _smoke()
    model = build_model(get_config(ARCH, reduced=True))
    params = model.init(torch.Generator().manual_seed(0))
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(2))
    with smoke._WindowProbe(cfg.sliding_window) as probe:
        model.prefill(params, tokens, max_len=64)
    text = probe.report(cfg.n_layers)
    assert f"in each of the {cfg.n_layers} flash calls" in text
    assert "within 0 of the windowed" in text
    assert all(c[3] > 0 for c in probe.calls)
    with pytest.raises(AssertionError, match="expected"):
        probe.report(cfg.n_layers + 1)
