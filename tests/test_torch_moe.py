"""The MoE family in the port (``repro_torch.models.moe`` under the
transformer, the engine and speculation) against the JAX package on the
CPU: qwen2-moe-a2.7b (routed plus shared experts) and mixtral-8x7b (a
sliding window on every layer) at their reduced sizes, and a tiny MoE of
4 experts at capacity factor 0.5, whose bucketed prefills and verify
windows drop pairs.

Both packages run f32 params (the JAX tree bridged with
``repro_torch.bridge``) on the same inputs, drawn with numpy from a seed;
the port runs its plain versions.  Tolerances, each with its reason:
* ``moe_apply`` and its aux loss: 2e-5, ``tests/test_kernels.py``'s f32
  tolerance (the same products, summed in another order);
* verify logits: 1e-4 against JAX's on the same bf16 cache and 1e-5
  against sequential decode steps, as ``tests/test_torch_speculative.py``;
* routing (``top_e``, ``dest``, ``keep``): exact, as integers;
* prefill logits: 2e-5; decode logits: 1e-3, as
  ``tests/test_torch_dense_configs.py`` (the K/V pools are bf16 in both
  packages, and a row whose f32 value differs by an ulp can round to the
  neighbouring bf16 value);
* engine streams, speculation counts and byte accounting: exact.
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
from repro.models import moe as jmoe
from repro.serving import ServingEngine as JaxEngine
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ServingEngine
from repro_torch.serving.speculative import SpecConfig

torch.set_num_threads(2)

FULL = dict(sm=1.0, quota_request=0.9, quota_limit=0.9)
ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x7b")
# The tight-capacity tiny MoE: a bucket of 16 tokens (32 pairs over 4
# experts) gets 8 rows an expert, a verify window of 4 slots x 5 rows
# (40 pairs) 8 too.
TIGHT = dict(name="tiny-moe-tight", family="moe", n_experts=4, top_k=2,
             moe_cf_eval=0.5)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


_PAIRS = {}


def _pair(jcfg):
    """(JAX model, f32 JAX params, port model, bridged params) of a JAX
    config, built once per config."""
    if jcfg not in _PAIRS:
        jm = jax_build(jcfg)
        jp = _f32(jm.init(jax.random.key(7)))
        tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
        _PAIRS[jcfg] = (jm, jp, tm, bridge.to_torch(jax.device_get(jp)))
    return _PAIRS[jcfg]


def _layer0(params):
    """Layer 0's expert block of a bridged or JAX tree."""
    return jax.tree_util.tree_map(lambda a: a[0], params["layers"]["moe"])


def _jax_routing(router, xt, cfg, cap):
    """JAX's dispatch indices, moe.py:196-216 line for line, turned from
    its expert-sorted pair order into token-major order: (top_e, dest,
    keep) as numpy."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    gates = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
    _, top_e = jax.lax.top_k(gates, k)
    pair_e = top_e.reshape(-1)
    order = jnp.argsort(pair_e, stable=True)
    pe = pair_e[order]
    counts = jnp.zeros((e,), jnp.int32).at[pe].add(1)
    offsets = jnp.cumsum(counts) - counts
    within = jnp.arange(t * k) - offsets[pe]
    keep = within < cap
    dest = jnp.where(keep, pe * cap + within, e * cap)
    dest_tm = np.empty(t * k, np.int64)
    keep_tm = np.empty(t * k, bool)
    dest_tm[np.asarray(order)] = np.asarray(dest)
    keep_tm[np.asarray(order)] = np.asarray(keep)
    return np.asarray(top_e), dest_tm, keep_tm


def _check_routing(tlp, jlp, x, cfg, cf):
    """The port's routing of ``x`` (B, S, D) equals JAX's as integers;
    returns the number of dropped pairs."""
    xt = x.reshape(-1, x.shape[-1])
    cap = tmoe._capacity(xt.shape[0], cfg, cf)
    assert cap == jmoe._capacity(xt.shape[0], cfg, cf)
    r = tmoe.route(tlp["router"], torch.from_numpy(xt), cfg, cap)
    top_e, dest, keep = _jax_routing(jlp["router"], jnp.asarray(xt), cfg,
                                     cap)
    np.testing.assert_array_equal(r["top_e"].numpy(), top_e)
    np.testing.assert_array_equal(r["dest"].numpy(), dest)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    return int((~keep).sum())


def _check_apply(tlp, jlp, x, cfg, cf):
    jy, jaux = jmoe.moe_apply(jlp, jnp.asarray(x), cfg, capacity_factor=cf)
    ty, taux = tmoe.moe_apply(tlp, torch.from_numpy(x), cfg, cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=2e-5,
                               atol=2e-5)


# -- the expert block ------------------------------------------------------


def test_specs_match_jax():
    """The expert block's leaves, shapes and dtypes equal JAX's: an f32
    router, bf16 experts, the shared experts only where configured."""
    for arch in ARCHS:
        jcfg = jax_config(arch, reduced=True)
        jspecs = jmoe.moe_specs(jcfg)
        tspecs = tmoe.moe_specs(ModelConfig(**dataclasses.asdict(jcfg)))
        flat = lambda t, p="": (  # noqa: E731
            {k2: v2 for k, v in t.items() for k2, v2 in flat(v, p + k + ".")
             .items()} if isinstance(t, dict) else {p[:-1]: t})
        jflat, tflat = flat(jspecs), flat(tspecs)
        assert set(jflat) == set(tflat)
        assert ("shared.gate" in tflat) == bool(jcfg.n_shared_experts)
        for key, js in jflat.items():
            ts = tflat[key]
            assert ts.shape == js.shape and ts.init == js.init, key
            assert str(ts.dtype).split(".")[-1] == np.dtype(js.dtype).name


@pytest.mark.parametrize("cf", [0.5, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, cf):
    """``moe_apply`` and its aux loss against JAX's single-device path at
    a capacity factor that drops pairs (0.5) and one that drops none, on
    layer 0 of the reduced config; the routing equals JAX's as integers."""
    jm, jp, tm, tp = _pair(jax_config(arch, reduced=True))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, tm.cfg.d_model)).astype(np.float32)
    dropped = _check_routing(_layer0(tp), _layer0(jp), x, tm.cfg, cf)
    assert (dropped > 0) == (cf < 1)
    _check_apply(_layer0(tp), _layer0(jp), x, tm.cfg, cf)


def test_dispatch_under_overflow_matches_jax():
    """T = 64 tokens at capacity factor 0.5 (9 rows an expert for 128
    pairs over 8 experts): ``dest`` and ``keep`` equal JAX's as integers,
    with pairs dropped, and the outputs agree."""
    jm, jp, tm, tp = _pair(jax_config("qwen2-moe-a2.7b", reduced=True))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 64, tm.cfg.d_model)).astype(np.float32)
    assert tmoe._capacity(64, tm.cfg, 0.5) == 9
    assert _check_routing(_layer0(tp), _layer0(jp), x, tm.cfg, 0.5) > 0
    _check_apply(_layer0(tp), _layer0(jp), x, tm.cfg, 0.5)


@pytest.mark.parametrize("case", ["all-equal", "boundary"])
def test_ties_pick_jax_experts(case):
    """Equal gates go to the lower expert index first, as
    ``jax.lax.top_k`` orders them.  ``all-equal``: a zero router, so every
    token picks experts 0 and 1 and the buckets overflow.  ``boundary``:
    expert 2 always first and experts 1 and 3 tied for second, so JAX
    takes 1."""
    jm, jp, tm, tp = _pair(jax_config("qwen2-moe-a2.7b", reduced=True))
    cfg = tm.cfg
    rng = np.random.default_rng(9)
    x = np.abs(rng.standard_normal((1, 24, cfg.d_model))).astype(np.float32)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    if case == "boundary":
        router[:] = 1.0 / cfg.d_model
        router[:, 2] = 3.0 / cfg.d_model
        router[:, 1] = router[:, 3] = 2.0 / cfg.d_model
    jlp = dict(_layer0(jp), router=jnp.asarray(router))
    tlp = dict(_layer0(tp), router=torch.from_numpy(router))
    _check_routing(tlp, jlp, x, cfg, cfg.moe_cf_eval)
    cap = tmoe._capacity(24, cfg, cfg.moe_cf_eval)
    r = tmoe.route(tlp["router"], torch.from_numpy(x[0]), cfg, cap)
    want = [0, 1] if case == "all-equal" else [2, 1]
    assert (r["top_e"] == torch.tensor(want)).all()
    _check_apply(tlp, jlp, x, cfg, cfg.moe_cf_eval)
    if case == "all-equal":
        _check_routing(tlp, jlp, x, cfg, 0.5)  # cap 8 of 24: drops
        _check_apply(tlp, jlp, x, cfg, 0.5)


# -- prefill and decode ------------------------------------------------------


MAX_LEN = 32


@pytest.mark.parametrize("arch,n_prompt", [("qwen2-moe-a2.7b", 11),
                                           ("mixtral-8x7b", 11),
                                           ("mixtral-8x7b", 21)])
def test_prefill_and_decode_match_jax(arch, n_prompt):
    """Prefill logits and three decode steps on slot 1 of a two-slot pool
    (slot 0 free) against JAX; mixtral's prompt of 21 passes its window of
    16, and its cache is rolled."""
    jm, jp, tm, tp = _pair(jax_config(arch, reduced=True))
    rng = np.random.default_rng(n_prompt)
    toks = rng.integers(0, tm.cfg.vocab_size, (1, n_prompt)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len=MAX_LEN))(
        jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    assert set(tc) == set(jc) == {"k", "v", "pos"}
    assert tc["k"].shape[2] == (16 if tm.cfg.sliding_window else MAX_LEN)
    jpool = jm.merge_slot(jm.init_slot_cache(2, MAX_LEN), jc, jnp.int32(1))
    tpool = tm.merge_slot(tm.init_slot_cache(2, MAX_LEN, "cpu"), tc, 1)
    jtok = jnp.zeros((2,), jnp.int32).at[1].set(jm.sample_greedy(jl)[0])
    ttok = torch.zeros(2, dtype=torch.int32)
    ttok[1] = tm.sample_greedy(tl)[0]
    step = jax.jit(jm.decode_step)
    for _ in range(3):
        jl, jpool = step(jp, jtok, jpool)
        tl, tpool = tm.decode_step(tp, ttok, tpool)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-3)
        jtok, ttok = jm.sample_greedy(jl), tm.sample_greedy(tl)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


# -- the engine -------------------------------------------------------------


MIXED = [(4, 3), (12, 6), (7, 2), (20, 5), (5, 4), (16, 6), (3, 1)]
# Past mixtral-smoke's window of 16 at prefill and in decode.
LONG = [(21, 6), (9, 8), (30, 4), (17, 7), (12, 3)]


def _arrivals(spec, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, l, dtype=np.int32), n) for l, n in spec]


def _serve(side, model, params, batching, arrivals, **kw):
    if side == "jax":
        eng = JaxEngine(window=0.1)
        eng.deploy("f", model, params, JaxAlloc(**FULL), batching=batching,
                   prefix_sharing=False, **kw)
    else:
        eng = ServingEngine(window=0.1, device="cpu")
        eng.deploy("f", model, params, Alloc(**FULL), batching=batching,
                   **kw)
    reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    assert eng.pump(budget_s=300.0) == len(reqs)
    assert all(r.done and len(r.tokens_out) == r.max_new_tokens
               for r in reqs)
    return [list(r.tokens_out) for r in reqs], eng


@pytest.fixture
def drops(monkeypatch):
    """Counts the pairs each port routing drops, by its token count."""
    seen = {}
    route = tmoe.route

    def counting(router, xt, cfg, cap):
        r = route(router, xt, cfg, cap)
        t = xt.shape[0]
        seen[t] = seen.get(t, 0) + int((~r["keep"]).sum())
        return r

    monkeypatch.setattr(tmoe, "route", counting)
    return seen


def _jcfg(case):
    if case == "tight":
        return tiny_config(**TIGHT)
    arch, _ = case.split("/")
    return jax_config(arch, reduced=True)


ENGINE_CASES = [("qwen2-moe-a2.7b/", "continuous", False),
                ("qwen2-moe-a2.7b/", "paged", False),
                ("qwen2-moe-a2.7b/", "continuous", True),
                ("qwen2-moe-a2.7b/", "paged", True),
                ("mixtral-8x7b/", "continuous", False),
                ("tight", "continuous", False),
                ("tight", "paged", False)]


@pytest.mark.parametrize(
    "case,batching,int8", ENGINE_CASES,
    ids=[f"{c.strip('/')}-{'int8-' if q else ''}{b}"
         for c, b, q in ENGINE_CASES])
def test_engine_streams_match_jax(monkeypatch, drops, case, batching, int8):
    """Greedy streams of the port's engine equal the JAX engine's on the
    same arrivals, one sync a pass, and equal a ``fused=False`` engine's.
    mixtral prefills at the exact length on its rolled cache; the others
    pad to power-of-two buckets, and the tight MoE drops pairs there."""
    jcfg = _jcfg(case)
    if int8:
        monkeypatch.setenv("REPRO_KV_INT8", "1")
        jcfg = dataclasses.replace(jcfg, name=f"{jcfg.name}-int8-engine")
    jm, jp, tm, tp = _pair(jcfg)
    arrivals = _arrivals(LONG if tm.cfg.sliding_window else MIXED)
    kw = dict(n_instances=2, max_batch=2, max_len=48 if
              tm.cfg.sliding_window else 32, block_size=8)
    jstreams, _ = _serve("jax", jm, jp, batching, arrivals, **kw)
    tstreams, eng = _serve("torch", tm, tp, batching, arrivals, **kw)
    assert tstreams == jstreams
    for inst in eng.instances.values():
        assert inst.sync_count == inst.steps > 0
        assert inst.kv_int8 == int8
        assert inst.bucketed == (not tm.cfg.sliding_window)
    if case == "tight":
        assert drops.get(16, 0) > 0, drops  # a 16-token bucket overflows
    host, _ = _serve("torch", tm, tp, batching, arrivals, fused=False, **kw)
    assert host == tstreams


SPEC_CASES = [("qwen2-moe-a2.7b/", "continuous", 2),
              ("qwen2-moe-a2.7b/", "paged", 2),
              ("tight", "continuous", 4),
              ("tight", "paged", 4)]


@pytest.mark.parametrize(
    "case,batching,max_batch", SPEC_CASES,
    ids=[f"{c.strip('/')}-{b}" for c, b, _ in SPEC_CASES])
def test_speculating_streams_match_jax(drops, case, batching, max_batch):
    """Speculating with k = 4: the port's greedy streams and its proposal
    and acceptance counts equal the JAX engine's speculating run.  qwen2-
    moe drafts with its own weights (every proposal accepted); the tight
    MoE with another init (rejections and rollbacks), and a verify window
    of 4 slots x 5 rows drops pairs there, so the streams are held against
    JAX's speculating streams, not spec off."""
    jcfg = _jcfg(case)
    jm, jp, tm, tp = _pair(jcfg)
    jd, td = jp, tp
    if case == "tight":
        jd = _f32(jm.init(jax.random.key(999)))
        td = bridge.to_torch(jax.device_get(jd))
    rng = np.random.default_rng(2)
    arrivals = [(rng.integers(0, 64, int(n), dtype=np.int32), 9)
                for n in rng.integers(3, 14, 2 * max_batch)]
    kw = dict(n_instances=1, max_batch=max_batch, max_len=64, block_size=8)
    out = {}
    for side, m, p, d, spec in (("jax", jm, jp, jd, JaxSpecConfig),
                                ("torch", tm, tp, td, SpecConfig)):
        streams, eng = _serve(side, m, p, batching, arrivals,
                              speculate=spec(draft_cfg=m.cfg, k=4),
                              draft_params=d, **kw)
        (tele,) = eng.telemetry().values()
        out[side] = (streams, tele["spec_proposed"], tele["spec_accepted"])
    assert out["torch"] == out["jax"]
    _, proposed, accepted = out["torch"]
    assert proposed > 0
    if case == "tight":
        assert accepted < proposed
        assert drops.get(4 * 5, 0) > 0, drops
    else:
        assert accepted == proposed


@pytest.mark.parametrize("case", ["qwen2-moe-a2.7b/", "tight"])
def test_verify_step_equals_jax_and_sequential_decode(drops, case):
    """The k + 1 verify forward's logits against JAX's verify step on the
    same bf16 cache, and, where no pair is dropped (qwen2-moe-smoke,
    whose capacity factor 8 keeps every pair), against k + 1 sequential
    decode steps on a copy.  The tight MoE's window of 4 slots x 5 rows
    drops pairs, in both packages alike."""
    jm, jp, tm, tp = _pair(_jcfg(case))
    b, w = (2, 4) if case != "tight" else (4, 5)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, 64, (b, 5)).astype(np.int32)
    window = rng.integers(0, 64, (b, w)).astype(np.int32)
    _, entry = tm.prefill(tp, torch.from_numpy(prompts), max_len=32)
    pos = np.full((b,), 5, np.int32)
    cache = {key: v.clone() for key, v in entry.items()}
    cache["pos"] = torch.from_numpy(pos)
    jcache = {key: jnp.asarray(bridge.to_numpy(v)).astype(jnp.bfloat16)
              for key, v in entry.items() if key != "pos"}
    jcache["pos"] = jnp.asarray(pos)
    drops.clear()
    got, _ = tm.verify_step(tp, torch.from_numpy(window), cache)
    want, _ = jm.verify_step(jp, jnp.asarray(window), jcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    if case == "tight":
        assert drops.get(b * w, 0) > 0, drops
        return
    assert not any(drops.values())
    seq = {key: v.clone() for key, v in entry.items()}
    seq["pos"] = torch.from_numpy(pos)
    for j in range(w):
        logits, seq = tm.decode_step(tp, torch.from_numpy(window[:, j]), seq)
        np.testing.assert_allclose(got[:, j].numpy(), logits.numpy(),
                                   atol=1e-5, rtol=1e-5)


# -- builds and accounting at full width (no allocation) ---------------------


def _spec_bytes(tree):
    if isinstance(tree, dict):
        return sum(_spec_bytes(v) for v in tree.values())
    return int(np.prod(tree.shape)) * tree.dtype.itemsize


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_accounting_matches_jax(arch):
    """Parameters, weight bytes (the f32 router included) and KV bytes of
    the full-width config equal JAX's, from the specs alone; qwen2-moe's
    equal the constants the card's smoke asserts.  The config's analytic
    ``param_count`` equals JAX's too, short of the shared gate."""
    jm, tm = jax_build(jax_config(arch)), build_model(get_config(arch))
    assert tm.n_params() == jm.n_params()
    # The analytic count leaves out the shared experts' gate (d a layer).
    assert tm.cfg.param_count() == jm.cfg.param_count() == tm.n_params() - (
        tm.cfg.n_layers * tm.cfg.d_model if tm.cfg.n_shared_experts else 0)
    jbytes = sum(int(np.prod(l.shape)) * l.dtype.itemsize for l in
                 jax.tree_util.tree_leaves(jm.abstract_params()))
    assert _spec_bytes(tm.specs) == jbytes
    assert tm.specs["layers"]["moe"]["router"].dtype == torch.float32
    for batch, max_len in ((8, 1024), (3, 100)):
        assert tm.dense_kv_bytes(batch, max_len) == \
            jm.dense_kv_bytes(batch, max_len)
    assert tm.supports_paged() == jm.supports_paged() == \
        (arch == "qwen2-moe-a2.7b")
    if arch == "qwen2-moe-a2.7b":
        assert tm.kv_block_bytes(16) == jm.kv_block_bytes(16)
        assert (tm.n_params(), jbytes, tm.dense_kv_bytes(8, 1024)) == (
            14_315_784_192, 28_637_466_624, 1_610_612_740)
        assert tm.supports_speculative() and tm.supports_bucketed_prefill()
    else:
        assert not tm.supports_bucketed_prefill()


def test_router_draws_f32_and_stages_bit_for_bit():
    """``init`` draws the router in f32 and every other leaf in bf16; the
    fleet store's staging and upload keep the f32 leaf bit for bit."""
    from repro_torch.serving.modelstore import stage_params, upload_params

    tm = build_model(get_config("qwen2-moe-a2.7b", reduced=True))
    params = tm.init(torch.Generator().manual_seed(0))
    moe = params["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["router"].float().std() > 0
    assert moe["w_gate"].dtype == moe["shared"]["gate"].dtype == \
        torch.bfloat16
    back, _ = upload_params(stage_params(tm, params), mode="blocking",
                            device="cpu")
    for key in ("router", "w_down"):
        assert back["layers"]["moe"][key].dtype == moe[key].dtype
        assert torch.equal(back["layers"]["moe"][key], moe[key])
