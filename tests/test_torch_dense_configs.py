"""The dense family's other configurations in the port against the JAX
package: the GELU (with biases) and GeGLU MLPs, starcoder2-15b,
gemma3-27b (local:global interleave on dual caches: rolled ``k``/``v``
for every layer plus full-length ``global_k``/``global_v`` for the global
layers) and qwen1.5-110b.

Prefill and decode logits and cache leaves, engine streams in every
mode each config serves (and through ``ClusterFrontend``), sampled and
migrated gemma3 streams, the refusals, and the full configs' parameter
and KV byte counts.  The reduced configs run in f32 on both sides, with
the JAX tree bridged (``repro_torch.bridge``); inputs are drawn with
numpy from a seed.
Tolerances, each with its reason:
* MLPs: 1e-6 (f32, the same tanh GELU; sums in another order);
* prefill logits: 2e-5, ``tests/test_kernels.py``'s f32 tolerance
  (prefill logits do not read the bf16 cache);
* decode logits: 1e-3, as ``tests/test_torch_model.py`` — the K/V pools
  are bf16 in both packages, and a K/V row whose f32 value differs by an
  ulp can round to neighbouring bf16 values;
* cache leaves: relative 1e-2 (one bf16 ulp) after prefill, for the
  same reason; after decode steps also absolute 1e-3, the decode logits'
  tolerance: a row that rounded to the neighbouring bf16 value moves
  the next layers' inputs, and so the rows they write;
* engine streams, counts and byte accounting: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.resources import Alloc as JaxAlloc
from repro.models import build_model as jax_build
from repro.models import layers as jlayers
from repro.serving import ClusterFrontend as JaxFrontend
from repro.serving import ServingEngine as JaxEngine
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ClusterFrontend, ServingEngine
from repro_torch.serving.speculative import SamplingConfig, SpecConfig

torch.set_num_threads(2)

FULL = dict(sm=1.0, quota_request=0.9, quota_limit=0.9)
ARCHS = ("starcoder2-15b", "gemma3-27b", "qwen1.5-110b")
# The arrivals of tests/test_torch_engine.py: prompts of 3-20 tokens, so
# gemma3's reduced window of 8 is passed at prefill and in decode.
MIXED = [(4, 3), (12, 6), (7, 2), (20, 5), (5, 4), (16, 6), (3, 1)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jcfg(arch, **over):
    cfg = jax_config(arch, reduced=True)
    return dataclasses.replace(cfg, **over) if over else cfg


_PAIRS = {}


def _pair(arch, **over):
    """(JAX model, f32 JAX params, port model, bridged params) of a reduced
    config, built once per config."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _PAIRS:
        jcfg = _jcfg(arch, **over)
        jm = jax_build(jcfg)
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                    jm.init(jax.random.key(7)))
        tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
        _PAIRS[key] = (jm, jp, tm, bridge.to_torch(jax.device_get(jp)))
    return _PAIRS[key]


# -- MLPs -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gelu", "geglu", "swiglu"])
def test_mlp_matches_jax(kind):
    """Leaves, shapes and init kinds equal JAX's; the f32 output within
    1e-6, biases nonzero so they are checked too."""
    d, f = 48, 80
    jspecs = jlayers.mlp_specs(d, f, kind)
    tspecs = tlayers.mlp_specs(d, f, kind)
    assert {k: (s.shape, s.init) for k, s in tspecs.items()} == \
        {k: (s.shape, s.init) for k, s in jspecs.items()}
    rng = np.random.default_rng(11)
    # At the init's scale (std 1/sqrt(fan_in)), biases 0.1: outputs of
    # order 1, so 1e-6 is a few f32 ulps of them.
    params = {k: (rng.standard_normal(s.shape)
                  * (s.shape[0] ** -0.5 if len(s.shape) == 2 else 0.1)
                  ).astype(np.float32) for k, s in jspecs.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), kind)
    got = tlayers.mlp_apply(bridge.to_torch(params), torch.from_numpy(x),
                            kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# -- prefill and decode -------------------------------------------------------


CASES = {"starcoder2": ("starcoder2-15b", {}, 11),
         "qwen1.5": ("qwen1.5-110b", {}, 11),
         "gemma3-short": ("gemma3-27b", {}, 5),
         "gemma3-long": ("gemma3-27b", {}, 13),
         "gemma3-hd32-short": ("gemma3-27b", {"head_dim": 32}, 5),
         "gemma3-hd32-long": ("gemma3-27b", {"head_dim": 32}, 13)}
MAX_LEN = 32


def _check_caches(tpool, jpool, keys, atol=1e-6):
    for key in keys:
        assert tpool[key].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tpool[key]), _np(jpool[key]),
                                   rtol=1e-2, atol=atol, err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    """Prefill logits and three decode steps on slot 1 of a two-slot pool
    (slot 0 free, its position running on) against JAX.  For gemma3 (window
    8, two global layers of six) prompts of 5 and 13 tokens sit below and
    past the window, and the four cache leaves equal JAX's after prefill
    and after every step; the ``head_dim=32`` variant has q_dim 128 !=
    d_model 64."""
    arch, over, n_prompt = CASES[case]
    jm, jp, tm, tp = _pair(arch, **over)
    cfg = tm.cfg
    if "hd32" in case:
        assert cfg.q_dim != cfg.d_model
    rng = np.random.default_rng(n_prompt)
    toks = rng.integers(0, cfg.vocab_size, (1, n_prompt)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len=MAX_LEN))(
        jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    assert set(tc) == set(jc) and int(tc["pos"]) == int(jc["pos"])
    leaves = sorted(set(tc) - {"pos"})
    if cfg.sliding_window:
        assert leaves == ["global_k", "global_v", "k", "v"]
        assert tc["k"].shape[2] == 8 and tc["global_k"].shape[:3] == \
            (2, 1, MAX_LEN)
        assert jc["global_k"].dtype == jnp.bfloat16
    _check_caches(tc, jc, leaves)
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
        _check_caches(tpool, jpool, leaves, atol=1e-3)
    np.testing.assert_array_equal(tpool["pos"].numpy(),
                                  np.asarray(jpool["pos"]))


def test_gemma3_layout_and_refusals(monkeypatch):
    """gemma3's layer pattern, the tied and scaled embedding, the gather /
    merge round trip of every leaf, and what stays refused: ``length=``
    (a rolled cache folds pad rows into real ones), paged pools and int8
    KV on rolled caches."""
    jm, _, tm, tp = _pair("gemma3-27b")
    cfg = tm.cfg
    assert ttr.global_slots(cfg) == [None, None, 0, None, None, 1]
    assert ttr.n_global_layers(cfg) == 2 and "head" not in tp
    assert tm.supports_speculative() is False
    assert not tm.supports_paged() and not tm.supports_bucketed_prefill()
    tok = torch.tensor([[3, 7]], dtype=torch.int32)
    emb = ttr.embed_tokens(tp, tok, cfg)
    torch.testing.assert_close(emb, tp["embed"][tok.long()] * 8.0,
                               rtol=0, atol=0)  # sqrt(64)
    with pytest.raises(NotImplementedError, match="non-windowed"):
        tm.prefill(tp, torch.zeros((1, 8), dtype=torch.int32), length=5)
    with pytest.raises(NotImplementedError):
        tm.init_paged_cache(4, 8, "cpu")
    with pytest.raises(ValueError, match="int8"):
        tm.init_slot_cache(2, 16, "cpu", kv_int8=True)
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    assert not tm.kv_int8()
    _, entry = tm.prefill(tp, torch.arange(11, dtype=torch.int32)[None],
                          max_len=16)
    pool = tm.init_slot_cache(3, 16, "cpu")
    assert set(pool) == set(entry) == {"k", "v", "global_k", "global_v",
                                       "pos"}
    back = tm.gather_slot(tm.merge_slot(pool, entry, 2), 2)
    for key in entry:
        torch.testing.assert_close(back[key], entry[key], rtol=0, atol=0)
    assert not pool["global_k"][:, :2].any() and not pool["k"][:, :2].any()


# -- the engine -----------------------------------------------------------------


def _arrivals(spec=MIXED, seed=0):
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


ENGINE_CASES = [("starcoder2-15b", "continuous", False, 2),
                ("starcoder2-15b", "paged", False, 2),
                ("starcoder2-15b", "continuous", True, 2),
                ("starcoder2-15b", "paged", True, 2),
                ("gemma3-27b", "continuous", False, 1),
                ("gemma3-27b", "continuous", False, 2),
                ("qwen1.5-110b", "continuous", False, 2),
                ("qwen1.5-110b", "paged", False, 2)]


@pytest.mark.parametrize(
    "arch,batching,int8,n_instances", ENGINE_CASES,
    ids=[f"{a}-{'int8-' if q else ''}{b}-{n}" for a, b, q, n in ENGINE_CASES])
def test_engine_streams_match_jax(monkeypatch, arch, batching, int8,
                                  n_instances):
    """Greedy streams of the port's engine equal the JAX engine's on the
    same arrivals; the fused rounds sync once a pass and equal a
    ``fused=False`` engine's streams.  Under the int8 gate both serve
    from int8 pools (the port's instance pins the gate at deploy)."""
    if int8:
        monkeypatch.setenv("REPRO_KV_INT8", "1")
        jcfg = dataclasses.replace(_jcfg(arch), name=f"{arch}-int8-engine")
        jm = jax_build(jcfg)
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                    jm.init(jax.random.key(7)))
        tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
        tp = bridge.to_torch(jax.device_get(jp))
    else:
        jm, jp, tm, tp = _pair(arch)
    arrivals = _arrivals()
    kw = dict(n_instances=n_instances, max_batch=2, max_len=32,
              block_size=8)
    jstreams, _ = _serve("jax", jm, jp, batching, arrivals, **kw)
    tstreams, eng = _serve("torch", tm, tp, batching, arrivals, **kw)
    assert tstreams == jstreams
    for inst in eng.instances.values():
        assert inst.sync_count == inst.steps > 0
        assert inst.kv_int8 == int8
        if tm.cfg.sliding_window:
            assert not inst.bucketed
            assert set(inst.cache) == {"k", "v", "global_k", "global_v",
                                       "pos"}
    host, _ = _serve("torch", tm, tp, batching, arrivals, fused=False, **kw)
    assert host == tstreams


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_starcoder2_speculating_draft_equals_target(batching):
    """starcoder2 (GELU) speculating with k = 3 and its own weights as the
    draft: acceptance 1.0, and the greedy streams equal the JAX engine's
    without speculation."""
    jm, jp, tm, tp = _pair("starcoder2-15b")
    arrivals = _arrivals([(6, 9), (11, 9), (4, 9)], seed=2)
    kw = dict(n_instances=1, max_batch=2, max_len=64, block_size=8)
    jstreams, _ = _serve("jax", jm, jp, batching, arrivals, **kw)
    tstreams, eng = _serve("torch", tm, tp, batching, arrivals,
                           speculate=SpecConfig(draft_cfg=tm.cfg, k=3),
                           draft_params=tp, **kw)
    assert tstreams == jstreams
    (tele,) = eng.telemetry().values()
    assert tele["spec_proposed"] > 0
    assert tele["spec_accepted"] == tele["spec_proposed"]


def test_gemma3_sampled_fused_equals_unfused():
    """Sampled gemma3 (temperature 0.8, top-k 12, top-p 0.9, seed 5): the
    fused rounds' streams equal a ``fused=False`` engine's bit for bit
    (one key stream), with prompts past the window."""
    _, _, tm, tp = _pair("gemma3-27b")
    sampling = SamplingConfig(temperature=0.8, top_k=12, top_p=0.9, seed=5)
    arrivals = _arrivals([(4, 6), (12, 6), (20, 6)], seed=9)
    kw = dict(n_instances=1, max_batch=2, max_len=32, sampling=sampling)
    fused, eng = _serve("torch", tm, tp, "continuous", arrivals, **kw)
    host, _ = _serve("torch", tm, tp, "continuous", arrivals, fused=False,
                     **kw)
    assert fused == host
    (inst,) = eng.instances.values()
    assert inst.sync_count == inst.steps


def test_gemma3_migration_gives_the_unmigrated_streams():
    """Every occupied slot exported after two passes and imported into a
    second engine's instance (all four cache leaves travel), the queue
    moved with it: the streams equal the unmigrated engine's, and the
    JAX engine's."""
    jm, jp, tm, tp = _pair("gemma3-27b")
    arrivals = _arrivals([(12, 6), (20, 7), (5, 4), (9, 5)], seed=3)
    kw = dict(max_batch=2, max_len=32)

    def engine():
        eng = ServingEngine(window=0.1, device="cpu")
        eng.deploy("f", tm, tp, Alloc(**FULL), **kw)
        return eng

    src, dst = engine(), engine()
    reqs = [src.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    (iid, inst), = src.instances.items()
    inst.run_step()
    inst.run_step()
    (tgt,) = dst.instances.values()
    inst.paused = True
    moved = 0
    for slot, req in enumerate(inst.slots):
        if req is not None:
            req_, entry, tok = inst.export_slot(slot)
            assert set(entry) == {"k", "v", "global_k", "global_v", "pos"}
            tgt.import_slot(slot, req_, entry, tok)
            inst.slots[slot] = None
            moved += 1
    assert moved == 2
    tgt.queue.extend(inst.queue)
    inst.queue.clear()
    src.retire(iid)
    dst.pump(budget_s=120.0)
    assert all(r.done for r in reqs)
    unmigrated, _ = _serve("torch", tm, tp, "continuous", arrivals, **kw)
    jstreams, _ = _serve("jax", jm, jp, "continuous", arrivals, **kw)
    assert [list(r.tokens_out) for r in reqs] == unmigrated == jstreams


def _spec_tree(tree):
    """(shape, init) of every leaf of a PSpec tree, in its nesting."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.init)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_context_families_build(arch):
    """The encoder-decoder and vision configs build from the port's
    registry at full width and reduced, with JAX's spec tree: the same
    leaves in the same nesting, of the same shapes and inits."""
    for reduced in (False, True):
        model = build_model(get_config(arch, reduced=reduced))
        jm = jax_build(jax_config(arch, reduced=reduced))
        assert _spec_tree(model.specs) == _spec_tree(jm.specs)
        assert model.n_params() == jm.n_params()
        assert model.needs_ctx()


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b"])
def test_moe_configs_build(arch):
    """The moe configs build at full width and reduced, from the port's
    registry, with the expert block in every layer's specs."""
    for reduced in (False, True):
        model = build_model(get_config(arch, reduced=reduced))
        assert set(model.specs["layers"]) == {"ln1", "attn", "ln2", "moe"}
        assert model.n_params() == jax_build(
            jax_config(arch, reduced=reduced)).n_params()


def test_gemma3_paged_and_speculating_deploys_raise():
    _, _, tm, tp = _pair("gemma3-27b")
    eng = ServingEngine(device="cpu")
    with pytest.raises(ValueError, match="paged"):
        eng.deploy("f", tm, tp, Alloc(**FULL), batching="paged")
    with pytest.raises(ValueError, match="speculat"):
        eng.deploy("f", tm, tp, Alloc(**FULL),
                   speculate=SpecConfig(draft_cfg=tm.cfg, k=2),
                   draft_params=tp)
    assert not eng.instances


@pytest.mark.parametrize("arch,batching", [("starcoder2-15b", "paged"),
                                           ("gemma3-27b", "continuous")])
def test_cluster_frontend_streams_equal_jax(arch, batching):
    """Three instances over two nodes of ``ClusterFrontend``: the same
    placements, JSQ routing, greedy streams and per-node memory charges
    (weights once a node plus each instance's KV reservation, gemma3's
    dual caches included) as JAX's frontend."""
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 64, int(n), dtype=np.int32)
               for n in rng.integers(3, 20, 8)]
    out = {}
    for side, fe, model, params, alloc in (
            ("torch", ClusterFrontend(n_nodes=2, window=0.05, device="cpu"),
             tm, tp, Alloc),
            ("jax", JaxFrontend(n_nodes=2, window=0.05), jm, jp, JaxAlloc)):
        handles = [fe.place_instance("f", model, params,
                                     alloc(sm=sm, quota_request=q,
                                           quota_limit=q),
                                     max_batch=2, max_len=32,
                                     batching=batching, block_size=8)
                   for sm, q in ((0.5, 0.8), (0.5, 0.8), (0.3, 0.4))]
        reqs = [fe.submit("f", p, max_new_tokens=5) for p in prompts]
        fe.pump(budget_s=120.0)
        assert all(r.done and len(r.tokens_out) == 5 for r in reqs)
        out[side] = (handles, [r.tokens_out for r in reqs],
                     [fe.mem_used(n) for n in (0, 1)])
    assert out["torch"] == out["jax"]


# -- accounting at full width (no allocation) -----------------------------------


def _flat_names(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_names(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_accounting_matches_jax(arch):
    """Parameter count, the params' logical names and every KV byte count of
    the full-width config equal JAX's, from the specs alone.  The config's
    analytic ``param_count`` equals JAX's too; for starcoder2 it leaves out
    the GELU MLP's biases (d_ff + d_model a layer), which the specs hold."""
    jm, tm = jax_build(jax_config(arch)), build_model(get_config(arch))
    assert tm.n_params() == jm.n_params()
    assert tm.cfg.param_count() == jm.cfg.param_count()
    biases = tm.cfg.n_layers * (tm.cfg.d_ff + tm.cfg.d_model)
    assert tm.n_params() - tm.cfg.param_count() == (
        biases if tm.cfg.mlp == "gelu" else 0)
    tnames, jnames = (_flat_names(m.param_names()) for m in (tm, jm))
    assert tnames == jnames
    for batch, max_len in ((8, 1024), (8, 2048), (3, 100)):
        assert tm.dense_kv_bytes(batch, max_len) == \
            jm.dense_kv_bytes(batch, max_len)
        assert tm.kv_cache_bytes(batching="continuous", max_batch=batch,
                                 max_len=max_len) == jm.kv_cache_bytes(
            batching="continuous", max_batch=batch, max_len=max_len)
        jshapes = jm.cache_shapes(batch, max_len)
        tspecs = tm.cache_specs(batch, max_len)
        assert {k: s.shape for k, s in jshapes.items() if k != "pos"} == \
            {k: shape for k, (shape, _) in tspecs.items()}
    if tm.supports_paged():
        assert tm.kv_block_bytes(16) == jm.kv_block_bytes(16)
        assert tm.kv_cache_bytes(batching="paged", max_batch=8,
                                 max_len=1024) == jm.kv_cache_bytes(
            batching="paged", max_batch=8, max_len=1024)
    if arch == "gemma3-27b":
        # 62 rolled layers x 1024 rows + 10 global layers x 2048 rows, x 8
        # slots x 16 kv heads x 128 x 2 bytes x (K, V), + the int32 pos.
        assert tm.dense_kv_bytes(8, 2048) == \
            (62 * 1024 + 10 * 2048) * 8 * 16 * 128 * 2 * 2 + 4 \
            == 5_502_926_852
