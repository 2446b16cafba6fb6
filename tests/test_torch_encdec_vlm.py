"""The encoder-decoder and vision families in the port against the JAX
package on the CPU: seamless-m4t-large-v2 and llama-3.2-vision-11b at
their reduced sizes, and a vision model with a cross layer after every 2
of 4 self layers and a qkv bias (which its cross layers must not take).

Both packages run f32 params (the JAX tree bridged with
``repro_torch.bridge``) on the same inputs, drawn with numpy from a seed;
the port runs its plain versions.  The zero-initialised leaves — the
vision model's ``tanh`` gates (a zero gate hides the cross layer), the
norms and the GELU biases — are filled from the seed before either
package sees them.  Contexts are unit-normal, so they move the logits.
Tolerances, each with its reason:
* ``encode``, prefill and decode logits: 2e-5, ``tests/test_kernels.py``'s
  f32 tolerance (the same products, summed in another order); a free
  slot's decode logits 1e-3, for the cache leaves' reason below;
* cache leaves: relative 1e-2 (one bf16 ulp), after decode steps also
  absolute 1e-3, as ``tests/test_torch_dense_configs.py``: the pools are
  bf16 in both packages, and a row whose f32 value differs by an ulp can
  round to the neighbouring bf16 value;
* greedy streams, the slot round trip and byte accounting: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import encdec as jencdec
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.models import encdec as tencdec
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ServingEngine

torch.set_num_threads(2)

ARCHS = ("seamless-m4t-large-v2", "llama-3.2-vision-11b")
# Each case: (arch, overrides of its reduced config).
CASES = {"seamless": ("seamless-m4t-large-v2", {}),
         "vision": ("llama-3.2-vision-11b", {}),
         "vision-bias": ("llama-3.2-vision-11b",
                         {"name": "llama-vision-bias", "qkv_bias": True})}
MAX_LEN = 32


def _jcfg(case):
    arch, over = CASES[case]
    cfg = jax_config(arch, reduced=True)
    return dataclasses.replace(cfg, **over) if over else cfg


def _filled(tree, rng):
    """f32 numpy leaves; every all-zero leaf drawn from ``rng`` instead."""
    if isinstance(tree, dict):
        return {k: _filled(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if not a.any():
        a = (rng.standard_normal(a.shape) * 0.5).astype(np.float32)
    return a


_PAIRS = {}


def _pair(case):
    """(JAX model, f32 JAX params, port model, bridged params) of a case,
    zero leaves filled, built once per case."""
    if case not in _PAIRS:
        jcfg = _jcfg(case)
        jm = jax_build(jcfg)
        host = _filled(jax.device_get(jm.init(jax.random.key(7))),
                       np.random.default_rng(3))
        tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
        _PAIRS[case] = (jm, jax.tree_util.tree_map(jnp.asarray, host), tm,
                        bridge.to_torch(host))
    return _PAIRS[case]


def _ctx(cfg, seed, batch=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.n_context_tokens,
                                cfg.d_model)).astype(np.float32)


def _prompt(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check_caches(tpool, jpool, atol):
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tpool[key].dtype == torch.bfloat16
        assert tuple(tpool[key].shape) == tuple(jpool[key].shape), key
        np.testing.assert_allclose(_np(tpool[key]), _np(jpool[key]),
                                   rtol=1e-2, atol=atol, err_msg=key)


def test_encode_matches_jax():
    """seamless's bidirectional encoder (rope over frame positions, flash
    with ``causal=False``) within 2e-5 of JAX's."""
    jm, jp, tm, tp = _pair("seamless")
    ctx = _ctx(tm.cfg, 1)
    want = jencdec.encode(jp, jnp.asarray(ctx), jm.cfg)
    got = tencdec.encode(tp, torch.from_numpy(ctx), tm.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    """Prefill logits and the four cache leaves after a 9-token prompt with
    its context, then 8 decode steps on slot 1 of a two-slot pool (slot 0
    free, its position running on): logits and leaves after every step.
    The live slot's logits hold to 2e-5; the free slot's, computed over
    the zero rows and the garbage it writes, to 1e-3: a row it writes can
    round to the neighbouring bf16 value (the cache leaves' reason), and
    in this data one does."""
    jm, jp, tm, tp = _pair(case)
    cfg = tm.cfg
    toks, ctx = _prompt(cfg, 9, 5), _ctx(cfg, 6)
    jl, jc = jax.jit(lambda p, t, c: jm.prefill(p, t, max_len=MAX_LEN,
                                                ctx=c))(
        jp, jnp.asarray(toks), jnp.asarray(ctx))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN,
                        ctx=torch.from_numpy(ctx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    assert set(tc) == set(jc) == {"k", "v", "cross_k", "cross_v", "pos"}
    assert int(tc["pos"]) == int(jc["pos"]) == 9
    n_cross = (cfg.n_layers if cfg.family == "encdec"
               else cfg.n_layers // cfg.cross_attn_every)
    assert tc["cross_k"].shape == (n_cross, 1, cfg.n_context_tokens,
                                   cfg.n_kv_heads, cfg.dh)
    _check_caches(tc, jc, 1e-6)
    jpool = jm.merge_slot(jm.init_slot_cache(2, MAX_LEN), jc, jnp.int32(1))
    tpool = tm.merge_slot(tm.init_slot_cache(2, MAX_LEN, "cpu"), tc, 1)
    jtok = jnp.zeros((2,), jnp.int32).at[1].set(jm.sample_greedy(jl)[0])
    ttok = torch.zeros(2, dtype=torch.int32)
    ttok[1] = tm.sample_greedy(tl)[0]
    step = jax.jit(jm.decode_step)
    for _ in range(8):
        jl, jpool = step(jp, jtok, jpool)
        tl, tpool = tm.decode_step(tp, ttok, tpool)
        np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl[1]),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-3)
        jtok, ttok = jm.sample_greedy(jl), tm.sample_greedy(tl)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        _check_caches(tpool, jpool, 1e-3)
    np.testing.assert_array_equal(tpool["pos"].numpy(),
                                  np.asarray(jpool["pos"]))


# -- the model-level continuous loop --------------------------------------------


class _JaxSide:
    def __init__(self, jm, jp):
        self.m, self.p = jm, jp
        self.prefill = jax.jit(lambda p, t, c: jm.prefill(
            p, t, max_len=MAX_LEN, ctx=c))
        self.round = jax.jit(jm.decode_step_tokens)

    def pool(self, n):
        return self.m.init_slot_cache(n, MAX_LEN), jnp.zeros((n,), jnp.int32)

    def admit(self, pool, tok, slot, prompt, ctx):
        logits, entry = self.prefill(self.p, jnp.asarray(prompt[None]),
                                     jnp.asarray(ctx[None]))
        first = self.m.sample_greedy(logits)[0]
        pool = self.m.merge_slot(pool, entry, jnp.int32(slot))
        return pool, tok.at[slot].set(first), int(first)

    def step(self, pool, tok):
        tok, pool = self.round(self.p, tok, pool)
        return pool, tok, np.asarray(tok).tolist()


class _TorchSide:
    def __init__(self, tm, tp):
        self.m, self.p = tm, tp

    def pool(self, n):
        return (self.m.init_slot_cache(n, MAX_LEN, "cpu"),
                torch.zeros(n, dtype=torch.int32))

    def admit(self, pool, tok, slot, prompt, ctx):
        logits, entry = self.m.prefill(self.p, torch.from_numpy(prompt[None]),
                                       max_len=MAX_LEN,
                                       ctx=torch.from_numpy(ctx[None]))
        tok[slot] = self.m.sample_greedy(logits)[0]
        return self.m.merge_slot(pool, entry, slot), tok, int(tok[slot])

    def step(self, pool, tok):
        new, pool = self.m.decode_step_tokens(self.p, tok, pool)
        return pool, tok.copy_(new), tok.tolist()


def continuous_loop(side, requests, n_slots=2):
    """Greedy streams of ``requests`` ((prompt, ctx, new tokens) each) on
    ``n_slots`` slots: admit each queued request into a free slot (its
    prefill's greedy token is its first), run a round over the pool, free
    every slot whose request has its tokens, and refill."""
    pool, tok = side.pool(n_slots)
    queue = list(range(len(requests)))
    slots = [None] * n_slots
    out = [[] for _ in requests]

    def take(slot, r, t):
        out[r].append(t)
        slots[slot] = None if len(out[r]) == requests[r][2] else r

    while queue or any(r is not None for r in slots):
        for slot in range(n_slots):
            if slots[slot] is None and queue:
                r = queue.pop(0)
                prompt, ctx, _ = requests[r]
                pool, tok, first = side.admit(pool, tok, slot, prompt, ctx)
                take(slot, r, first)
        if any(r is not None for r in slots):
            pool, tok, got = side.step(pool, tok)
            for slot, r in enumerate(slots):
                if r is not None:
                    take(slot, r, got[slot])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_continuous_loop_streams_match_jax(case):
    """Three requests with their own contexts on two slots, so that a slot
    refills mid-flight: ``init_slot_cache`` -> ``merge_slot`` ->
    ``decode_step_tokens``, the port's greedy streams equal JAX's same
    loop token for token."""
    jm, jp, tm, tp = _pair(case)
    cfg = tm.cfg
    requests = [(_prompt(cfg, n, 10 + i)[0], _ctx(cfg, 20 + i)[0], new)
                for i, (n, new) in enumerate(((5, 4), (11, 9), (3, 6)))]
    want = continuous_loop(_JaxSide(jm, jp), requests)
    got = continuous_loop(_TorchSide(tm, tp), requests)
    assert [len(s) for s in got] == [4, 9, 6]
    assert got == want


@pytest.mark.parametrize("case", ["seamless", "vision"])
def test_gather_slot_inverts_merge_slot(case):
    """Every leaf, the cross caches included, makes the round trip through
    slot 2 of a three-slot pool bit for bit, and the other slots stay
    zero."""
    _, _, tm, tp = _pair(case)
    cfg = tm.cfg
    _, entry = tm.prefill(tp, torch.from_numpy(_prompt(cfg, 7, 1)),
                          max_len=16, ctx=torch.from_numpy(_ctx(cfg, 2)))
    pool = tm.init_slot_cache(3, 16, "cpu")
    assert set(pool) == set(entry)
    back = tm.gather_slot(tm.merge_slot(pool, entry, 2), 2)
    for key in entry:
        torch.testing.assert_close(back[key], entry[key], rtol=0, atol=0)
    for key in ("k", "v", "cross_k", "cross_v"):
        assert not pool[key][:, :2].any() and pool[key][:, 2].any()


@pytest.mark.parametrize("case", list(CASES))
def test_context_moves_the_logits(case):
    """The same prompt under another context gives other prefill and
    decode logits, in both packages alike."""
    jm, jp, tm, tp = _pair(case)
    cfg = tm.cfg
    toks = _prompt(cfg, 6, 4)
    outs = []
    for seed in (30, 31):
        ctx = _ctx(cfg, seed)
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=16,
                            ctx=torch.from_numpy(ctx))
        jl, _ = jm.prefill(jp, jnp.asarray(toks), max_len=16,
                           ctx=jnp.asarray(ctx))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                                   atol=2e-5)
        dl, _ = tm.decode_step(tp, torch.tensor([3], dtype=torch.int32), tc)
        outs.append((tl, dl))
    for a, b in zip(*outs):
        assert (a - b).abs().max() > 1e-2


# -- accounting, specs and the bridge ----------------------------------------


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_accounting_matches_jax(arch, reduced):
    """Parameter count, slot-pool bytes and cache leaf shapes equal JAX's,
    from the specs alone, at full width and reduced; int8 KV is refused
    (the gate covers dense and moe only)."""
    jm = jax_build(jax_config(arch, reduced=reduced))
    tm = build_model(get_config(arch, reduced=reduced))
    assert tm.n_params() == jm.n_params()
    assert tm.cfg.param_count() == jm.cfg.param_count()
    for batch, max_len in ((8, 1024), (3, 100), (1, 16)):
        assert tm.dense_kv_bytes(batch, max_len) == \
            jm.dense_kv_bytes(batch, max_len)
        assert tm.kv_cache_bytes(batching="continuous", max_batch=batch,
                                 max_len=max_len) == jm.kv_cache_bytes(
            batching="continuous", max_batch=batch, max_len=max_len)
        jshapes = jm.cache_shapes(batch, max_len)
        assert {k: s.shape for k, s in jshapes.items() if k != "pos"} == \
            {k: shape for k, (shape, _) in tm.cache_specs(
                batch, max_len).items()}
    assert tm.needs_ctx() and jm.needs_ctx()
    jshape = jm.ctx_shape(2)
    assert tm.ctx_shape(2) == (jshape.shape, torch.bfloat16)
    assert not (tm.supports_paged() or tm.supports_bucketed_prefill()
                or tm.supports_speculative() or tm.kv_int8())
    with pytest.raises(ValueError, match="int8"):
        tm.cache_specs(2, 16, kv_int8=True)
    if not reduced:
        expect = {"seamless-m4t-large-v2": (1_632_675_840, 1_610_612_740),
                  "llama-3.2-vision-11b": (11_520_053_264, 1_761_607_684)}
        assert (tm.n_params(), tm.dense_kv_bytes(8, 1024)) == expect[arch]


@pytest.mark.parametrize("case", list(CASES))
def test_bridge_carries_the_new_leaves(case):
    """The port's spec tree equals JAX's in keys, shapes and dtypes (the
    stacked 0-d gates (G,), ``enc_layers``, ``cross_layers``), and the
    JAX params cross to torch and back leaf for leaf, bit for bit, bf16
    as drawn."""
    jcfg = _jcfg(case)
    jm = jax_build(jcfg)
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    jspecs, tspecs = _flat_specs(jm.specs), _flat_specs(tm.specs)
    assert set(jspecs) == set(tspecs)
    for key, js in jspecs.items():
        ts = tspecs[key]
        assert (tuple(ts.shape), ts.init, str(ts.dtype).split(".")[-1]) == \
            (tuple(js.shape), js.init, np.dtype(js.dtype).name), key
    if jcfg.family == "vlm":
        g = jcfg.n_layers // jcfg.cross_attn_every
        assert tspecs["cross_layers/gate_attn"].shape == (g,)
        assert "bq" not in tm.specs["cross_layers"]["attn"]
        assert ("bq" in tm.specs["layers"]["attn"]) == jcfg.qkv_bias
    else:
        assert tspecs["enc_layers/attn/wq"].shape[0] == jcfg.encoder_layers
        assert "bq" not in tm.specs["layers"]["xattn"]
    host = jax.device_get(jm.init(jax.random.key(1)))
    tp = bridge.to_torch(host)
    flat_host, flat_t = _flat_specs(host), _flat_specs(tp)
    assert set(flat_host) == set(flat_t)
    for key, a in flat_host.items():
        t = flat_t[key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape, key
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32), err_msg=key)
    back = _flat_specs(bridge.to_numpy(tp))
    for key, a in flat_host.items():
        np.testing.assert_array_equal(back[key], np.asarray(a, np.float32))


# -- refusals ----------------------------------------------------------------


def test_refusals(capsys):
    """vision ``prefill(length=)`` (its caches are not length-masked, as
    in JAX), a missing context, a context given to a dense model, and the
    engine's deploy of a model whose prefill needs a context — which a
    request does not carry, in either package's engine — raise; so does
    the serve entry point, before any weight is drawn."""
    from repro_torch.launch import serve

    _, _, vm, vp = _pair("vision")
    toks = torch.from_numpy(_prompt(vm.cfg, 8, 0))
    ctx = torch.from_numpy(_ctx(vm.cfg, 0))
    with pytest.raises(NotImplementedError, match="length-masked"):
        vm.prefill(vp, toks, max_len=16, ctx=ctx, length=5)
    _, _, sm, sp = _pair("seamless")
    with pytest.raises(NotImplementedError, match="exact prompt length"):
        sm.prefill(sp, toks, max_len=16, ctx=ctx, length=5)
    for model, params in ((vm, vp), (sm, sp)):
        with pytest.raises(ValueError, match="needs a context"):
            model.prefill(params, toks, max_len=16)
        eng = ServingEngine(device="cpu")
        with pytest.raises(ValueError, match="engine.py:215-217"):
            eng.deploy("f", model, params, Alloc(sm=1.0, quota_request=0.9,
                                                 quota_limit=0.9))
        assert not eng.instances and not eng.store.contains("f")
    dense = build_model(get_config("qwen2-7b", reduced=True))
    dp = dense.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="takes no context"):
        dense.prefill(dp, toks, ctx=ctx)
    for arch in ARCHS:
        with pytest.raises(SystemExit) as exit_info:
            serve.main(["--reduced", "--device", "cpu", "--arch", arch])
        assert exit_info.value.code == 2
        assert "Model API" in capsys.readouterr().err
