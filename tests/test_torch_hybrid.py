"""The port's hybrid (Hymba) path against the JAX package: the selective
scan's plain version against ``ops.ssm_scan`` (xla path),
``ref.ssm_reference`` and the Pallas kernel (interpret mode); the rolled
sliding-window cache (``_windowed_cache``, ``_rolled_decode``); and the
hybrid model's prefill and slot decode against the JAX ``Model`` on
reduced hymba-1.5b (window 8, 4 meta tokens, so prompt + meta passes the
window and decode wraps the rolled cache).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:
* selective scan: 2e-5 in f32 (sums in another order) and 2e-2 in bf16
  (outputs round to bf16), as ``test_kernels.test_ssm_pallas_vs_ref``;
* the chunked algorithm (``ssm_chunked_plain``, the chunked kernel's): in
  f32, 1e-4 relative plus 1e-4 times the mean |reference| absolute — it
  sums in another order (chunk sums of dt, scores, then the state
  update), and the f32 rounding of either side grows with the size of the
  terms summed, not with each output's own value (near-zero outputs are
  sums of terms as large as the others); 2e-2 in bf16;
* rolled decode: 2e-5 (f32 softmax over the same rows);
* model logits with f32 params: prefill 2e-5 (f32 end to end; prefill
  logits do not read the bf16 cache); decode 1e-3 — the K/V pools are
  bf16 in both packages (model.py:184-192), and a K/V row whose f32 value
  differs by an ulp can round to neighbouring bf16 values.  Greedy tokens
  must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.resources import Alloc
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ServingEngine
from test_kernels import SSM_SHAPES

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ssm_inputs(rng, b, s, h, d, n, dtype, state_scale=1.0, decay="mild"):
    """x, dt, a_log, b, c, state in both frameworks, drawn as
    ``test_kernels`` draws them: dt a small positive step, a_log f32, the
    state f32 and nonzero.  ``decay="strong"``: a_log = log(1..N) + 2 and
    dt = softplus(N(0, 1) + 2), so a 16-step chunk's exponent reaches the
    hundreds; ``"weak"``: dt = 1e-3."""
    jd, td = DTYPES[dtype]
    dt = {"mild": lambda: np.abs(rng.normal(size=(b, s, h)) * 0.1),
          "strong": lambda: np.logaddexp(0.0, rng.normal(size=(b, s, h))
                                         + 2.0),
          "weak": lambda: np.full((b, s, h), 1e-3)}[decay]()
    a_log = np.tile(np.log(np.arange(1.0, n + 1)) + 2.0, (h, 1)) \
        if decay == "strong" else rng.normal(size=(h, n)) * 0.2
    xs = [rng.normal(size=(b, s, h, d)), dt, a_log,
          rng.normal(size=(b, s, h, n)),
          rng.normal(size=(b, s, h, n)),
          rng.normal(size=(b, h, d, n)) * state_scale]
    xs = [x.astype(np.float32) for x in xs]
    jx = [jnp.asarray(x).astype(jd) for x in xs[:2]] + [jnp.asarray(xs[2])] \
        + [jnp.asarray(x).astype(jd) for x in xs[3:5]] + [jnp.asarray(xs[5])]
    tx = [torch.from_numpy(x).to(td) for x in xs[:2]] \
        + [torch.from_numpy(xs[2])] \
        + [torch.from_numpy(x).to(td) for x in xs[3:5]] \
        + [torch.from_numpy(xs[5])]
    return jx, tx


# -- the selective scan -------------------------------------------------------


@pytest.mark.parametrize("shape", SSM_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_plain_vs_jax(shape, dtype):
    b, s, h, d, n, bt = shape
    rng = np.random.default_rng(sum(shape))
    jx, tx = _ssm_inputs(rng, b, s, h, d, n, dtype)
    y, st = ssm_scan.ssm_scan(*tx)  # CPU: the plain version
    assert y.dtype == tx[0].dtype and st.dtype == torch.float32
    for jy, js in (jops.ssm_scan(*jx, backend="xla"),
                   jref.ssm_reference(*jx),
                   ssm_scan_pallas(*jx, block_t=bt)):
        np.testing.assert_allclose(_np(y), _np(jy), **_tol(dtype))
        np.testing.assert_allclose(st.numpy(), np.asarray(js), **_tol(dtype))
    ty, ts = tref.ssm_reference(*tx)
    np.testing.assert_allclose(_np(y), _np(ty), **_tol(dtype))
    np.testing.assert_allclose(st.numpy(), ts.numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_split_scan_and_single_steps(dtype):
    """A scan split at an odd step with the state carried equals the whole
    scan, and S = 1 steps (decode) chain to it; S = 1 matches JAX."""
    rng = np.random.default_rng(6)
    b, s, h, d, n = 2, 13, 3, 8, 4
    jx, tx = _ssm_inputs(rng, b, s, h, d, n, dtype)
    x, dt, a_log, bm, cm, st0 = tx
    y1, s1 = ssm_scan.ssm_scan_plain(x[:, :1], dt[:, :1], a_log, bm[:, :1],
                                     cm[:, :1], st0)
    jy1, js1 = jops.ssm_scan(jx[0][:, :1], jx[1][:, :1], jx[2],
                             jx[3][:, :1], jx[4][:, :1], jx[5],
                             backend="xla")
    np.testing.assert_allclose(_np(y1), _np(jy1), **_tol(dtype))
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), **_tol(dtype))
    whole, st_whole = ssm_scan.ssm_scan_plain(*tx)

    def part(lo, hi, state):
        return ssm_scan.ssm_scan_plain(x[:, lo:hi], dt[:, lo:hi], a_log,
                                       bm[:, lo:hi], cm[:, lo:hi], state)

    head, st_mid = part(0, 5, st0)
    tail, st_end = part(5, s, st_mid)
    steps, st = [], st0
    for t in range(s):
        yt, st = part(t, t + 1, st)
        steps.append(yt)
    for ys, last in ((torch.cat([head, tail], 1), st_end),
                     (torch.cat(steps, 1), st)):
        np.testing.assert_allclose(_np(ys), _np(whole), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(last.numpy(), st_whole.numpy(),
                                   rtol=1e-6, atol=1e-6)


def _chunked_tol(name, ref):
    if name == "bf16":
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(_np(ref)).mean()))


@pytest.mark.parametrize("s", [1, 15, 16, 17, 77, 300])
@pytest.mark.parametrize("d,n", [(16, 8), (64, 16)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_chunked_plain_vs_jax(s, d, n, dtype):
    """The chunked kernel's algorithm against ``ops.ssm_scan`` (xla),
    ``ref.ssm_reference`` and the Pallas kernel (interpret mode, one block
    of S steps): below one chunk, at one chunk, one step past it, ragged,
    long; at the reduced hymba's D = 16, N = 8 and hymba's D = 64, N = 16."""
    rng = np.random.default_rng(400 + s + n)
    jx, tx = _ssm_inputs(rng, 2, s, 2, d, n, dtype)
    y, st = ssm_scan.ssm_chunked_plain(*tx)
    assert y.dtype == tx[0].dtype and st.dtype == torch.float32
    for jy, js in (jops.ssm_scan(*jx, backend="xla"),
                   jref.ssm_reference(*jx),
                   ssm_scan_pallas(*jx, block_t=s)):
        np.testing.assert_allclose(_np(y), _np(jy), **_chunked_tol(dtype, jy))
        np.testing.assert_allclose(st.numpy(), np.asarray(js),
                                   **_chunked_tol(dtype, js))


@pytest.mark.parametrize("decay,s", [("strong", 77), ("strong", 300),
                                     ("weak", 300)])
@pytest.mark.parametrize("chunk", [ssm_scan.CHUNK, 64])
@pytest.mark.parametrize("n", [8, 16])
def test_ssm_chunked_plain_decay_extremes(decay, s, chunk, n):
    """Strong decay (no exponent the algorithm forms is positive, so no
    overflow and the output stays finite) and weak decay (the state keeps
    hundreds of steps), at the kernel's chunk and at a 64-step chunk (six
    levels of boundaries instead of four)."""
    rng = np.random.default_rng(500 + s + n)
    jx, tx = _ssm_inputs(rng, 2, s, 2, 16, n, "f32", decay=decay)
    y, st = ssm_scan.ssm_chunked_plain(*tx, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    jy, js = jops.ssm_scan(*jx, backend="xla")
    np.testing.assert_allclose(_np(y), _np(jy), **_chunked_tol("f32", jy))
    np.testing.assert_allclose(st.numpy(), np.asarray(js),
                               **_chunked_tol("f32", js))


def test_ssm_chunked_plain_split_equals_whole():
    """A scan split at steps 37 and 160 (the state carried across calls,
    so the chunks fall elsewhere) equals the whole scan."""
    rng = np.random.default_rng(8)
    _, tx = _ssm_inputs(rng, 2, 300, 2, 16, 16, "f32")
    x, dt, a_log, bm, cm, st0 = tx
    whole, st_whole = ssm_scan.ssm_chunked_plain(*tx)
    ys, st = [], st0
    for lo, hi in ((0, 37), (37, 160), (160, 300)):
        y, st = ssm_scan.ssm_chunked_plain(x[:, lo:hi], dt[:, lo:hi], a_log,
                                           bm[:, lo:hi], cm[:, lo:hi], st)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(whole),
                               **_chunked_tol("f32", whole))
    np.testing.assert_allclose(st.numpy(), st_whole.numpy(),
                               **_chunked_tol("f32", st_whole))
    with pytest.raises(ValueError, match="power of two"):
        ssm_scan.ssm_chunked_plain(*tx, chunk=24)


def test_ssm_wrapper_refuses_other_devices():
    x = torch.zeros((1, 2, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ssm_scan.ssm_scan(x, x[..., 0], x[0, 0], x, x, x[:, 0])


# -- the rolled sliding-window cache ------------------------------------------


@pytest.mark.parametrize("s", [5, 8, 13, 21])
def test_windowed_cache_matches_jax(s):
    """s < c: zero-filled after the prompt; s = c: as is; s > c: the last
    c rows rolled by s mod c (C = min(window 8, max_len))."""
    k = np.random.default_rng(s).normal(size=(2, s, 2, 4)).astype(
        np.float32)
    for w, max_len in ((8, 32), (8, 6), (16, 40)):
        want = jtr._windowed_cache(jnp.asarray(k), w, max_len)
        got = ttr._windowed_cache(torch.from_numpy(k), w, max_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ttr._full_cache(torch.from_numpy(k), 24).numpy(),
        np.asarray(jtr._full_cache(jnp.asarray(k), 24)))
    assert ttr.local_cache_len(get_config("hymba-1.5b"), 1024 + 128) == 1024


@pytest.mark.parametrize("window", [None, 8, 5])
def test_rolled_decode_matches_jax(window):
    """Slot positions wrap (pos below, at and past C) and negative
    positions mask; ``window < C`` masks further (hymba never reaches it:
    its C is at most the window)."""
    rng = np.random.default_rng(17)
    b, c, h, kv, d = 5, 8, 4, 2, 16
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, c, kv, d)).astype(np.float32)
    vc = rng.normal(size=(b, c, kv, d)).astype(np.float32)
    pos = np.array([0, 3, 7, 8, 29], np.int32)
    want = jattn._rolled_decode(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(pos), window)
    got = tattn._rolled_decode(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), torch.from_numpy(pos),
                               window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# -- the hybrid model against the JAX Model -----------------------------------


@pytest.fixture(scope="module")
def hybrid_pair():
    jcfg = jax_config("hymba-1.5b", reduced=True)
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(7)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def test_hybrid_layout_matches_jax(hybrid_pair):
    """The bridged tree is the port's own tree (``meta``, ``layers.ssm.*``,
    ``ln_attn``, ``ln_ssm``), bit for bit; parameter and cache byte
    counts equal JAX's at reduced and full width."""
    jm, jp, tm, tp = hybrid_pair
    specs = _flat(tm.specs)
    flat_j, flat_t = _flat(jax.device_get(jp)), _flat(tp)
    assert set(specs) == set(flat_t) == set(flat_j)
    assert {"meta", "layers.ssm.a_log", "layers.ssm.dt_bias",
            "layers.ln_attn", "layers.ln_ssm"} <= set(specs)
    for key, leaf in flat_t.items():
        assert tuple(leaf.shape) == specs[key].shape
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(flat_j[key]))
    jbf = jax.device_get(jm.init(jax.random.key(8)))  # bf16, by bit pattern
    for key, leaf in _flat(bridge.to_torch(jbf)).items():
        assert leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            leaf.view(torch.int16).numpy(),
            np.asarray(_flat(jbf)[key]).view(np.int16))
    assert tm.n_params() == jm.n_params()
    for batch, max_len in ((4, 64), (3, 2)):
        assert tm.dense_kv_bytes(batch, max_len) == \
            jm.dense_kv_bytes(batch, max_len)
    pool = tm.init_slot_cache(3, 64, "cpu")
    for key, s in jm.init_slot_cache(3, 64).items():
        assert tuple(pool[key].shape) == s.shape
        assert str(pool[key].dtype).split(".")[1] == str(s.dtype)
    full, jfull = build_model(get_config("hymba-1.5b")), jax_build(
        jax_config("hymba-1.5b"))
    assert full.n_params() == jfull.n_params() == 1_351_336_800
    assert full.dense_kv_bytes(8, 1024) == jfull.dense_kv_bytes(8, 1024) \
        == 361_758_724


@pytest.mark.parametrize("n_prompt", [1, 3, 11])
def test_hybrid_prefill_and_slot_decode_match_jax(hybrid_pair, n_prompt):
    """Prompt + 4 meta tokens of 5, 7 and 15 rows against a window of 8:
    below the window, one short of it, and past it (rolled at prefill);
    12 decode rounds then wrap the rolled cache."""
    jm, jp, tm, tp = hybrid_pair
    max_len = 24
    rng = np.random.default_rng(n_prompt)
    toks = rng.integers(0, jm.cfg.vocab_size, (1, n_prompt)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len=max_len))(
        jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    assert int(tc["pos"]) == int(jc["pos"]) == n_prompt + 4
    assert tc["k"].dtype == torch.bfloat16 and tc["ssm"].dtype == \
        torch.float32
    for key in ("k", "v"):  # JAX emits f32 K/V (its pool casts to bf16)
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]),
                                   rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]),
                               rtol=2e-5, atol=2e-5)
    # Slot 1 of a two-slot pool; slot 0 stays free (and runs garbage).
    jpool = jm.merge_slot(jm.init_slot_cache(2, max_len), jc, jnp.int32(1))
    tpool = tm.merge_slot(tm.init_slot_cache(2, max_len, "cpu"), tc, 1)
    assert tpool["k"].shape[2] == 8  # min(window, max_len + meta)
    jtok = jnp.zeros((2,), jnp.int32).at[1].set(jm.sample_greedy(jl)[0])
    ttok = torch.zeros(2, dtype=torch.int32)
    ttok[1] = tm.sample_greedy(tl)[0]
    step = jax.jit(jm.decode_step)
    for _ in range(12):
        jl, jpool = step(jp, jtok, jpool)
        tl, tpool = tm.decode_step(tp, ttok, tpool)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-3)
        jtok, ttok = jm.sample_greedy(jl), tm.sample_greedy(tl)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tpool["pos"].numpy(),
                                  np.asarray(jpool["pos"]))
    np.testing.assert_allclose(tpool["ssm"].numpy(),
                               np.asarray(jpool["ssm"]), rtol=1e-3,
                               atol=1e-3)
    back = tm.gather_slot(tpool, 1)
    assert tuple(back["ssm"].shape) == (2, 1, 4, 16, 8)


def test_hybrid_fused_round_and_refusals(hybrid_pair, monkeypatch):
    """The fused round samples on the device; bucketed prefill, paged
    batching and the int8 gate are refused or off for the hybrid, and a
    pool refuses an entry whose K/V are not bf16."""
    _, _, tm, tp = hybrid_pair
    pool = tm.init_slot_cache(2, 16, "cpu")
    tok, pool = tm.decode_step_tokens(tp, torch.tensor([3, 4],
                                                       dtype=torch.int32),
                                      pool)
    assert tok.dtype == torch.int32 and tuple(tok.shape) == (2,)
    assert pool["pos"].tolist() == [1, 1]
    with pytest.raises(NotImplementedError, match="exact prompt length"):
        tm.prefill(tp, torch.zeros((1, 8), dtype=torch.int32), length=5)
    assert not tm.supports_bucketed_prefill() and not tm.supports_paged()
    with pytest.raises(NotImplementedError):
        tm.init_paged_cache(4, 8, "cpu")
    eng = ServingEngine(device="cpu")
    with pytest.raises(ValueError, match="paged"):
        eng.deploy("f", tm, tp, Alloc(sm=1.0, quota_request=0.9,
                                      quota_limit=0.9), batching="paged")
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    assert not tm.kv_int8()
    _, entry = tm.prefill(tp, torch.zeros((1, 4), dtype=torch.int32),
                          max_len=16)
    assert set(entry) == {"k", "v", "ssm", "pos"}
    assert set(tm.init_slot_cache(2, 16, "cpu")) == set(entry)
    with pytest.raises(TypeError, match="'k'"):
        tm.merge_slot(pool, dict(entry, k=entry["k"].float()), 0)
