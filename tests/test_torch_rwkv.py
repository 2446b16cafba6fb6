"""The port's RWKV-6 path against the JAX package: the WKV-6 plain scan
against ``ops.wkv6_scan`` (xla path), ``ref.wkv6_reference`` and the
Pallas kernel (interpret mode), and the rwkv6 model's prefill and decode
against the JAX ``Model`` on reduced rwkv6-1.6b.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:
* WKV scan: 2e-5 in f32 (sums in another order) and 2e-2 in bf16 (outputs
  round to bf16), as ``test_kernels.test_wkv6_pallas_vs_ref``;
* the chunked algorithm (``wkv6_chunked_plain``, the chunked kernel's): in
  f32, 1e-4 relative plus 1e-4 times the mean |reference| absolute — it
  sums in another order (chunk sums of the decay, scores, then the state
  update), and the f32 rounding of either side grows with the size of the
  terms summed, not with each output's own value (near-zero outputs are
  sums of terms as large as the others); 2e-2 in bf16;
* model logits with f32 params: prefill 2e-5 (f32 end to end; the
  token-shift rows the cache keeps are bf16, as the JAX cache layout
  declares, but prefill logits do not read them); decode 1e-3 — the port
  rounds every carried token-shift row into its bf16 pool, while the JAX
  pool turns f32 after its first round (``decode_step`` returns f32 rows
  for f32 params), so the two carry rows a bf16 rounding apart.  Greedy
  tokens must be identical.
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
from repro.kernels.wkv6 import wkv6_pallas
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from test_kernels import WKV_SHAPES

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


def _wkv_inputs(rng, b, s, h, d, dtype, state_scale=1.0, decay="mild"):
    """r, k, v, w, u, state in both frameworks; w is a negative log decay:
    "mild" as in ``test_kernels``, "strong" -exp(N(0,1) + 2) (a 16-step
    chunk's decay reaches hundreds, far past f32's e^-88) or "weak"
    -1e-3; the state is f32 and nonzero."""
    jd, td = DTYPES[dtype]
    xs = [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]
    n = rng.normal(size=(b, s, h, d))
    xs.append({"mild": -np.exp(n * 0.3) - 0.01, "strong": -np.exp(n + 2.0),
               "weak": np.full_like(n, -1e-3)}[decay].astype(np.float32))
    xs.append(rng.normal(size=(h, d)).astype(np.float32))
    st = (rng.normal(size=(b, h, d, d)) * state_scale).astype(np.float32)
    jx = [jnp.asarray(x).astype(jd) for x in xs] + [jnp.asarray(st)]
    tx = [torch.from_numpy(x).to(td) for x in xs] + [torch.from_numpy(st)]
    return jx, tx


# -- the WKV-6 scan --------------------------------------------------------------


@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv6_plain_vs_jax(shape, dtype):
    b, s, h, d, _ = shape
    rng = np.random.default_rng(sum(shape))
    jx, tx = _wkv_inputs(rng, b, s, h, d, dtype)
    out, st = wkv6.wkv6_scan(*tx)  # CPU: the plain version
    assert out.dtype == tx[0].dtype and st.dtype == torch.float32
    for jo, js in (jops.wkv6_scan(*jx, backend="xla"),
                   jref.wkv6_reference(*jx)):
        np.testing.assert_allclose(_np(out), _np(jo), **_tol(dtype))
        np.testing.assert_allclose(st.numpy(), np.asarray(js), **_tol(dtype))
    to, ts = tref.wkv6_reference(*tx)
    np.testing.assert_allclose(_np(out), _np(to), **_tol(dtype))
    np.testing.assert_allclose(st.numpy(), ts.numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv6_single_step_and_split_scan(dtype):
    """S = 1 (a decode step) against JAX, and a scan split in two at an odd
    step equals the whole scan (the state carries across calls)."""
    rng = np.random.default_rng(4)
    b, s, h, d = 2, 13, 3, 16
    jx, tx = _wkv_inputs(rng, b, s, h, d, dtype)
    one = [x[:, :1] for x in tx[:4]] + tx[4:]
    jone = [x[:, :1] for x in jx[:4]] + jx[4:]
    out1, st1 = wkv6.wkv6_scan_plain(*one)
    jo1, js1 = jops.wkv6_scan(*jone, backend="xla")
    np.testing.assert_allclose(_np(out1), _np(jo1), **_tol(dtype))
    np.testing.assert_allclose(st1.numpy(), np.asarray(js1), **_tol(dtype))
    whole, st_whole = wkv6.wkv6_scan_plain(*tx)
    head, st_mid = wkv6.wkv6_scan_plain(*[x[:, :5] for x in tx[:4]],
                                        *tx[4:])
    tail, st_end = wkv6.wkv6_scan_plain(*[x[:, 5:] for x in tx[:4]],
                                        tx[4], st_mid)
    np.testing.assert_allclose(_np(torch.cat([head, tail], 1)), _np(whole),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st_end.numpy(), st_whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_wkv6_plain_vs_pallas_interpret():
    b, s, h, d, bt = WKV_SHAPES[1]
    rng = np.random.default_rng(9)
    jx, tx = _wkv_inputs(rng, b, s, h, d, "f32")
    po, ps = wkv6_pallas(*jx, block_t=bt)
    out, st = wkv6.wkv6_scan_plain(*tx)
    np.testing.assert_allclose(_np(out), _np(po), **_tol("f32"))
    np.testing.assert_allclose(st.numpy(), np.asarray(ps), **_tol("f32"))


def _chunked_tol(name, ref):
    if name == "bf16":
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(_np(ref)).mean()))


@pytest.mark.parametrize("s", [1, 15, 16, 17, 77, 300])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv6_chunked_plain_vs_jax(s, dtype):
    """The chunked kernel's algorithm against ``ops.wkv6_scan`` (xla):
    below one chunk, at one chunk, one step past it, ragged, long."""
    rng = np.random.default_rng(100 + s)
    jx, tx = _wkv_inputs(rng, 2, s, 2, wkv6.HEAD_SIZE, dtype)
    out, st = wkv6.wkv6_chunked_plain(*tx)
    assert out.dtype == tx[0].dtype and st.dtype == torch.float32
    jo, js = jops.wkv6_scan(*jx, backend="xla")
    np.testing.assert_allclose(_np(out), _np(jo), **_chunked_tol(dtype, jo))
    np.testing.assert_allclose(st.numpy(), np.asarray(js),
                               **_chunked_tol(dtype, js))


@pytest.mark.parametrize("s", [16, 77])
def test_wkv6_chunked_plain_vs_pallas_interpret(s):
    rng = np.random.default_rng(200 + s)
    jx, tx = _wkv_inputs(rng, 1, s, 2, wkv6.HEAD_SIZE, "f32")
    po, ps = wkv6_pallas(*jx, block_t=s)
    out, st = wkv6.wkv6_chunked_plain(*tx)
    np.testing.assert_allclose(_np(out), _np(po), **_chunked_tol("f32", po))
    np.testing.assert_allclose(st.numpy(), np.asarray(ps),
                               **_chunked_tol("f32", ps))


@pytest.mark.parametrize("decay,s", [("strong", 77), ("strong", 300),
                                     ("weak", 300)])
@pytest.mark.parametrize("chunk", [wkv6.CHUNK, 64])
def test_wkv6_chunked_plain_decay_extremes(decay, s, chunk):
    """Strong decay (no exponent the algorithm forms is positive, so no
    overflow and the output stays finite) and weak decay (the state keeps
    hundreds of steps), at the kernel's chunk and at a 64-step chunk (six
    levels of boundaries instead of four)."""
    rng = np.random.default_rng(300 + s)
    jx, tx = _wkv_inputs(rng, 2, s, 2, wkv6.HEAD_SIZE, "f32",
                         decay=decay)
    out, st = wkv6.wkv6_chunked_plain(*tx, chunk=chunk)
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    jo, js = jops.wkv6_scan(*jx, backend="xla")
    np.testing.assert_allclose(_np(out), _np(jo), **_chunked_tol("f32", jo))
    np.testing.assert_allclose(st.numpy(), np.asarray(js),
                               **_chunked_tol("f32", js))


def test_wkv6_chunked_plain_split_equals_whole():
    """A scan split at steps 37 and 160 (the state carried across calls,
    so the chunks fall elsewhere) equals the whole scan."""
    rng = np.random.default_rng(7)
    _, tx = _wkv_inputs(rng, 2, 300, 2, wkv6.HEAD_SIZE, "f32")
    r, k, v, w, u, st0 = tx
    whole, st_whole = wkv6.wkv6_chunked_plain(*tx)
    outs, st = [], st0
    for lo, hi in ((0, 37), (37, 160), (160, 300)):
        o, st = wkv6.wkv6_chunked_plain(r[:, lo:hi], k[:, lo:hi],
                                        v[:, lo:hi], w[:, lo:hi], u, st)
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(whole),
                               **_chunked_tol("f32", whole))
    np.testing.assert_allclose(st.numpy(), st_whole.numpy(),
                               **_chunked_tol("f32", st_whole))
    with pytest.raises(ValueError, match="power of two"):
        wkv6.wkv6_chunked_plain(*tx, chunk=24)


# -- the rwkv6 model against the JAX Model --------------------------------------


@pytest.fixture(scope="module")
def rwkv_pair():
    jcfg = jax_config("rwkv6-1.6b", reduced=True)
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(5)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


def test_rwkv_layout_matches_jax(rwkv_pair):
    jm, _, tm, tp = rwkv_pair
    assert tm.n_params() == jm.n_params()
    assert tm.dense_kv_bytes(4, 64) == jm.dense_kv_bytes(4, 64)
    assert not tm.supports_paged() and not tm.supports_bucketed_prefill()
    assert tm.supports_bucketed_prefill() == jm.supports_bucketed_prefill()
    with pytest.raises(NotImplementedError):
        tm.init_paged_cache(4, 8, "cpu")
    pool = tm.init_slot_cache(3, 64, "cpu")
    for key, s in jm.init_slot_cache(3, 64).items():
        assert tuple(pool[key].shape) == s.shape
        assert str(pool[key].dtype).split(".")[1] == str(s.dtype)
    full = get_config("rwkv6-1.6b")
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab_size) == \
        (24, 2048, 7168, 65536)
    assert build_model(full).n_params() == jax_build(
        jax_config("rwkv6-1.6b")).n_params()


@pytest.mark.parametrize("n_prompt", [1, 11])
def test_rwkv_prefill_and_slot_decode_match_jax(rwkv_pair, n_prompt):
    jm, jp, tm, tp = rwkv_pair
    rng = np.random.default_rng(n_prompt)
    toks = rng.integers(0, jm.cfg.vocab_size, (1, n_prompt)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tc["wkv"].numpy(), np.asarray(jc["wkv"]),
                               rtol=2e-5, atol=2e-5)
    assert int(tc["pos"]) == n_prompt
    # Slot 1 of a two-slot pool; slot 0 stays free (and runs garbage).
    jpool = jm.merge_slot(jm.init_slot_cache(2, 32), jc, jnp.int32(1))
    tpool = tm.merge_slot(tm.init_slot_cache(2, 32, "cpu"), tc, 1)
    jtok = jnp.zeros((2,), jnp.int32).at[1].set(jm.sample_greedy(jl)[0])
    ttok = torch.zeros(2, dtype=torch.int32)
    ttok[1] = tm.sample_greedy(tl)[0]
    step = jax.jit(jm.decode_step)
    for _ in range(12):
        jl, jpool = step(jp, jtok, jpool)
        tl, tpool = tm.decode_step(tp, ttok, tpool)
        np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl[1]),
                                   rtol=1e-3, atol=1e-3)
        jtok, ttok = jm.sample_greedy(jl), tm.sample_greedy(tl)
        assert int(jtok[1]) == int(ttok[1])
    np.testing.assert_array_equal(tpool["pos"].numpy(),
                                  np.asarray(jpool["pos"]))
    back = tm.gather_slot(tpool, 1)
    assert tuple(back["wkv"].shape) == (tm.cfg.n_layers, 1, 2, 64, 64)


def test_rwkv_fused_round_and_refusals(rwkv_pair):
    _, _, tm, tp = rwkv_pair
    pool = tm.init_slot_cache(2, 16, "cpu")
    tok, pool = tm.decode_step_tokens(tp, torch.tensor([3, 4],
                                                       dtype=torch.int32),
                                      pool)
    assert tok.dtype == torch.int32 and tuple(tok.shape) == (2,)
    assert pool["pos"].tolist() == [1, 1]
    with pytest.raises(NotImplementedError):  # no bucketed rwkv prefill
        tm.prefill(tp, torch.zeros((1, 8), dtype=torch.int32), length=5)
    _, entry = tm.prefill(tp, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(TypeError, match="'tm_x'"):
        tm.merge_slot(pool, dict(entry, tm_x=entry["tm_x"].float()), 0)
