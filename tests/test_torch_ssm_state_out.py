"""The selective scan's ``state_out`` contract, on the CPU: the final state
written into a buffer the caller gives (``state`` itself, or a buffer
apart from it), and the hybrid model's prefill and decode round scanning
straight into the pool's layer view of the SSM state.

The plain scan with ``state_out`` is held against the JAX package's
``ops.ssm_scan`` (xla path) on the same numpy inputs, at 2e-5 in f32 (sums
in another order) and 2e-2 in bf16 (outputs round to bf16), as
``test_torch_hybrid.py`` holds it; ``state_out`` against ``state_out=None``
bit for bit (the same plain scan, then a copy).  The CUDA kernels' side of
the contract (in place == out of place bit for bit, 16-byte alignment) is
in ``test_torch_gpu.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, b, s, h, d, n, dtype):
    """x, dt, a_log, b, c, state as numpy f32, then in both frameworks (x,
    dt, b and c in ``dtype``; a_log and the state f32)."""
    xs = [rng.normal(size=(b, s, h, d)),
          np.abs(rng.normal(size=(b, s, h)) * 0.1),
          rng.normal(size=(h, n)) * 0.2,
          rng.normal(size=(b, s, h, n)), rng.normal(size=(b, s, h, n)),
          rng.normal(size=(b, h, d, n))]
    xs = [x.astype(np.float32) for x in xs]
    jd, td = DTYPES[dtype]
    cast = (True, True, False, True, True, False)
    jx = [jnp.asarray(x).astype(jd) if c else jnp.asarray(x)
          for x, c in zip(xs, cast)]
    tx = [torch.from_numpy(x).to(td) if c else torch.from_numpy(x)
          for x, c in zip(xs, cast)]
    return jx, tx


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("where", ["none", "apart", "in_place"])
@pytest.mark.parametrize("s", [1, ssm_scan.CHUNKED_MIN_S + 1])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_scan_state_out_matches_jax(where, s, dtype):
    """No ``state_out``, a buffer apart from the state, and the state
    itself give the same y and final state (bit for bit), which match
    JAX; the returned state is ``state_out`` where one was given, and an
    apart buffer leaves the input state as it was."""
    rng = np.random.default_rng(900 + s)
    jx, tx = _inputs(rng, 2, s, 3, 16, 8, dtype)
    want_y, want_st = ssm_scan.ssm_scan_plain(*tx)
    state = tx[5].clone()
    out = {"none": None, "apart": torch.full_like(state, float("nan")),
           "in_place": state}[where]
    y, st = ssm_scan.ssm_scan(*tx[:5], state, state_out=out)
    if out is not None:
        assert st is out
    if where == "apart":
        assert torch.equal(state, tx[5])
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    jy, js = jops.ssm_scan(*jx, backend="xla")
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), **_tol(dtype))
    np.testing.assert_allclose(st.numpy(), np.asarray(js), **_tol(dtype))


def _state_out_cases(tx):
    """(label, state, state_out) that the scan must refuse."""
    state = tx[5]
    big = torch.zeros((2 * state.numel(),))
    half = state.numel() // 2
    x32 = torch.zeros((state.numel() + 8,))
    return [
        ("partial overlap", big[:state.numel()].view(state.shape),
         big[half:half + state.numel()].view(state.shape)),
        ("overlap one element", big[:state.numel()].view(state.shape),
         big[state.numel() - 1:2 * state.numel() - 1].view(state.shape)),
        ("wrong shape", state, torch.zeros(state.shape[:-1] + (2,))),
        ("wrong dtype", state, torch.zeros(state.shape,
                                           dtype=torch.float64)),
        ("not contiguous", state,
         torch.zeros(state.shape[::-1]).permute(3, 2, 1, 0)),
        ("overlaps x", state, x32[:state.numel()].view(state.shape)),
    ], x32


@pytest.mark.parametrize("case", range(6))
def test_ssm_scan_refuses_bad_state_out(case):
    """A ``state_out`` that overlaps the state in part (even by one
    element), has the wrong shape or dtype, is not contiguous, or overlaps
    an input (here x, in f32) raises ``ValueError`` and writes nothing."""
    rng = np.random.default_rng(31)
    _, tx = _inputs(rng, 1, 2, 2, 16, 8, "f32")
    cases, x32 = _state_out_cases(tx)
    label, state, out = cases[case]
    state.copy_(tx[5])
    x = x32[:tx[0].numel()].view(tx[0].shape) if label == "overlaps x" \
        else tx[0]
    before = out.clone()
    with pytest.raises(ValueError, match="state_out"):
        ssm_scan.ssm_scan(x, *tx[1:5], state, state_out=out)
    assert torch.equal(out, before)


# -- the hybrid model scans into its pool ------------------------------------


@pytest.fixture(scope="module")
def hybrid_pair():
    jcfg = jax_config("hymba-1.5b", reduced=True)
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(9)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


def _spy(monkeypatch):
    """Record (state, state_out) of every ``ops.ssm_scan`` call, then run
    the real scan."""
    calls, real = [], ops.ssm_scan

    def spy(*args, state_out=None):
        calls.append((args[5], state_out, args[5].clone()))
        return real(*args, state_out=state_out)

    monkeypatch.setattr(ops, "ssm_scan", spy)
    return calls


def test_hybrid_prefill_scans_into_the_cache(hybrid_pair, monkeypatch):
    """Each layer's scan starts from a zero state held apart and writes
    its final state into that layer's view of the returned cache; the
    cache's state matches JAX's."""
    jm, jp, tm, tp = hybrid_pair
    calls = _spy(monkeypatch)
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (2, 6)).astype(np.int32)
    _, cache = tm.prefill(tp, torch.from_numpy(toks), max_len=16)
    assert len(calls) == tm.cfg.n_layers
    for i, (state, out, seen) in enumerate(calls):
        view = cache["ssm"][i]
        assert out.data_ptr() == view.data_ptr() and out.shape == view.shape
        assert state.data_ptr() != out.data_ptr()
        assert not torch.any(seen)
    _, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len=16))(
        jp, jnp.asarray(toks))
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(jc["ssm"]),
                               rtol=2e-5, atol=2e-5)


def test_hybrid_decode_step_scans_the_pool_in_place(hybrid_pair,
                                                    monkeypatch):
    """Each layer's scan in a decode round takes the pool's layer view as
    both ``state`` and ``state_out``: the pool is updated where it lies
    (the same storage before and after), and matches JAX's round."""
    jm, jp, tm, tp = hybrid_pair
    toks = np.random.default_rng(5).integers(
        0, jm.cfg.vocab_size, (1, 5)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len=16))(
        jp, jnp.asarray(toks))
    _, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=16)
    jpool = jm.merge_slot(jm.init_slot_cache(2, 16), jc, jnp.int32(0))
    pool = tm.merge_slot(tm.init_slot_cache(2, 16, "cpu"), tc, 0)
    ptr = pool["ssm"].data_ptr()
    tok = np.array([int(jm.sample_greedy(jl)[0]), 7], np.int32)
    calls = _spy(monkeypatch)
    _, pool = tm.decode_step(tp, torch.from_numpy(tok), pool)
    _, jpool = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jpool)
    assert len(calls) == tm.cfg.n_layers
    assert pool["ssm"].data_ptr() == ptr
    for i, (state, out, _) in enumerate(calls):
        assert state is out
        assert out.data_ptr() == pool["ssm"][i].data_ptr()
    np.testing.assert_allclose(pool["ssm"].numpy(),
                               np.asarray(jpool["ssm"]), rtol=1e-3,
                               atol=1e-3)
