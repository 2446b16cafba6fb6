"""The port's samplers, key stream, speculative verify and verify
attention (``repro_torch.kernels.ops``, ``repro_torch.kernels.keys``,
``repro_torch.models.attention``) against the JAX package's.

* the eight cases of ``tests/test_sampling.py`` on the port's sampler,
  with the port's keys in place of ``jax.random`` keys (the bits differ
  by design, so the distributions are held by the same tolerance bands);
* ``_filtered_logits`` against JAX's within 1e-6;
* the greedy branch of ``speculative_verify`` against JAX's exactly, and
  the sampled branch's first emitted token distributed as the target
  softmax (banded, as ``test_distribution_matches_host_softmax``);
* ``verify_attention``, ``paged_verify_attention`` and
  ``cache_write_window`` against JAX's (f32, within 1e-5; the window
  write exactly, its clamped start included);
* the key stream reproducible from a seed, and its splits, bits and
  uniforms equal to a numpy reimplementation of the same hash (the card
  test ``test_key_stream_bits_equal_the_cpus`` holds the card's bits to
  the CPU's).

All on the CPU (the samplers are plain torch ops on both devices).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import keys, ops
from repro_torch.models import attention as tattn

V = 48          # real vocab
VPAD = 64       # padded vocab (16 padding columns)


def _logits(rng, batch=4, scale=3.0, pad_high=False):
    """Random padded logits (``tests/test_sampling.py``'s): padding low by
    default, or the largest entries to probe the vocab clip."""
    x = rng.normal(size=(batch, VPAD)).astype(np.float32) * scale
    x[:, V:] = 100.0 if pad_high else -1e9
    return torch.from_numpy(x)


def _host_softmax(logits_np, temperature=1.0):
    x = logits_np[:, :V].astype(np.float64) / temperature
    x -= x.max(axis=-1, keepdims=True)
    p = np.exp(x)
    return p / p.sum(axis=-1, keepdims=True)


# -- the eight cases of tests/test_sampling.py --------------------------------


def test_temperature_zero_is_argmax(repro_rng):
    logits = _logits(repro_rng)
    tok = ops.sample_tokens(logits, keys.new_key(0), V, temperature=0.0)
    ref = np.argmax(logits.numpy()[:, :V], axis=-1)
    assert np.array_equal(tok.numpy(), ref)
    assert torch.equal(tok, ops.greedy_sample(logits, V))


def test_vocab_clip_never_samples_padding(repro_rng):
    logits = _logits(repro_rng, pad_high=True)
    for i in range(32):
        tok = ops.sample_tokens(logits, keys.new_key(i), V, temperature=1.5)
        assert torch.all(tok < V)


def test_top_k_draws_stay_in_top_k_set(repro_rng):
    logits = _logits(repro_rng)
    k = 5
    order = np.argsort(-logits.numpy()[:, :V], axis=-1)[:, :k]
    for i in range(32):
        tok = ops.sample_tokens(logits, keys.new_key(i), V, temperature=1.0,
                                top_k=k).numpy()
        for b in range(tok.shape[0]):
            assert tok[b] in order[b]


def test_top_p_mass_cutoff(repro_rng):
    logits = _logits(repro_rng, scale=2.0)
    probs = _host_softmax(logits.numpy())
    top_p = 0.6
    allowed = []
    for b in range(probs.shape[0]):
        order = np.argsort(-probs[b])
        before = np.cumsum(probs[b][order]) - probs[b][order]
        n_keep = max(int((before < top_p).sum()), 1)
        allowed.append(set(order[:n_keep].tolist()))
    for i in range(32):
        tok = ops.sample_tokens(logits, keys.new_key(i), V, temperature=1.0,
                                top_p=top_p).numpy()
        for b in range(tok.shape[0]):
            assert tok[b] in allowed[b]


def test_top_p_zero_keeps_argmax(repro_rng):
    logits = _logits(repro_rng)
    ref = np.argmax(logits.numpy()[:, :V], axis=-1)
    for i in range(8):
        tok = ops.sample_tokens(logits, keys.new_key(i), V, temperature=1.0,
                                top_p=1e-9)
        assert np.array_equal(tok.numpy(), ref)


def test_same_key_bit_reproducible(repro_rng):
    logits = _logits(repro_rng)
    for i in range(8):
        a = ops.sample_tokens(logits, keys.new_key(i), V, temperature=0.8,
                              top_k=7, top_p=0.9)
        b = ops.sample_tokens(logits, keys.new_key(i), V, temperature=0.8,
                              top_k=7, top_p=0.9)
        assert torch.equal(a, b)


def _band(freq, p, n):
    """5 sigma of the binomial sampling error per bucket, floor 0.02
    (``test_distribution_matches_host_softmax``'s band)."""
    tol = np.maximum(5.0 * np.sqrt(p * (1 - p) / n), 0.02)
    assert np.all(np.abs(freq - p) <= tol), (
        f"freq {freq.round(3)} vs softmax {p.round(3)} (tol {tol.round(3)})")


def test_distribution_matches_host_softmax(repro_rng, repro_seed):
    """n draws, one a row of n identical rows (each row's noise is its own
    counters'), against the numpy softmax."""
    vocab, n = 8, 4000
    logits_np = np.zeros((1, vocab), np.float32)
    logits_np[0, :5] = repro_rng.normal(size=5).astype(np.float32) * 1.5
    logits_np[0, 5:] = -50.0
    rows = torch.from_numpy(np.repeat(logits_np, n, axis=0))
    toks = ops.sample_tokens(rows, keys.new_key(repro_seed + 11), vocab,
                             temperature=1.0).numpy()
    freq = np.bincount(toks, minlength=vocab) / n
    x = logits_np[0].astype(np.float64)
    x -= x.max()
    _band(freq, np.exp(x) / np.exp(x).sum(), n)


def test_temperature_sharpens_distribution(repro_rng, repro_seed):
    vocab, n = 8, 2000
    logits_np = repro_rng.normal(size=(1, vocab)).astype(np.float32)
    rows = torch.from_numpy(np.repeat(logits_np, n, axis=0))
    top = int(np.argmax(logits_np[0]))

    def frac_top(temp):
        toks = ops.sample_tokens(rows, keys.new_key(repro_seed + 13), vocab,
                                 temperature=temp).numpy()
        return float((toks == top).mean())

    assert frac_top(0.5) > frac_top(2.0) + 0.05


# -- the filters and the verify against JAX -----------------------------------


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.8, 7, 1.0), (1.3, 0, 0.9), (0.7, 12, 0.6),
    (1.0, 100, 0.999), (0.5, 1, 1.0)])
def test_filtered_logits_equal_jax(repro_rng, temperature, top_k, top_p):
    x = _logits(repro_rng, batch=6)
    got = ops._filtered_logits(x, V, temperature, top_k, top_p)
    want = np.asarray(jops._filtered_logits(jnp.asarray(x.numpy()), V,
                                            temperature, top_k, top_p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_speculative_verify_greedy_equals_jax(repro_rng):
    """The greedy branch takes the argmax over the padded width and clips,
    as ``greedy_sample``: ``out`` and ``n_accept`` equal JAX's exactly,
    with drafts that agree for 0 to k positions."""
    b, k = 6, 4
    t = repro_rng.normal(size=(b, k + 1, VPAD)).astype(np.float32)
    t[..., V:] = -1e9
    t[5, 2, V + 3] = 1e3  # a padded argmax, clipped to V - 1: accepted
    d = repro_rng.normal(size=(b, k, VPAD)).astype(np.float32)
    draft = np.argmax(t[:, :k, :], axis=-1).astype(np.int32)
    draft = np.minimum(draft, V - 1)
    for row in range(k):  # row r rejects at position r; rows k, k+1 accept
        draft[row, row:] = (draft[row, row:] + 1) % V
    key = keys.new_key(3)
    got = ops.speculative_verify(torch.from_numpy(t), torch.from_numpy(d),
                                 torch.from_numpy(draft), key, V,
                                 greedy=True)
    want = jops.speculative_verify(jnp.asarray(t), jnp.asarray(d),
                                   jnp.asarray(draft), jax.random.key(3), V,
                                   greedy=True)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].tolist() == [0, 1, 2, 3, k, k]
    assert int(got[0][5, 2]) == V - 1


def test_speculative_verify_first_token_is_target_distributed(repro_rng,
                                                              repro_seed):
    """Rejection sampling keeps the target's distribution: with each row's
    draft tokens drawn from the draft's filtered softmax, the first
    emitted token of n rows is distributed as the target's filtered
    softmax at position 0 (the banded check)."""
    vocab, k, n = 8, 3, 4000
    temp, top_k = 0.8, 6
    t1 = repro_rng.normal(size=(k + 1, vocab)).astype(np.float32) * 1.5
    d1 = repro_rng.normal(size=(k, vocab)).astype(np.float32) * 1.5
    pd = torch.softmax(ops._filtered_logits(torch.from_numpy(d1), vocab,
                                            temp, top_k, 1.0), -1).numpy()
    draft = np.stack([repro_rng.choice(vocab, size=n,
                                       p=pd[j] / pd[j].sum())
                      for j in range(k)], axis=1).astype(np.int32)
    out, n_acc = ops.speculative_verify(
        torch.from_numpy(np.repeat(t1[None], n, 0)),
        torch.from_numpy(np.repeat(d1[None], n, 0)),
        torch.from_numpy(draft), keys.new_key(repro_seed + 17), vocab,
        temperature=temp, top_k=top_k)
    assert out.dtype == torch.int32 and out.shape == (n, k + 1)
    assert 0 < int(n_acc.float().mean() * 100) and int(n_acc.max()) <= k
    pt = torch.softmax(ops._filtered_logits(torch.from_numpy(t1[:1]), vocab,
                                            temp, top_k, 1.0),
                       -1).double().numpy()[0]
    _band(np.bincount(out[:, 0].numpy(), minlength=vocab) / n, pt, n)


def _attn_inputs(rng, b=3, w=5, s=24, h=4, kv=2, d=8):
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return f(b, w, h, d), f(b, s, kv, d), f(b, s, kv, d)


def test_verify_attention_equals_jax(repro_rng):
    q, kc, vc = _attn_inputs(repro_rng)
    lens = np.array([0, 7, 19], np.int32)
    got = ops.verify_attention(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), torch.from_numpy(lens))
    want = jops.verify_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_paged_verify_attention_equals_jax(repro_rng):
    q, _, _ = _attn_inputs(repro_rng)
    kp = repro_rng.normal(size=(10, 4, 2, 8)).astype(np.float32)
    vp = repro_rng.normal(size=(10, 4, 2, 8)).astype(np.float32)
    tables = np.array([[3, 1, 7, 0, 0, 0], [2, 4, 5, 6, 0, 0],
                       [9, 8, 0, 0, 0, 0]], np.int32)
    lens = np.array([6, 13, 2], np.int32)
    got = ops.paged_verify_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens))
    want = jops.paged_verify_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_cache_write_window_equals_jax_and_clamps(repro_rng):
    """Rows ``start .. start+W-1`` written in place; a start past ``C - W``
    (a free continuous slot's position running ahead) clamps to the last
    W rows, as XLA's ``dynamic_update_slice``."""
    cache = repro_rng.normal(size=(3, 12, 2, 4)).astype(np.float32)
    new = repro_rng.normal(size=(3, 5, 2, 4)).astype(np.float32)
    start = np.array([0, 6, 11], np.int32)
    got = torch.from_numpy(cache.copy())
    out = tattn.cache_write_window(got, torch.from_numpy(new),
                                   torch.from_numpy(start))
    want = jattn.cache_write_window(jnp.asarray(cache), jnp.asarray(new),
                                    jnp.asarray(start))
    assert out is got
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy()[2, 7:], new[2])


# -- the key stream ---------------------------------------------------------------

M = np.uint64(0xFFFFFFFF)


def _np_hash32(x):
    """lowbias32 in uint64 numpy arithmetic (products wrap mod 2**64; the
    low 32 bits are the 32-bit product)."""
    x = x & M
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & M
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & M
    return x ^ (x >> np.uint64(16))


def _np_bits(key, n):
    c = np.arange(n, dtype=np.uint64)
    return _np_hash32(_np_hash32(c ^ key[0]) ^ key[1])


def _np_key(seed):
    root = np.array([(seed & 0xFFFFFFFF) ^ 0x243F6A88,
                     ((seed >> 32) & 0xFFFFFFFF) ^ 0x85A308D3], np.uint64)
    return _np_bits(root, 2)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 7, 2**40 + 3])
def test_key_stream_equals_numpy_hash(seed):
    key = keys.new_key(seed)
    want = _np_key(seed)
    assert key.dtype == torch.int64 and key.shape == (2,)
    assert np.array_equal(key.numpy().astype(np.uint64), want)
    split = keys.split(key, 5)
    assert np.array_equal(split.numpy().astype(np.uint64).ravel(),
                          _np_bits(want, 10))
    b = keys.bits(key, torch.arange(1000))
    assert np.array_equal(b.numpy().astype(np.uint64), _np_bits(want, 1000))
    u = keys.uniform(key, (10, 100))
    top = (_np_bits(want, 1000) >> np.uint64(8)).astype(np.float64)
    want_u = np.maximum(top * 2.0 ** -24, 2.0 ** -24).reshape(10, 100)
    assert np.array_equal(u.numpy().astype(np.float64), want_u)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    g = keys.gumbel(key, (10, 100)).double().numpy()
    np.testing.assert_allclose(g, -np.log(-np.log(want_u)), rtol=1e-6,
                               atol=1e-6)


def test_key_advance_is_split_in_place_and_reproducible():
    a, b = keys.new_key(7), keys.new_key(7)
    assert torch.equal(a, b) and not torch.equal(a, keys.new_key(8))
    want = keys.split(a.clone(), 2)
    buf = a.data_ptr()
    sub = keys.advance(a)
    assert a.data_ptr() == buf
    assert torch.equal(a, want[0]) and torch.equal(sub, want[1])
    stream_a = [keys.advance(a).clone() for _ in range(50)]
    keys.advance(b)
    stream_b = [keys.advance(b).clone() for _ in range(50)]
    assert all(torch.equal(x, y) for x, y in zip(stream_a, stream_b))
    assert len({tuple(x.tolist()) for x in stream_a}) == 50
