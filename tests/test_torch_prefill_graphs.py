"""The buffer-driven admission of the port's engine against its host-index
forms and the JAX package, on the CPU: the prefill with the true length
in a device tensor, ``merge_slot`` at a device slot, ``append_paged``
through a fixed-shape row with a sink block, and the engine's greedy
streams across prompt buckets (eager here; one CUDA graph per instance
and bucket on the card, ``serving/graphs.py``).

Both packages run f32 params (the tiny config; bf16 or int8 KV pools).
Tolerances:
* device-length vs host-int prefill, device vs host-index merge and
  append: bit for bit (the same ops on the same values);
* port vs JAX prefill logits 2e-5 (``tests/test_kernels.py:23-25``, f32:
  sums in another order); K/V leaves and pages 2e-2 (bf16 pools: an f32
  value an ulp apart can round to neighbouring bf16 values);
* engine streams: identical tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro.core.resources import Alloc as JaxAlloc
from repro.models import build_model as jax_build
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import _ROW

torch.set_num_threads(2)

FULL = dict(sm=1.0, quota_request=0.9, quota_limit=0.9)
MAX_LEN, BS = 48, 8
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _pair(name, seed=0):
    """JAX and port models of the tiny config under ``name`` (a name per
    int8 variant, so no JAX trace made under the other gate is reused),
    f32 params bridged."""
    jcfg = tiny_config(name=name)
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(seed)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


@pytest.fixture(params=[False, True], ids=["bf16", "int8"])
def int8(request, monkeypatch):
    """The int8-KV gate, for the JAX side (the port pins it per call)."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if request.param else "0")
    return request.param


def _padded(vocab, n, width=16, seed=1):
    tokens = np.zeros((1, width), np.int32)
    tokens[0, :n] = np.random.default_rng(seed).integers(0, vocab, n)
    return tokens


def _random_like(pool, seed):
    """The pool's leaves filled with random values of their own dtype."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for key, leaf in pool.items():
        if leaf.dtype in (torch.int8, torch.int32):
            hi = 127 if leaf.dtype == torch.int8 else 1000
            out[key] = torch.randint(-hi, hi, leaf.shape, generator=g,
                                     dtype=leaf.dtype)
        else:
            out[key] = torch.randn(leaf.shape, generator=g).to(leaf.dtype)
    return out


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


# -- the prefill's length in a device tensor --------------------------------


@pytest.mark.parametrize("n", [1, 5, 11, 16])
def test_prefill_device_length_equals_host_int_and_jax(int8, n):
    """``transformer.prefill`` with ``length`` a 0-d int32 tensor gives the
    host-int form's logits and cache bit for bit, and JAX's
    ``prefill(length=n)`` within the stated tolerances, over a bucket of
    16 (n = 16: the bucket is full)."""
    jm, jp, tm, tp = _pair(f"tiny-prefill-len-{int(int8)}")
    tokens = _padded(jm.cfg.vocab_size, n)
    jl, jc = jax.jit(lambda p, t, k: jm.prefill(p, t, max_len=MAX_LEN,
                                                length=k))(
        jp, jnp.asarray(tokens), jnp.int32(n))
    t = torch.from_numpy(tokens)
    hl, hc = tm.prefill(tp, t, max_len=MAX_LEN, length=n, kv_int8=int8)
    dl, dc = tm.prefill(tp, t, max_len=MAX_LEN,
                        length=torch.tensor(n, dtype=torch.int32),
                        kv_int8=int8)
    assert torch.equal(dl, hl)
    assert set(dc) == set(hc) == set(jc)
    for key in hc:
        assert dc[key].dtype == hc[key].dtype and torch.equal(dc[key],
                                                              hc[key]), key
    assert dc["pos"].shape == () and int(dc["pos"]) == n == int(jc["pos"])
    np.testing.assert_allclose(dl.numpy(), np.asarray(jl), **F32)
    for key in ("k", "v") + (("k_scale", "v_scale") if int8 else ()):
        np.testing.assert_allclose(dc[key].float().numpy(),
                                   np.asarray(jc[key], np.float32), **BF16)
    assert (dc["k"].dtype == torch.int8) == int8


# -- merge_slot at a device slot, append_paged through a sink ----------------


def _serving_model(family):
    """A port model and bf16 weights drawn on the CPU: the tiny dense
    config (bf16 or int8 pools) or the reduced rwkv6 / hymba configs, whose
    slot caches hold recurrent state and rolled rows."""
    if family.startswith("dense"):
        cfg = ModelConfig(**dataclasses.asdict(tiny_config()))
    else:
        cfg = get_config(family, reduced=True)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("family", ["dense", "dense-int8", "rwkv6-1.6b",
                                    "hymba-1.5b"])
def test_merge_slot_device_index_equals_host_int(family):
    """A prefill entry merged at a (1,) int64 slot tensor equals the
    host-int merge leaf by leaf, over a pool of random contents; the other
    slots keep theirs."""
    model, params = _serving_model(family)
    kv_int8 = family == "dense-int8"
    tokens = torch.from_numpy(_padded(model.cfg.vocab_size, 9, width=9))
    _, entry = model.prefill(params, tokens, max_len=MAX_LEN,
                             kv_int8=kv_int8)
    pool = _random_like(model.init_slot_cache(3, MAX_LEN, "cpu", kv_int8),
                        seed=2)
    host = model.merge_slot(_clone(pool), entry, 1)
    dev = model.merge_slot(_clone(pool), entry, torch.tensor([1]))
    for key, leaf in pool.items():
        assert torch.equal(dev[key], host[key]), key
        axis = 0 if key == "pos" else 1
        for other in (0, 2):
            assert torch.equal(dev[key].select(axis, other),
                               leaf.select(axis, other)), (key, other)
    assert int(dev["pos"][1]) == int(entry["pos"])


def test_append_paged_sink_row_equals_write_mask(int8):
    """A full-width append row whose masked blocks point at the sink block
    (index ``n_blocks`` of an ``n_blocks + 1`` pool) writes every
    allocator-owned block as the host-mask form does, bit for bit, over
    pools of random contents, and leaves the blocks outside the request's
    row as they were; from zeroed pools it equals JAX's append through its
    drop sentinel."""
    jm, jp, tm, tp = _pair(f"tiny-append-sink-{int(int8)}")
    tokens = _padded(jm.cfg.vocab_size, 11)
    _, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len=MAX_LEN,
                                            length=11))(jp,
                                                        jnp.asarray(tokens))
    _, tc = tm.prefill(tp, torch.from_numpy(tokens), max_len=MAX_LEN,
                       length=11, kv_int8=int8)
    n_blocks, m = 9, MAX_LEN // BS
    row = np.array([3, 1, 4, 2, 0, 0], np.int32)  # 4 blocks hold 27 rows
    write = np.arange(m) < 2  # a request holding 2 of them writes 2
    sink_row = torch.from_numpy(np.where(write, row, n_blocks).astype(
        np.int64))
    pool = _random_like(tm.init_paged_cache(n_blocks + 1, BS, "cpu",
                                            kv_int8=int8), seed=3)
    host = tm.append_paged(_clone(pool), tc, row, write)
    dev = tm.append_paged(_clone(pool), tc, sink_row)
    kept = [b for b in range(n_blocks) if b not in row[write]]
    for key, leaf in pool.items():
        assert torch.equal(dev[key][:, :n_blocks], host[key][:, :n_blocks])
        assert torch.equal(dev[key][:, kept], leaf[:, kept]), key
        assert not torch.equal(dev[key][:, n_blocks], leaf[:, n_blocks])
    jpages = jm.append_paged(jm.init_paged_cache(n_blocks, BS), jc,
                             jnp.asarray(np.where(write, row, n_blocks),
                                         jnp.int32))
    tpages = tm.append_paged(tm.init_paged_cache(n_blocks + 1, BS, "cpu",
                                                 kv_int8=int8), tc, sink_row)
    for key in jpages:
        np.testing.assert_allclose(
            tpages[key][:, :n_blocks].float().numpy(),
            np.asarray(jpages[key], np.float32), **BF16)


# -- the engine's admissions across buckets ----------------------------------


# (prompt length, new tokens).  The first pass admits three prompts of
# bucket 8 (one done by its prefill, whose slot stays free in the pass)
# and one of bucket 16; later passes admit buckets 32, 4 and 16 mid-flight.
ARRIVALS = [(5, 4), (7, 1), (6, 3), (12, 5), (20, 3), (3, 6), (16, 2),
            (9, 4)]


def _kw(batching, **kw):
    out = dict(max_batch=4, max_len=32)
    if batching == "paged":
        out["block_size"] = 8
    return {**out, **kw}


def _serve(eng, arrivals):
    reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    assert eng.pump(budget_s=120.0) == len(reqs)
    assert all(r.done and len(r.tokens_out) == r.max_new_tokens
               for r in reqs)
    return [r.tokens_out for r in reqs]


def _prompts(seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, l, dtype=np.int32), n)
            for l, n in ARRIVALS]


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_engine_streams_across_buckets_match_fused_false_and_jax(
        int8, batching):
    """The buffer-driven admission (fused) emits the streams of the eager
    host-argmax admission (``fused=False``) and of the JAX engine, with
    prompts in buckets 4, 8, 16 and 32, three of one bucket admitted in one
    pass and one of them done at prefill; on the CPU every admission runs
    eagerly through the prefill graphs' body."""
    jm, jp, tm, tp = _pair(f"tiny-buckets-{int(int8)}")
    arrivals = _prompts()
    jeng = JaxEngine(window=0.1)
    jeng.deploy("f", jm, jp, JaxAlloc(**FULL), batching=batching,
                prefix_sharing=False, **_kw(batching))
    want = _serve(jeng, arrivals)
    fused = ServingEngine(window=0.1, device="cpu")
    fused.deploy("f", tm, tp, Alloc(**FULL), batching=batching,
                 **_kw(batching))
    host = ServingEngine(window=0.1, device="cpu")
    host.deploy("f", tm, tp, Alloc(**FULL), batching=batching,
                **_kw(batching, fused=False))
    (inst,) = fused.instances.values()
    first_pass = []
    admit = inst._admit_fused

    def logged(slot, req, done):
        if not inst.steps > 1:
            first_pass.append((len(req.prompt), done))
        return admit(slot, req, done)

    inst._admit_fused = logged
    assert _serve(fused, arrivals) == want
    assert _serve(host, arrivals) == want
    assert first_pass == [(5, False), (7, True), (6, False), (12, False)]
    assert inst.kv_int8 == int8 and inst.refills > 0
    pg = inst.prefill_graphs
    assert sorted(pg.by_bucket) == [4, 8, 16, 32]
    assert pg.eager == inst.prefills == len(arrivals)
    (stats,) = fused.telemetry().values()
    assert stats["prefill_captures"] == stats["prefill_replays"] == 0
    assert stats["syncs"] == stats["steps"]
    assert next(iter(host.instances.values())).prefill_graphs is None


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_admission_buffers_keep_their_addresses(batching):
    """What a captured admission needs: the argument buffer, its staging
    rows, the pending and slot tokens, the KV pools and (paged) the state
    buffer the tables, positions and active mask view are the same storage
    at every admission, refilled in place."""
    _, _, tm, tp = _pair("tiny-addresses")
    eng = ServingEngine(window=0.1, device="cpu")
    eng.deploy("f", tm, tp, Alloc(**FULL), batching=batching,
               **_kw(batching))
    for p, n in _prompts(seed=2):
        eng.submit("f", p, max_new_tokens=n)
    (inst,) = eng.instances.values()

    def buffers():
        bufs = {"args": inst._args, "stage": inst._args_stage,
                "pending": inst._pending_dev, "tok": inst._slot_tok_dev,
                **{f"cache.{k}": v for k, v in inst.cache.items()}}
        if batching == "paged":
            bufs.update(state=inst._state_dev, tables=inst._tables_dev,
                        pos=inst._pos_dev, active=inst._active_dev)
        return {k: v.data_ptr() for k, v in bufs.items()}

    inst.run_step()
    first, args = buffers(), [inst._args.clone()]
    while eng.has_work():
        prefills = inst.prefills
        inst.run_step()
        assert buffers() == first
        if inst.prefills > prefills:
            args.append(inst._args.clone())
    assert len(args) > 2
    assert all(not torch.equal(a, b) for a, b in zip(args, args[1:]))


def test_sink_block_is_outside_the_byte_accounting():
    """The paged pools hold one block past the allocator's: the sink, which
    admissions write (their padding blocks) and no table names.  The KV
    byte accessors count the allocator's blocks only, in lockstep with
    the JAX engine's."""
    jm, jp, tm, tp = _pair("tiny-sink")
    arrivals = _prompts(seed=4)
    jeng = JaxEngine(window=0.1)
    jeng.deploy("f", jm, jp, JaxAlloc(**FULL), batching="paged",
                prefix_sharing=False, **_kw("paged"))
    teng = ServingEngine(window=0.1, device="cpu")
    teng.deploy("f", tm, tp, Alloc(**FULL), batching="paged",
                **_kw("paged"))
    for eng in (jeng, teng):
        for p, n in arrivals:
            eng.submit("f", p, max_new_tokens=n)
    (ji,), (ti,) = jeng.instances.values(), teng.instances.values()
    sink = ti.allocator.n_blocks
    sent = 0  # admissions whose append row sends blocks to the sink
    while teng.has_work():
        for i in (ji, ti):
            i.run_step()
        assert (ti.kv_bytes_in_use(), ti.kv_bytes_peak,
                ti.dense_kv_reserved(), ti.kv_bytes_saved()) == (
            ji.kv_bytes_in_use(), ji.kv_bytes_peak, ji.dense_kv_reserved(),
            ji.kv_bytes_saved())
        assert int(ti._tables_dev.max()) < sink
        sent += bool((ti._args[_ROW:ti._tok0] == sink).any())
    assert not jeng.has_work()
    assert ti.cache["k"].shape[1] == sink + 1 and sent > 2
    assert ti.kv_bytes_peak <= ti.allocator.capacity * ti.allocator.block_bytes
