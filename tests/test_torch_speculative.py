"""Speculative decoding and sampling in the port's engine
(``repro_torch.serving.speculative`` under ``FunctionInstance``) against
the JAX engine, on the CPU:

* the engine cases of ``tests/test_speculative_decoding.py``: greedy
  streams with ``speculate`` equal the JAX engine's greedy streams
  without it, continuous and paged, with draft == target (acceptance 1.0)
  and with a disagreeing draft (``spec_accepted < spec_proposed``, the
  streams still equal), one host sync per pass; the proposal and
  acceptance counts equal the JAX engine's speculating run;
* sampled fused streams equal ``fused=False`` streams bit for bit (tiny
  continuous and paged, reduced rwkv6-1.6b and hymba-1.5b), with syncs
  equal to steps (the port's key stream is not ``jax.random``'s, so
  sampled streams are compared within the port only);
* ``verify_step(_paged)``'s logits against JAX's and against k+1
  sequential ``decode_step`` logits on a copy of the cache;
* copy-on-write over a speculative window on shared prompts, the submit
  margin, the JAX refusals, ``export_slot`` refusing a speculating slot,
  the draft pool in the instance's bytes and released at close;
* ``test_prefix_cow_properties.py::test_speculative_rollback_never_frees_
  or_corrupts`` on the port's ``PageTable``.

Tolerance: identical token streams and counts; f32 logits within 1e-4
of JAX's on the same bf16 cache, within 1e-5 of sequential decode steps.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import tiny_config
from repro.core.resources import Alloc as JaxAlloc
from repro.models import build_model as jax_build
from repro.serving import ServingEngine as JaxEngine
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.resources import Alloc
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ServingEngine
from repro_torch.serving.paging import (KVPageAllocator, PageTable,
                                        prompt_digests)
from repro_torch.serving.speculative import SamplingConfig, SpecConfig

torch.set_num_threads(2)
FULL = dict(sm=1.0, quota_request=0.9, quota_limit=0.9)
SAMPLED = SamplingConfig(temperature=0.8, top_k=12, top_p=0.9, seed=5)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


@pytest.fixture(scope="module")
def models():
    """The tiny config in both packages, f32: the target, a disagreeing
    draft (another init, ``test_speculative_decoding.py``'s key 999) and
    their bridges."""
    jcfg = tiny_config()
    jm = jax_build(jcfg)
    jp = _f32(jm.init(jax.random.key(1234)))
    jd = _f32(jm.init(jax.random.key(999)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return dict(jm=jm, jp=jp, jd=jd, tm=tm,
                tp=bridge.to_torch(jax.device_get(jp)),
                td=bridge.to_torch(jax.device_get(jd)))


def _prompts(vocab, n=4, plen=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen, dtype=np.int32) for _ in range(n)]


def _run(pkg, models, *, batching="continuous", fused=True, sampling=None,
         k=None, draft=None, max_new=9, prompts=None, model=None,
         params=None, max_batch=2):
    """Serve the workload of ``test_speculative_decoding.py::_run`` on one
    engine; returns (token streams, telemetry of its instance)."""
    torch_side = pkg == "torch"
    model = model or (models["tm"] if torch_side else models["jm"])
    params = params if params is not None else (
        models["tp"] if torch_side else models["jp"])
    kw = {}
    if k is not None:
        cfg = model.cfg
        kw = dict(speculate=(SpecConfig if torch_side else JaxSpecConfig)(
            draft_cfg=cfg, k=k), draft_params=draft)
    if torch_side:
        eng = ServingEngine(window=0.1, device="cpu")
        alloc = Alloc(**FULL)
    else:
        eng = JaxEngine(window=0.1)
        alloc = JaxAlloc(**FULL)
    eng.deploy("lm", model, params, alloc, n_instances=1,
               max_batch=max_batch, max_len=64, batching=batching,
               fused=fused, sampling=sampling, **kw)
    prompts = prompts or _prompts(model.cfg.vocab_size)
    reqs = [eng.submit("lm", p, max_new_tokens=max_new) for p in prompts]
    assert eng.pump(budget_s=300.0) == len(reqs)
    assert all(r.done and len(r.tokens_out) == max_new for r in reqs)
    return ([list(r.tokens_out) for r in reqs],
            list(eng.telemetry().values())[0])


def _spec_counts(tele):
    return tele["spec_proposed"], tele["spec_accepted"]


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_spec_greedy_equals_jax_draft_equals_target(models, batching):
    base, _ = _run("jax", models, batching=batching)
    out, tele = _run("torch", models, batching=batching, k=4,
                     draft=models["tp"])
    assert out == base
    assert tele["syncs"] == tele["steps"]
    assert tele["spec_proposed"] > 0
    assert tele["spec_accepted"] == tele["spec_proposed"]
    jout, jtele = _run("jax", models, batching=batching, k=4,
                       draft=models["jp"])
    assert jout == out and _spec_counts(jtele) == _spec_counts(tele)


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_spec_greedy_equals_jax_any_draft(models, batching):
    """A disagreeing draft: rejections and rollbacks, the same streams."""
    base, _ = _run("jax", models, batching=batching)
    out, tele = _run("torch", models, batching=batching, k=3,
                     draft=models["td"])
    assert out == base
    assert tele["syncs"] == tele["steps"]
    assert tele["spec_accepted"] < tele["spec_proposed"]
    _, jtele = _run("jax", models, batching=batching, k=3,
                    draft=models["jd"])
    assert _spec_counts(jtele) == _spec_counts(tele)


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_sampled_fused_equals_host_reference(models, batching):
    fused, tele = _run("torch", models, batching=batching, sampling=SAMPLED)
    host, htele = _run("torch", models, batching=batching, fused=False,
                       sampling=SAMPLED)
    greedy, _ = _run("torch", models, batching=batching)
    assert fused == host and fused != greedy
    assert tele["syncs"] == tele["steps"]
    assert htele["syncs"] > htele["steps"]  # one per round and prompt
    again, _ = _run("torch", models, batching=batching, sampling=SAMPLED)
    other, _ = _run("torch", models, batching=batching,
                    sampling=dataclasses.replace(SAMPLED, seed=6))
    assert again == fused and other != fused


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_sampled_speculation_is_reproducible(models, batching):
    """Sampled speculation (no ``fused=False`` reference, as in JAX): the
    same seed gives the same streams, one sync per pass, ids in vocab."""
    a, tele = _run("torch", models, batching=batching, sampling=SAMPLED,
                   k=3, draft=models["td"])
    b, _ = _run("torch", models, batching=batching, sampling=SAMPLED, k=3,
                draft=models["td"])
    assert a == b and tele["syncs"] == tele["steps"]
    assert max(max(s) for s in a) < models["tm"].cfg.vocab_size
    assert 0 < tele["spec_proposed"]


def test_spec_off_reference_unchanged(models):
    base, _ = _run("torch", models)
    host, _ = _run("torch", models, fused=False)
    assert base == host == _run("jax", models)[0]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_sampled_generic_families_fused_equals_host(arch):
    """rwkv6 and the hybrid sample through the same sampler as the dense
    family (``Model.decode_step_tokens``): fused == ``fused=False`` bit
    for bit, syncs == steps."""
    model = build_model(get_config(arch, reduced=True))
    params = model.init(torch.Generator().manual_seed(3))
    sampling = SamplingConfig(temperature=0.9, top_k=8, seed=7)
    prompts = _prompts(model.cfg.vocab_size, n=2)
    kw = dict(model=model, params=params, max_new=6, prompts=prompts,
              sampling=sampling)
    fused, tele = _run("torch", None, **kw)
    host, _ = _run("torch", None, fused=False, **kw)
    assert fused == host
    assert tele["syncs"] == tele["steps"]


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_verify_step_equals_jax_and_sequential_decode(models, batching):
    """The W = k+1 verify forward's logits against JAX's verify step on
    the same bf16 cache (the port's pools are bf16; JAX's follow the
    params' dtype, so its cache is given the port's bf16 rows), and
    against k+1 sequential decode steps on a copy: ``logits[:, j]``
    scores the token after window position j."""
    tm, jm, k = models["tm"], models["jm"], 3
    prompts = np.stack(_prompts(64, n=2, plen=5))
    window = np.random.default_rng(1).integers(0, 64, (2, k + 1),
                                               dtype=np.int32)
    _, entry = tm.prefill(models["tp"], torch.from_numpy(prompts),
                          max_len=32)
    pos = np.array([5, 5], np.int32)
    cache = {key: v.clone() for key, v in entry.items()}
    cache["pos"] = torch.from_numpy(pos)

    def to_jax(tree):
        return {key: jnp.asarray(bridge.to_numpy(v)).astype(jnp.bfloat16)
                for key, v in tree.items() if key != "pos"}

    if batching == "paged":
        # Pages of 8: each sequence's 4 logical blocks at scattered pages.
        tables = np.array([[3, 1, 6, 8], [2, 7, 4, 5]], np.int32)
        pages = {key: torch.zeros((v.shape[0], 9, 8, *v.shape[3:]),
                                  dtype=v.dtype)
                 for key, v in entry.items() if key != "pos"}
        for key, v in pages.items():
            for b in range(2):
                v[:, tables[b]] = entry[key][:, b].reshape(
                    v.shape[0], 4, 8, *v.shape[3:])
        jpages = to_jax(pages)
        got, _ = tm.verify_step_paged(models["tp"], torch.from_numpy(window),
                                      pages, torch.from_numpy(tables),
                                      torch.from_numpy(pos))
        want, _ = jm.verify_step_paged(models["jp"], jnp.asarray(window),
                                       jpages, jnp.asarray(tables),
                                       jnp.asarray(pos))
    else:
        jcache = dict(to_jax(cache), pos=jnp.asarray(pos))
        got, _ = tm.verify_step(models["tp"], torch.from_numpy(window),
                                cache)
        want, _ = jm.verify_step(models["jp"], jnp.asarray(window), jcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    seq = {key: v.clone() for key, v in entry.items()}
    seq["pos"] = torch.from_numpy(pos)
    for j in range(k + 1):
        logits, seq = tm.decode_step(models["tp"],
                                     torch.from_numpy(window[:, j]), seq)
        np.testing.assert_allclose(got[:, j].numpy(), logits.numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_spec_over_shared_prompts_resolves_cow_for_the_window(models):
    """Paged with prefix sharing and a speculating instance: exact
    duplicate prompts share their tail block, every window's rows are
    made private before the round writes (span 1 + k), and the streams,
    sharing hits and copies equal the JAX engine's."""
    prompts = [np.arange(13, dtype=np.int32)] * 2 + \
        [np.arange(20, dtype=np.int32) % 64] * 2
    got = _run("torch", models, batching="paged", k=4, draft=models["td"],
               prompts=prompts, max_batch=4)
    want = _run("jax", models, batching="paged", k=4, draft=models["jd"],
                prompts=prompts, max_batch=4)
    base, _ = _run("jax", models, batching="paged", prompts=prompts,
                   max_batch=4)
    assert got[0] == want[0] == base
    for key in ("shared_hits", "cow", "spec_proposed", "spec_accepted"):
        assert got[1][key] == want[1][key], key
    assert got[1]["cow"] > 0


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_submit_reserves_the_speculation_margin(models, pkg):
    """A request whose prompt + new tokens fit ``max_len`` but not with
    the k rows a last window can write past them is refused at submit."""
    eng = ServingEngine(window=0.1, device="cpu") if pkg == "torch" \
        else JaxEngine(window=0.1)
    model, params, alloc, spec = (
        (models["tm"], models["tp"], Alloc(**FULL), SpecConfig)
        if pkg == "torch" else
        (models["jm"], models["jp"], JaxAlloc(**FULL), JaxSpecConfig))
    eng.deploy("lm", model, params, alloc, max_len=32, batching="paged",
               speculate=spec(draft_cfg=model.cfg, k=4),
               draft_params=params)
    eng.submit("lm", np.arange(20, dtype=np.int32), max_new_tokens=9)
    with pytest.raises(ValueError, match="speculation margin"):
        eng.submit("lm", np.arange(20, dtype=np.int32), max_new_tokens=10)
    eng.submit("lm", np.arange(31, dtype=np.int32), max_new_tokens=1)


def _refused(models, monkeypatch, case):
    tm, tp = models["tm"], models["tp"]
    spec = SpecConfig(draft_cfg=tm.cfg, k=2)
    kw = {"static_sampling": dict(batching="static", sampling=SAMPLED),
          "static_speculate": dict(batching="static", speculate=spec,
                                   draft_params=tp),
          "unfused_speculate": dict(fused=False, speculate=spec,
                                    draft_params=tp),
          "int8_speculate": dict(speculate=spec, draft_params=tp),
          "draft_vocab": dict(speculate=SpecConfig(
              draft_cfg=dataclasses.replace(tm.cfg, vocab_size=32), k=2),
              draft_params=tp),
          "no_draft_params": dict(speculate=spec)}[case]
    if case == "int8_speculate":
        monkeypatch.setenv("REPRO_KV_INT8", "1")
    eng = ServingEngine(window=0.1, device="cpu")
    with pytest.raises(ValueError):
        eng.deploy("lm", tm, tp, Alloc(**FULL), **kw)
    return eng


@pytest.mark.parametrize("case", [
    "static_sampling", "static_speculate", "unfused_speculate",
    "int8_speculate", "draft_vocab", "no_draft_params"])
def test_refusals(models, monkeypatch, case):
    """JAX's refusals (engine.py:178-183, 355-372), raised before the
    instance takes a store reference."""
    eng = _refused(models, monkeypatch, case)
    assert not eng.instances
    assert eng.store.refcount("lm") == 0


def test_speculating_instance_refuses_export_and_releases_at_close(models):
    eng = ServingEngine(window=0.1, device="cpu")
    eng.deploy("lm", models["tm"], models["tp"], Alloc(**FULL),
               max_batch=2, max_len=64, batching="paged",
               speculate=SpecConfig(draft_cfg=models["tm"].cfg, k=2),
               draft_params=models["tp"])
    req = eng.submit("lm", np.arange(6, dtype=np.int32), max_new_tokens=16)
    (inst,) = eng.instances.values()
    inst.run_step()
    slot = next(i for i, r in enumerate(inst.slots) if r is req)
    with pytest.raises(ValueError, match="speculating"):
        inst.export_slot(slot)
    draft = models["tm"].dense_kv_bytes(2, 64, False)
    assert inst.draft_kv_bytes() == draft
    assert inst.kv_bytes_in_use() == inst.pages.bytes_in_use(
        inst._block_bytes) + draft
    assert eng.store.refcount("lm#draft") == 1
    eng.pump(budget_s=60.0)
    eng.retire("lm/0")
    assert not eng.instances and eng.store.refcount("lm#draft") == 0
    assert inst.dcache is None and inst.draft_params is None


@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_spec_round_writes_its_fixed_buffers_in_place(models, batching):
    """Every buffer the speculative round reads and writes keeps its
    address across rounds (what a captured graph needs); the key
    advances every round."""
    eng = ServingEngine(window=0.1, device="cpu")
    eng.deploy("lm", models["tm"], models["tp"], Alloc(**FULL),
               max_batch=2, max_len=64, batching=batching,
               speculate=SpecConfig(draft_cfg=models["tm"].cfg, k=3),
               draft_params=models["td"])
    for p in _prompts(64, n=2):
        eng.submit("lm", p, max_new_tokens=12)
    (inst,) = eng.instances.values()
    inst.run_step()

    def addresses():
        bufs = [inst._slot_tok_dev, inst._out_dev, inst._n_emit_dev,
                inst._key_dev, *inst.cache.values(), *inst.dcache.values()]
        if batching == "paged":
            bufs.append(inst._state_dev)
        return [b.data_ptr() for b in bufs]

    before, key = addresses(), inst._key_dev.clone()
    inst.run_step()
    assert addresses() == before
    assert not torch.equal(key, inst._key_dev)


# -- the rollback property on the port's PageTable ---------------------------

BS = 4
BASE = (tuple([1] * 16), tuple([2] * 16), tuple(range(16)))


class _PageHarness:
    """``test_prefix_cow_properties.py``'s engine-shaped harness (admit,
    speculate and its invariants) over the port's allocator and page
    table."""

    def __init__(self, n_blocks: int):
        self.alloc = KVPageAllocator(n_blocks, BS, block_bytes=64)
        self.pt = PageTable(self.alloc)
        self.content: dict[int, dict[int, int]] = {}
        self.model: dict[int, dict] = {}
        self.next_id = 0

    def admit(self, prompt, max_new: int) -> int:
        rows = len(prompt) + max_new
        full, tail = prompt_digests(prompt, BS)
        shared, tail_block = self.pt.match_prefix(full, tail)
        tail_shared = tail_block is not None
        shared_all = shared + ([tail_block] if tail_shared else [])
        self.pt.allocate_shared(self.next_id, rows, shared_all,
                                tail_shared=tail_shared)
        seq = self.next_id
        self.next_id += 1
        self.pt.register_prefix(seq, full, tail)
        row = self.pt.blocks(seq)
        for b in row[len(shared_all):]:
            self.content[b] = {}
        n_shared_rows = len(prompt) if tail_shared else len(shared) * BS
        for pos, tok in enumerate(prompt):
            b = row[pos // BS]
            if pos < n_shared_rows:
                assert self.content[b][pos % BS] == tok
            else:
                self.content[b][pos % BS] = tok
        self.model[seq] = dict(tokens=list(prompt), budget=max_new,
                               rows=rows)
        return seq

    def speculate(self, seq: int, k: int, n_accept: int) -> None:
        """The window ``pos..pos+k`` made writable (the engine's
        ``_cow_round`` span of ``1 + k``) before any row lands; only the
        accepted prefix advances the history."""
        m = self.model[seq]
        k = min(k, m["budget"] - 1, m["rows"] - len(m["tokens"]) - 1)
        if k < 1:
            return
        n_accept = min(n_accept, k)
        frees = self.alloc.n_frees
        pos0 = len(m["tokens"])
        toks = [(p * 11 + seq) % 64 for p in range(pos0, pos0 + k + 1)]
        for i, tok in enumerate(toks):
            block, move = self.pt.writable_block(seq, pos0 + i)
            assert self.alloc.refcount(block) == 1
            if move is not None:
                old, new = move
                self.content[new] = dict(self.content.get(old, {}))
            self.content.setdefault(block, {})[(pos0 + i) % BS] = tok
        emitted = toks[:n_accept + 1]
        m["tokens"].extend(emitted)
        m["budget"] -= len(emitted)
        assert self.alloc.n_frees == frees, "a rollback freed a block"

    def check_refcounts(self) -> None:
        counts: Counter[int] = Counter(b for row in self.pt.seqs.values()
                                       for b in row)
        spares = [b for lst in self.pt.spares.values() for b in lst]
        for b, r in list(self.alloc._ref.items()):
            assert r == (1 if b in spares else counts[b])
        for b, lst in self.pt.spares.items():
            assert len(lst) == self.alloc.refcount(b) - 1
        assert (self.alloc.blocks_in_use + self.alloc.free_blocks()
                == self.alloc.capacity)

    def check_tokens(self) -> None:
        for seq, m in self.model.items():
            row = self.pt.blocks(seq)
            got = [self.content[row[p // BS]].get(p % BS)
                   for p in range(len(m["tokens"]))]
            assert got == m["tokens"], f"seq {seq} history diverged"


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 12), st.integers(1, 4), st.integers(0, 4))
def test_speculative_rollback_never_frees_or_corrupts(plen, k, n_accept):
    d = _PageHarness(32)
    prompt = list(BASE[2][:plen])
    d.admit(prompt, 8)
    s2 = d.admit(list(prompt), 8)
    frees = d.alloc.n_frees
    d.speculate(s2, k, n_accept)
    assert d.alloc.n_frees == frees
    d.check_refcounts()
    d.check_tokens()
