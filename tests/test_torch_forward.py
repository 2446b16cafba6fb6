"""``Model.forward`` of the port against the JAX package's, family by
family, with its gradients: the tiny dense config, qwen2-moe-a2.7b reduced
(top-2 of 8 experts at ``moe_cf_train`` = 1.25, where pairs drop),
gemma3-27b reduced past its window of 8 (local and global layers),
llama-3.2-vision-11b and seamless-m4t-large-v2 reduced (with a context)
here; rwkv6-1.6b and hymba-1.5b reduced, with the same helpers, in
``test_torch_forward_recurrent.py`` (each file stays well inside a
minute alone).

Both packages run f32 params (the JAX tree bridged with
``repro_torch.bridge``; every all-zero leaf — norms, gates, biases —
filled from a numpy seed first, so it moves the result and takes a
gradient) on the same tokens, labels and context, drawn with numpy from a
seed.  The loss is the train step's: ``cross_entropy(logits, labels) +
0.01 * aux``; JAX's side is ``jax.value_and_grad`` with ``remat=False``
(the same values), the port's ``torch.autograd`` through the kernels'
Functions (the plain versions on the CPU).  Tolerances, each with its
reason:
* logits and aux: 1e-5, f32 end to end, the same products summed in
  another order;
* every param leaf's gradient: rtol 1e-4 / atol 1e-6 in units of the
  leaf's largest gradient (at least 1) — a gradient sums more terms than
  a logit (every position of the batch).  The unit
  matters for the embedding alone, whose gradients reach 1.7-3.5 here
  (the first norm scales its 0.02-std rows up by about 50): a handful of
  its near-zero elements differ by 1.3-2.5e-6, about ten f32 ulps of the
  leaf's scale, while the whole leaf agrees within 2.5e-6 in norm;
* the port's ``remat=True`` against ``remat=False``: bit for bit (the
  recompute repeats the same ops on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.training import cross_entropy as jax_xent
from repro_torch import bridge
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.training import cross_entropy

torch.set_num_threads(2)

B, S = 2, 24  # past the reduced windows of 8 (gemma3's, hymba's + meta)
AUX_WEIGHT = 0.01
CASES = {"dense": None, "moe": "qwen2-moe-a2.7b", "gemma3": "gemma3-27b",
         "vision": "llama-3.2-vision-11b",
         "seamless": "seamless-m4t-large-v2", "rwkv": "rwkv6-1.6b",
         "hybrid": "hymba-1.5b"}
ATTENTION = ["dense", "moe", "gemma3", "vision", "seamless"]
RECURRENT = ["rwkv", "hybrid"]  # test_torch_forward_recurrent.py


def _filled(tree, rng):
    """f32 numpy leaves; every all-zero leaf drawn from ``rng`` instead."""
    if isinstance(tree, dict):
        return {k: _filled(tree[k], rng) for k in sorted(tree)}
    a = np.asarray(tree, np.float32)
    if not a.any():
        a = (rng.standard_normal(a.shape) * 0.5).astype(np.float32)
    return a


_PAIRS = {}


def _pair(case):
    """(JAX model, f32 JAX params, port model, bridged params, inputs)."""
    if case not in _PAIRS:
        arch = CASES[case]
        jcfg = tiny_config() if arch is None else jax_config(arch,
                                                             reduced=True)
        jm = jax_build(jcfg)
        host = _filled(jax.device_get(jm.init(jax.random.key(11))),
                       np.random.default_rng(5))
        tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
        rng = np.random.default_rng(9)
        inputs = dict(
            tokens=rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
            labels=rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32))
        if tm.needs_ctx():
            inputs["ctx"] = rng.standard_normal(
                (B, jcfg.n_context_tokens, jcfg.d_model)).astype(np.float32)
        _PAIRS[case] = (jm, jax.tree_util.tree_map(jnp.asarray, host), tm,
                        host, inputs)
    return _PAIRS[case]


def _jax_side(jm, jp, inputs):
    ctx = inputs.get("ctx")
    ctx = None if ctx is None else jnp.asarray(ctx)

    def loss_fn(p):
        logits, aux = jm.forward(p, jnp.asarray(inputs["tokens"]), ctx=ctx,
                                 remat=False)
        return (jax_xent(logits, jnp.asarray(inputs["labels"]))
                + AUX_WEIGHT * aux, (logits, aux))

    (loss, (logits, aux)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jp)
    return float(loss), np.asarray(logits), float(aux), grads


def _port_side(tm, host, inputs, remat=False):
    params = bridge.to_torch(host)
    leaves = []

    def want(t):
        t.requires_grad_()
        leaves.append(t)
        return t
    _map(want, params)
    ctx = inputs.get("ctx")
    logits, aux = tm.forward(params, torch.from_numpy(inputs["tokens"]),
                             ctx=None if ctx is None else
                             torch.from_numpy(ctx), remat=remat)
    loss = (cross_entropy(logits, torch.from_numpy(inputs["labels"]))
            + AUX_WEIGHT * aux)
    loss.backward()
    return (loss.item(), logits.detach().numpy(), aux.item(),
            _map(lambda t: t.grad, params))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("case", ATTENTION)
def test_forward_and_grads_match_jax(case, monkeypatch):
    check_against_jax(case, monkeypatch)


def check_against_jax(case, monkeypatch):
    """Logits, aux, loss and every leaf's gradient of ``case`` against
    JAX's."""
    jm, jp, tm, host, inputs = _pair(case)
    drops = []
    real_route = tmoe.route

    def route(*args):
        r = real_route(*args)
        drops.append(int((~r["keep"]).sum()))
        return r
    monkeypatch.setattr(tmoe, "route", route)
    loss, logits, aux, grads = _port_side(tm, host, inputs)
    jloss, jlogits, jaux, jgrads = _jax_side(jm, jp, inputs)
    assert logits.shape == (B, S, tm.cfg.padded_vocab)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux, jaux, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
    if case == "moe":
        assert aux > 0 and sum(drops) > 0, drops  # moe_cf_train drops pairs
    want = dict(_walk(jax.device_get(jgrads)))
    got = dict(_walk(grads))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert g is not None, path
        w = np.asarray(want[path])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=path)


@pytest.mark.parametrize("case", ["moe", "gemma3"])
def test_remat_grads_equal_plain(case):
    check_remat(case)


def check_remat(case):
    """``remat=True`` (each layer recomputed in the backward) gives the
    same loss and gradients as ``remat=False``, bit for bit."""
    _, _, tm, host, inputs = _pair(case)
    loss, _, _, grads = _port_side(tm, host, inputs)
    rloss, _, _, rgrads = _port_side(tm, host, inputs, remat=True)
    assert rloss == loss
    for (path, g), (_, rg) in zip(_walk(grads), _walk(rgrads)):
        assert torch.equal(g, rg), path


def test_forward_refuses_a_missing_or_stray_context():
    _, _, tm, host, inputs = _pair("seamless")
    params = bridge.to_torch(host)
    with pytest.raises(ValueError, match="context"):
        tm.forward(params, torch.from_numpy(inputs["tokens"]))
    _, _, dm, dhost, dinputs = _pair("dense")
    with pytest.raises(ValueError, match="no context"):
        dm.forward(bridge.to_torch(dhost),
                   torch.from_numpy(dinputs["tokens"]),
                   ctx=torch.zeros(B, 4, dm.cfg.d_model))

