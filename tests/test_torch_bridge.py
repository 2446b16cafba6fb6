"""The param / cache bridge between the JAX package and the port: trees
cross leaf for leaf, in the same nesting and layouts, bit-exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch import bridge


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_bridge_roundtrips_tiny_params_bf16_bit_exact(tiny_params):
    host = jax.device_get(tiny_params)
    tt = bridge.to_torch(host)
    src, got = _flat(host), _flat(tt)
    assert src.keys() == got.keys()
    for name, leaf in src.items():
        arr = np.asarray(leaf)
        assert arr.dtype == jnp.bfloat16, name
        t = got[name]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == arr.shape
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16), arr.view(np.uint16),
            err_msg=name)
    back = _flat(bridge.to_numpy(tt))
    for name, leaf in src.items():
        arr = np.asarray(leaf)
        np.testing.assert_array_equal(
            back[name].astype(jnp.bfloat16).view(np.uint16),
            arr.view(np.uint16), err_msg=name)


def test_bridge_roundtrips_tiny_params_f32_bit_exact(tiny_params):
    host = jax.device_get(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), tiny_params))
    tt = bridge.to_torch(host)
    back = _flat(bridge.to_numpy(tt))
    for name, leaf in _flat(host).items():
        assert _flat(tt)[name].dtype == torch.float32
        np.testing.assert_array_equal(back[name], np.asarray(leaf),
                                      err_msg=name)


def test_bridge_cache_tree_and_writable_copy(tiny_model, tiny_params):
    """A prefill cache tree (bf16 K/V + int32 pos) crosses too, and the
    torch side owns a writable copy (JAX host arrays are read-only)."""
    prompt = jnp.arange(8, dtype=jnp.int32)[None] % 64
    _, cache = tiny_model.prefill(tiny_params, prompt, max_len=16)
    host = jax.device_get(cache)
    tt = bridge.to_torch(host)
    assert tt["k"].shape == (2, 1, 16, 2, 8) and tt["pos"].dtype == \
        torch.int32
    tt["k"].zero_()  # must not touch the JAX buffer
    assert float(jnp.abs(cache["k"].astype(jnp.float32)).sum()) > 0
    np.testing.assert_array_equal(bridge.to_numpy(tt)["v"],
                                  np.asarray(cache["v"], np.float32))
