"""``Model.forward`` of the recurrent families against the JAX
package's, with its gradients: rwkv6-1.6b and hymba-1.5b reduced (hymba's
4 meta tokens and window of 8 passed), through ``test_torch_forward.py``'s
helpers and tolerances; ``remat=True`` == ``remat=False``; and the scans'
chunked plain versions at ``grad_chunk(S)`` (what their Functions' backward
differentiates on the card) against the loops (what it differentiates on
the CPU): input gradients within rtol 1e-4 / atol 1e-5 in units of each
input's largest gradient, in f32 — the chunked algorithm sums each output
over the chunk in another order.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ssm_scan as tssm
from repro_torch.kernels.grad import grad_chunk
from repro_torch.kernels import wkv6 as twkv
from test_torch_forward import RECURRENT, check_against_jax, check_remat

torch.set_num_threads(2)


@pytest.mark.parametrize("case", RECURRENT)
def test_forward_and_grads_match_jax(case, monkeypatch):
    check_against_jax(case, monkeypatch)


@pytest.mark.parametrize("case", RECURRENT)
def test_remat_grads_equal_plain(case):
    check_remat(case)


def _input_grads(fn, inputs, seed):
    xs = [x.clone().requires_grad_() for x in inputs]
    outs = fn(*xs)
    rng = np.random.default_rng(seed)
    torch.autograd.backward(outs, [torch.from_numpy(
        rng.standard_normal(o.shape).astype(np.float32)) for o in outs])
    return [x.grad for x in xs]


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("scan", ["wkv6", "ssm"])
def test_chunked_backward_equals_loop_backward(scan, chunk):
    """The chunked plain version the card's backward differentiates gives
    the loop's input gradients: S = 100 at ``grad_chunk(S)`` (one chunk of
    128, 28 rows of it padding) and at chunks of 16 (a ragged last one of
    4).  WKV-6's first step decays by e^-100, whose exponent negated would
    overflow in the branch of the factorisation not taken."""
    rng = np.random.default_rng(21)

    def draw(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    b, s, h = 2, 100, 3
    if scan == "wkv6":
        d = twkv.HEAD_SIZE
        w = -torch.exp(draw(b, s, h, d, scale=0.5)) * 0.3
        w[:, 0] = -100.0
        inputs = [draw(b, s, h, d), draw(b, s, h, d), draw(b, s, h, d), w,
                  draw(h, d), draw(b, h, d, d)]
        loop, chunked = twkv.wkv6_scan_plain, twkv.wkv6_chunked_plain
    else:
        d, n = 32, 16
        inputs = [draw(b, s, h, d),
                  torch.nn.functional.softplus(draw(b, s, h)),
                  draw(h, n, scale=0.5), draw(b, s, h, n), draw(b, s, h, n),
                  draw(b, h, d, n)]
        loop, chunked = tssm.ssm_scan_plain, tssm.ssm_chunked_plain
    size = chunk or grad_chunk(s)
    want = _input_grads(loop, inputs, 3)
    got = _input_grads(lambda *xs: chunked(*xs, chunk=size), inputs, 3)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all(), i
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=1e-4,
            atol=1e-5 * max(1.0, w.abs().max().item()), err_msg=str(i))
