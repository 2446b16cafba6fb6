"""The plain reference: against a hand-built loop over tokens, keys and
experts in float64, against the port's own forward pass in float32 at a
tiny size (where the two must agree), and its imports."""

import ast
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import spec, weights
from bench.reference.decoder import Forward
from conftest import ROOT, tiny_config


def np_tree(flat):
    return {k: v.double().numpy() for k, v in flat.items()}


def loop_forward(m, w, toks):
    """Every token's logits by explicit loops, from the published
    equations, in float64."""
    L, H, K, D = m["n_layers"], m["n_heads"], m["n_kv_heads"], m["dh"]
    eps, theta, win = m["norm_eps"], m["rope_theta"], m["window"]

    def norm(x, g):
        return x / math.sqrt(float(np.mean(x * x)) + eps) * (1.0 + g)

    def rope(vec, p):
        out = vec.copy()
        half = D // 2
        for i in range(half):
            ang = p / theta ** (2 * i / D)
            a, b = vec[i], vec[i + half]
            out[i] = a * math.cos(ang) - b * math.sin(ang)
            out[i + half] = b * math.cos(ang) + a * math.sin(ang)
        return out

    def gelu(x):
        return 0.5 * x * (1 + np.tanh(math.sqrt(2 / math.pi)
                                      * (x + 0.044715 * x ** 3)))

    def silu(x):
        return x / (1 + np.exp(-x))

    xs = [w["embed"][t].copy() for t in toks]
    for layer in range(L):
        lw = {k[7:]: v[layer] for k, v in w.items() if k.startswith("layers.")}
        hs = [norm(x, lw["ln1"]) for x in xs]
        qs, ks, vs = [], [], []
        for p, h in enumerate(hs):
            q, k, v = h @ lw["attn.wq"], h @ lw["attn.wk"], h @ lw["attn.wv"]
            if "attn.bq" in lw:
                q, k, v = q + lw["attn.bq"], k + lw["attn.bk"], v + lw["attn.bv"]
            qs.append([rope(q[i * D:(i + 1) * D], p) for i in range(H)])
            ks.append([rope(k[i * D:(i + 1) * D], p) for i in range(K)])
            vs.append([v[i * D:(i + 1) * D] for i in range(K)])
        new = []
        for p, x in enumerate(xs):
            o = np.zeros(H * D)
            for hh in range(H):
                kv = hh // (H // K)
                js = [j for j in range(p + 1) if win is None or j > p - win]
                sc = np.array([qs[p][hh] @ ks[j][kv] / math.sqrt(D)
                               for j in js])
                pr = np.exp(sc - sc.max())
                pr /= pr.sum()
                o[hh * D:(hh + 1) * D] = sum(pr[i] * vs[j][kv]
                                             for i, j in enumerate(js))
            x = x + o @ lw["attn.wo"]
            h = norm(x, lw["ln2"])
            if m["family"] == "moe":
                lg = h @ lw["moe.router"]
                g = np.exp(lg - lg.max())
                g /= g.sum()
                top = sorted(range(len(g)), key=lambda e: -g[e])[:m["top_k"]]
                tot = sum(g[e] for e in top)
                y = np.zeros_like(x)
                for e in top:
                    a = silu(h @ lw["moe.w_gate"][e]) * (h @ lw["moe.w_up"][e])
                    y += g[e] / tot * (a @ lw["moe.w_down"][e])
            else:
                a = gelu(h @ lw["mlp.w_up"] + lw["mlp.b_up"])
                y = a @ lw["mlp.w_down"] + lw["mlp.b_down"]
            new.append(x + y)
        xs = new
    return np.stack([norm(x, w["ln_f"]) @ w["head"] for x in xs])


def hand_dims(family):
    cfg = tiny_config(family, layers=2)
    cfg.update(hidden_size=8, intermediate_size=12, num_attention_heads=2,
               num_key_value_heads=1, vocab_size=11)
    if family == "moe":
        cfg["sliding_window"] = 3
    return spec.model_dims(cfg)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_against_a_hand_built_loop(family):
    m = hand_dims(family)
    flat = weights.flatten(weights.make(m, 5, "cpu"))
    toks = [3, 1, 4, 1, 5, 9, 2]
    want = loop_forward(m, np_tree(flat), toks)
    got = Forward(m, flat).logits([torch.tensor(toks)], [0])[0]
    np.testing.assert_allclose(got.double().numpy(), want, atol=2e-5,
                               rtol=1e-4)


def test_the_window_leaves_old_keys_out():
    m = hand_dims("moe")
    flat = weights.flatten(weights.make(m, 6, "cpu"))
    a, b = [1, 2, 3, 4, 5, 6], [7, 2, 3, 4, 5, 6]
    fa = Forward(m, flat).logits([torch.tensor(a)], [0])[0]
    fb = Forward(m, flat).logits([torch.tensor(b)], [0])[0]
    # with a window of 3 and 2 layers, token 0 reaches rows 0-4 only
    assert torch.equal(fa[5], fb[5])
    assert not torch.equal(fa[4], fb[4])


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_against_the_port_forward_in_float32(family):
    from bench.run import port_model
    cfg = tiny_config(family)
    m = spec.model_dims(cfg)
    model = port_model(m, "tiny")
    tree = weights.make(m, 11, "cpu")
    weights.check_layout(tree, model.specs)
    f32 = {k: v.float() for k, v in weights.flatten(tree).items()}
    nested = weights._nest(f32)
    toks = torch.tensor(np.random.default_rng(0).integers(0, 256, 40))
    port, _ = model.forward(nested, toks[None], train=False)
    ref = Forward(m, f32).logits([toks], [0])[0]
    np.testing.assert_allclose(ref.numpy(), port[0].float().numpy(),
                               atol=1e-4, rtol=1e-4)


def test_fp8_control_moves_the_logits():
    m = hand_dims("dense")
    flat = weights.flatten(weights.make(m, 5, "cpu"))
    t = [torch.tensor([3, 1, 4, 1, 5, 9, 2])]
    f32 = Forward(m, flat).logits(t, [0])[0]
    fp8 = Forward(m, flat, "fp8").logits(t, [0])[0]
    assert 1e-3 < (f32 - fp8).abs().max() < 1.0


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    code = ("import sys; sys.path.insert(0, %r); "
            "import bench.reference.decoder; "
            "print(sorted({k.split('.')[0] for k in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
