"""The weights of a run, made from its seed: one tensor a leaf, every
layer stacked on a leading axis, drawn on the device by one generator in
one call a leaf, in the dtype they are served in.  The program and the
reference read the same tensors; the layout (``x @ W`` with ``W``
shaped (d_in, d_out)) is the benchmark's, and ``check_layout`` holds the
program's parameter specs to it, so a change of the program's layout
fails loudly instead of feeding the reference other numbers."""

from __future__ import annotations

import math

import torch

EMBED_STD = 0.02  # embeddings
SMALL_STD = 0.1   # norm gains (scale 1 + g) and biases


def layout(m: dict) -> dict:
    """{path: (shape, dtype, std)} of every leaf; std 1/sqrt(fan_in) for
    projections.  ``m``: ``bench.spec.model_dims``."""
    L, d, v = m["n_layers"], m["d_model"], m["vocab"]
    hq, kv, f = m["n_heads"] * m["dh"], m["n_kv_heads"] * m["dh"], m["d_ff"]
    bf = torch.bfloat16

    def proj(*shape):
        return (shape, bf, 1.0 / math.sqrt(shape[-2]))

    out = {"embed": ((v, d), bf, EMBED_STD), "ln_f": ((d,), bf, SMALL_STD),
           "head": proj(d, v),
           "layers.ln1": ((L, d), bf, SMALL_STD),
           "layers.ln2": ((L, d), bf, SMALL_STD),
           "layers.attn.wq": proj(L, d, hq), "layers.attn.wk": proj(L, d, kv),
           "layers.attn.wv": proj(L, d, kv), "layers.attn.wo": proj(L, hq, d)}
    if m["bias"]:
        for name, width in (("bq", hq), ("bk", kv), ("bv", kv)):
            out[f"layers.attn.{name}"] = ((L, width), bf, SMALL_STD)
    if m["family"] == "moe":
        e = m["n_experts"]
        out["layers.moe.router"] = ((L, d, e), torch.float32,
                                    1.0 / math.sqrt(d))
        out["layers.moe.w_gate"] = proj(L, e, d, f)
        out["layers.moe.w_up"] = proj(L, e, d, f)
        out["layers.moe.w_down"] = proj(L, e, f, d)
    elif m["gated"]:
        out["layers.mlp.w_gate"] = proj(L, d, f)
        out["layers.mlp.w_up"] = proj(L, d, f)
        out["layers.mlp.w_down"] = proj(L, f, d)
    else:
        out["layers.mlp.w_up"] = proj(L, d, f)
        out["layers.mlp.w_down"] = proj(L, f, d)
        if m["bias"]:
            out["layers.mlp.b_up"] = ((L, f), bf, SMALL_STD)
            out["layers.mlp.b_down"] = ((L, d), bf, SMALL_STD)
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out


def make(m: dict, seed: int, device) -> dict:
    """The nested weight tree of ``layout(m)`` drawn from ``seed``."""
    flat = {path: torch.empty(shape, dtype=dtype, device=device)
            for path, (shape, dtype, _) in layout(m).items()}
    tree = _nest(flat)
    fill(tree, m, seed)
    return tree


def fill(tree: dict, m: dict, seed: int) -> None:
    """Draw every leaf of ``tree`` anew from ``seed``, in place (the
    addresses stay, so graphs captured over them stay valid)."""
    flat = flatten(tree)
    device = next(iter(flat.values())).device
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    with torch.no_grad():
        for path, (_, _, std) in sorted(layout(m).items()):
            t = flat[path]
            t.normal_(0.0, std, generator=g)


def check_layout(tree: dict, program_specs: dict) -> None:
    """Raise unless the program's param specs (a nested dict of objects
    with ``shape`` and ``dtype``) name exactly the leaves of ``tree``,
    with the same shapes and dtypes."""
    ours = {p: (tuple(t.shape), t.dtype) for p, t in flatten(tree).items()}
    theirs = {p: (tuple(s.shape), s.dtype)
              for p, s in flatten(program_specs).items()}
    if ours != theirs:
        diff = sorted(set(ours.items()) ^ set(theirs.items()))
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's layout: {diff[:8]}")
