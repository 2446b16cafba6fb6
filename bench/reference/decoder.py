"""The plain reference: a decoder-only transformer's forward pass in
float32 PyTorch, written from the published descriptions, one layer at a
time so that it runs beside the served weights.

* embeddings, then per layer: RMSNorm (scale ``1 + g``), q/k/v
  projections (with biases where the configuration has them), rotary
  embeddings on split halves (base ``rope_theta``), grouped-query
  attention, causal and, with a window ``w``, over the keys ``j`` with
  ``i - w < j <= i``; the output projection; RMSNorm; then
* a GELU (tanh) MLP with biases (starcoder2), a SiLU-gated MLP, or
  sparse experts (mixtral): softmax gates over the experts, the top-k
  experts of each token, their gates renormalised to sum to 1, each
  expert a SiLU-gated MLP;
* a final RMSNorm and the output head.

No kernel, cache, batching or capacity: every token reaches its top-k
experts.  ``precision="fp8"`` is the benchmark's control: the same
forward with every matrix product's operands rounded to float8 e4m3
(weights per output column, activations per row, each scaled to the
format's range).  Imports torch alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
Q_BLOCK = 512  # query rows per attention block


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Forward:
    """The forward pass of one model (``m``: ``bench.spec.model_dims``)
    over flat weights (``bench.weights.flatten``: stacked layer leaves),
    in float32 or, for the control, with fp8 products."""

    def __init__(self, m: dict, weights: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m, self.w, self.fp8 = m, weights, precision == "fp8"
        # Per sequence, each position's narrowest routing margin over the
        # layers: the gate of its k-th expert less that of the next.
        self.margins: list[torch.Tensor] = []
        self._seq = 0

    def _lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _q8(x, -1) @ _q8(w, -2)
        return x @ w

    def _norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["norm_eps"]) * (1.0 + g.float())

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        dh = x.shape[-1]
        inv = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
        ang = pos[:, None].float() * inv[None]
        cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
        sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
        x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
        return x * cos + torch.cat([-x2, x1], -1) * sin

    def _attend(self, q, k, v) -> torch.Tensor:
        """(S, H, D) queries over (S, K, D) keys and values, causal within
        the window, one block of query rows at a time."""
        s, h, dh = q.shape
        kv = k.shape[1]
        g = h // kv
        w = self.m["window"]
        kpos = torch.arange(s, device=q.device)
        out = torch.empty_like(q)
        kf = k.permute(1, 2, 0)  # (K, D, S)
        vf = v.permute(1, 0, 2)  # (K, S, D)
        for a in range(0, s, Q_BLOCK):
            b = min(a + Q_BLOCK, s)
            qb = q[a:b].reshape(b - a, kv, g, dh).permute(1, 0, 2, 3)
            sc = torch.einsum("kqgd,kds->kqgs", qb, kf) / math.sqrt(dh)
            qpos = torch.arange(a, b, device=q.device)
            mask = kpos[None] <= qpos[:, None]
            if w is not None:
                mask &= kpos[None] > qpos[:, None] - w
            sc = sc.masked_fill(~mask[None, :, None, :], float("-inf"))
            p = torch.softmax(sc, -1)
            ob = torch.einsum("kqgs,ksd->kqgd", p, vf)
            out[a:b] = ob.permute(1, 0, 2, 3).reshape(b - a, h, dh)
        return out

    def _ffn(self, h: torch.Tensor, lw: dict) -> torch.Tensor:
        m = self.m
        if m["family"] == "moe":
            gates = torch.softmax(self._lin(h, lw["moe.router"]), -1)
            top = torch.topk(gates, m["top_k"] + 1, dim=-1).values
            gap = top[:, -2] - top[:, -1]
            self.margins[self._seq] = torch.minimum(self.margins[self._seq],
                                                    gap)
            top_w, top_e = torch.topk(gates, m["top_k"], dim=-1)
            top_w = top_w / top_w.sum(-1, keepdim=True)
            y = torch.zeros_like(h)
            for e in range(m["n_experts"]):
                rows, slot = (top_e == e).nonzero(as_tuple=True)
                if rows.numel() == 0:
                    continue
                x = h[rows]
                a = F.silu(self._lin(x, lw["moe.w_gate"][e])) * \
                    self._lin(x, lw["moe.w_up"][e])
                y.index_add_(0, rows, self._lin(a, lw["moe.w_down"][e])
                             * top_w[rows, slot, None])
            return y
        if m["gated"]:
            a = F.silu(self._lin(h, lw["mlp.w_gate"])) * \
                self._lin(h, lw["mlp.w_up"])
            return self._lin(a, lw["mlp.w_down"])
        u = self._lin(h, lw["mlp.w_up"])
        if "mlp.b_up" in lw:
            u = u + lw["mlp.b_up"]
        y = self._lin(F.gelu(u, approximate="tanh"), lw["mlp.w_down"])
        return y + lw["mlp.b_down"] if "mlp.b_down" in lw else y

    def _layer(self, x: torch.Tensor, lw: dict) -> torch.Tensor:
        m = self.m
        s = x.shape[0]
        pos = torch.arange(s, device=x.device)
        h = self._norm(x, lw["ln1"])
        q, k, v = (self._lin(h, lw[f"attn.w{n}"]) for n in "qkv")
        if "attn.bq" in lw:
            q, k, v = q + lw["attn.bq"], k + lw["attn.bk"], v + lw["attn.bv"]
        q = self._rope(q.view(s, m["n_heads"], m["dh"]), pos)
        k = self._rope(k.view(s, m["n_kv_heads"], m["dh"]), pos)
        o = self._attend(q, k, v.view(s, m["n_kv_heads"], m["dh"]))
        x = x + self._lin(o.reshape(s, -1), lw["attn.wo"])
        return x + self._ffn(self._norm(x, lw["ln2"]), lw)

    def logits(self, seqs: list[torch.Tensor], first: list[int]
               ) -> list[torch.Tensor]:
        """Float32 logits (n_i - first_i, V) of each token sequence
        ``seqs[i]`` (n_i,) at its positions ``first_i`` .. n_i - 1, all
        sequences a layer at a time (a layer's weights cast to float32
        once)."""
        w = self.w
        xs = [w["embed"][s.long()].float() for s in seqs]
        self.margins = [torch.full((len(s),), float("inf"), device=s.device)
                        for s in seqs]
        prefix = "layers."
        names = [k[len(prefix):] for k in w if k.startswith(prefix)]
        for layer in range(self.m["n_layers"]):
            lw = {n: w[prefix + n][layer].float() for n in names}
            for i, x in enumerate(xs):
                self._seq = i
                xs[i] = self._layer(x, lw)
            del lw
        head = w["head"].float()
        return [self._lin(self._norm(x[f:], w["ln_f"]), head)
                for x, f in zip(xs, first)]
