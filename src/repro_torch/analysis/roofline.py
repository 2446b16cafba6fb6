"""Roofline terms on H100s and the analytic step counts (counterpart of
``repro.analysis.roofline``).

The JAX module parses XLA's optimized HLO text to count what a compiled
step executes and moves between devices (its ``HloAnalysis`` and the
collective parser of ``analysis/hlo.py``).  PyTorch compiles no HLO, so
that parser has no counterpart: the dry run (``launch/dryrun.py``) counts
a step by tracing it on the meta device (every matmul's FLOPs as
``torch.utils.flop_counter`` counts them, and every op's operand and
result bytes), reckons the hand-written kernels' share from the shapes
their wrappers record there (``kernel_call_cost``), and reckons a pod's
gathers from its members' widths.  What ports as it is: the three-term
``Roofline``, ``roofline_terms`` taking those counts in place of an
``HloAnalysis``, and the analytic ``model_flops``, ``kernel_hbm_bytes``
and ``decode_round_alpha`` (roofline.py:514-693), with the H100's
constants (``launch/mesh.py``) in place of v5e's.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

PEAK_FLOPS = PEAK_FLOPS_BF16  # bf16 FLOP/s a card
LINK_BW = NVLINK_BW           # bytes/s a card sends one way over NVLink


# --------------------------------------------------------------------------
# Roofline terms
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one (arch x case x layout) cell, per step.

    ``memory_s`` is the counted term (the traced ops' operand and result
    bytes a device moves, the kernels' left out); ``memory_adj_s`` adds
    the kernels' analytic traffic (``kernel_hbm_bytes``) and takes out
    any counted inside them, as JAX's adjusted term does.  The dominant
    term is read from the adjusted one; both are reported.
    """

    compute_s: float
    memory_s: float
    memory_adj_s: float
    collective_s: float
    model_flops: float  # useful (analytic) FLOPs for the whole step, global
    hlo_flops_global: float  # the counted FLOPs of every device
    n_chips: int = 0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_adj_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_adj_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: how much counted compute is
        useful."""
        return self.model_flops / max(self.hlo_flops_global, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Best-case MFU if the step runs exactly at the dominant term."""
        if not self.n_chips:
            return 0.0
        return (self.model_flops / max(self.bound_s, 1e-12)) / (
            PEAK_FLOPS * self.n_chips)


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   n_chips: int, model_flops: float, *,
                   kernel_bytes_global: float = 0.0,
                   kernel_internal_bytes: float = 0.0) -> Roofline:
    """Per-device counts -> step-level roofline terms (seconds): JAX's
    arithmetic (roofline.py:556-571) on counted FLOPs, HBM bytes and
    collective bytes a device."""
    adj_bytes = (hbm_bytes - kernel_internal_bytes
                 + kernel_bytes_global / max(n_chips, 1))
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=hbm_bytes / HBM_BW,
        memory_adj_s=max(adj_bytes, 0.0) / HBM_BW,
        collective_s=collective_bytes / LINK_BW,
        model_flops=model_flops,
        hlo_flops_global=flops * n_chips,
        n_chips=n_chips,
    )


# --------------------------------------------------------------------------
# Decode-round roofline split (calibrates ServiceCurve.round_time's alpha)
# --------------------------------------------------------------------------


def decode_round_alpha(cfg, seq_len: int) -> float:
    """Weight-bound fraction of a batched decode round for this model.

    ``ServiceCurve.round_time`` models a round as a batch-shared
    weight-bound cost (fraction ``alpha``) plus a per-slot KV/activation
    cost: ``t(live) proportional to alpha + (1 - alpha) * live``.  The
    roofline decomposition gives alpha directly: one round streams the
    (active) weights once — ``W`` bytes, shared by every slot — and each
    slot's KV cache once — ``K`` bytes per sequence at ``seq_len`` context
    (``kernel_hbm_bytes``), so ``alpha = W / (W + K)``.

    Short contexts on weight-heavy models are weight-bound (alpha -> 1:
    batching is nearly free); long contexts are KV-bound (alpha -> 0:
    rounds scale linearly with live slots and continuous batching's
    fill advantage shrinks).
    """
    import types

    case = types.SimpleNamespace(kind="decode", global_batch=1,
                                 seq_len=max(seq_len, 1))
    w = 2.0 * cfg.active_param_count()  # bf16 weight stream, batch-shared
    k = kernel_hbm_bytes(cfg, case)  # per-sequence KV stream
    return w / max(w + k, 1.0)


# --------------------------------------------------------------------------
# Analytic MODEL_FLOPS per (arch x shape)
# --------------------------------------------------------------------------


def kernel_hbm_bytes(cfg, case, *, block_q: int = 512) -> float:
    """Analytic HBM traffic (global bytes/step) of the attention and scan
    kernels (roofline.py:618-661).

    Model: flash fwd reads Q once and K/V once per (causal-reachable)
    Q-block pass and writes O; backward ~2x forward; remat re-runs
    forward once.  Decode reads the KV cache once.
    """
    b, s = case.global_batch, case.seq_len
    d, kv_d = cfg.n_heads * cfg.dh, cfg.n_kv_heads * cfg.dh
    bf16 = 2.0
    if cfg.family == "rwkv":
        # wkv6 scan: read r/k/v/w + write out + state traffic ~ 6 x (b,s,d).
        return 6.0 * b * s * cfg.d_model * bf16 * cfg.n_layers * (
            3.0 if case.kind == "train" else 1.0)
    n_attn = cfg.n_layers + getattr(cfg, "encoder_layers", 0)
    if case.kind in ("train", "prefill"):
        q_o = 2.0 * b * s * d * bf16
        if cfg.sliding_window and cfg.local_global_ratio > 0:
            n_glob = max(cfg.n_layers // (cfg.local_global_ratio + 1), 1)
            kv_pass_g = max(-(-s // block_q) / 2.0, 1.0)
            kv_pass_l = max(cfg.sliding_window / block_q, 1.0)
            kv = 2.0 * b * s * kv_d * bf16
            fwd = (n_glob * (q_o + kv_pass_g * kv)
                   + (cfg.n_layers - n_glob) * (q_o + kv_pass_l * kv))
        else:
            w = cfg.sliding_window or s
            eff = min(w, s)
            kv_pass = max(-(-s // block_q) / 2.0, 1.0) if w >= s else max(
                eff / block_q, 1.0)
            kv = 2.0 * b * s * kv_d * bf16
            fwd = n_attn * (q_o + kv_pass * kv)
        if cfg.family == "hybrid" and cfg.ssm_state:
            fwd += 4.0 * b * s * cfg.d_model * bf16 * cfg.n_layers
        return fwd * (4.0 if case.kind == "train" else 1.0)
    # decode: stream the KV cache once per step.
    w = cfg.sliding_window or s
    eff = min(w, s)
    traffic = 2.0 * b * eff * kv_d * bf16 * cfg.n_layers
    if cfg.family == "hybrid" and cfg.ssm_state:
        traffic += 2.0 * b * cfg.n_heads * cfg.dh * cfg.ssm_state * 4.0 * \
            cfg.n_layers
    return traffic


def model_flops(cfg, case) -> float:
    """Useful FLOPs of one step, whole cluster (6ND / 2ND + attention)."""
    b, s = case.global_batch, case.seq_len
    n_active = cfg.active_param_count()
    # Matmul params exclude the input embedding lookup (a gather); a tied
    # head still *matmuls* the shared V x D table, so it stays counted.
    emb = cfg.padded_vocab * cfg.d_model
    n_matmul = n_active if cfg.tie_embeddings else n_active - emb
    tokens = b * s
    attn_dim = cfg.n_heads * cfg.dh
    if cfg.family == "rwkv":
        attn_fwd = 0.0
    else:
        n_attn_layers = cfg.n_layers + getattr(cfg, "encoder_layers", 0)
        if case.kind in ("train", "prefill"):
            # causal: half of the s^2 block matrix, QK^T + AV.
            per_layer = 2.0 * b * s * s * attn_dim  # 2 matmuls x 1/2 causal x 2flops
            if cfg.sliding_window and cfg.local_global_ratio > 0:
                w = cfg.sliding_window
                n_glob = max(cfg.n_layers // (cfg.local_global_ratio + 1), 1)
                n_loc = cfg.n_layers - n_glob
                per_loc = 2.0 * b * s * min(s, w) * attn_dim * 2
                attn_fwd = n_glob * per_layer + n_loc * per_loc
            elif cfg.sliding_window:
                w = cfg.sliding_window
                attn_fwd = n_attn_layers * 2.0 * b * s * min(s, w) * attn_dim * 2
            else:
                attn_fwd = n_attn_layers * per_layer
        else:  # decode: one token vs s keys
            attn_fwd = cfg.n_layers * 4.0 * b * s * attn_dim
            if cfg.sliding_window:
                w = min(cfg.sliding_window, s)
                attn_fwd = cfg.n_layers * 4.0 * b * w * attn_dim
    if case.kind == "train":
        return 6.0 * n_matmul * tokens + 3.0 * attn_fwd
    if case.kind == "prefill":
        return 2.0 * n_matmul * tokens + attn_fwd
    # decode: one new token per sequence.
    return 2.0 * n_matmul * b + attn_fwd


# --------------------------------------------------------------------------
# The hand-written kernels' calls, from the shapes recorded on meta
# --------------------------------------------------------------------------

# The plain backward of flash, WKV-6 and the scan recomputes the forward
# under autograd and differentiates it: about three forwards' work.
BACKWARD_FACTOR = 3.0


def _flash_flops(call) -> float:
    (b, sq, h, d), _ = call.reads[0]
    sk = call.reads[1][0][1]
    window, causal = call.option("window"), call.option("causal", True)
    if window is not None:  # model_flops' windowed count
        pairs = sq * min(sk, window)
    elif causal:  # half of the block matrix past the offset, as model_flops
        pairs = sq * (call.option("q_offset", 0) + sq / 2.0)
    else:
        pairs = sq * sk
    return 4.0 * b * h * d * pairs


def _decode_flops(call) -> float:
    (b, _, h, d), _ = call.reads[0]
    rows = call.option("rows")
    window = call.option("window")
    if window is not None:
        rows = min(rows, window)
    return 4.0 * b * h * d * rows


def _wkv6_flops(call) -> float:
    (b, s, h, d), _ = call.reads[0]
    return 5.0 * b * s * h * d * d  # 5 D^2 a step and head (chip_smoke)


def _ssm_flops(call) -> float:
    (b, s, h, d), _ = call.reads[0]
    n = call.reads[2][0][-1]  # a_log (H, N)
    return 5.0 * b * s * h * d * n + 3.0 * b * s * h * n


_FLOPS = {"flash_attention": _flash_flops,
          "decode_attention": _decode_flops,
          "paged_decode_attention": _decode_flops,
          "decode_attention_quant": _decode_flops,
          "paged_decode_attention_quant": _decode_flops,
          "wkv6_step": _wkv6_flops, "wkv6_chunked": _wkv6_flops,
          "wkv6_scan": _wkv6_flops,
          "ssm_step": _ssm_flops, "ssm_chunked": _ssm_flops,
          "ssm_scan": _ssm_flops}


def kernel_call_cost(call) -> tuple[float, float]:
    """(FLOPs, bytes) of one recorded kernel call (``kernels/meta.py``):
    each operand read once and each output written once; attention as
    ``model_flops`` counts it (QK^T and PV, causal as half the block
    matrix), the scans as ``chip_smoke.py``'s bounds count them, and a
    backward ``BACKWARD_FACTOR`` forwards."""
    name, back = call.name, call.name.endswith(".backward")
    base = name.removesuffix(".backward")
    flops = _FLOPS[base](call) * (BACKWARD_FACTOR if back else 1.0)
    nbytes = sum(math.prod(shape) * size
                 for shape, size in (*call.reads, *call.writes))
    return flops, float(nbytes)
