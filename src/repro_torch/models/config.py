"""Model configuration for all assigned architectures.

One frozen dataclass covers the whole zoo; family-specific fields are only
read by the matching model builder.  Static (hashable) so it can be a jit
closure constant.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scale
    # Attention pattern ------------------------------------------------------
    sliding_window: Optional[int] = None  # SWA window for local layers
    local_global_ratio: int = 0  # gemma3: N local layers per 1 global (0=all global)
    # MoE ---------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None  # per-expert FFN dim (defaults to d_ff)
    moe_cf_train: float = 1.25  # capacity factor, training (drops allowed)
    moe_cf_eval: float = 2.0  # capacity factor, prefill/decode
    # SSM / RWKV ---------------------------------------------------------------
    ssm_state: int = 0
    # Encoder-decoder -----------------------------------------------------------
    encoder_layers: int = 0  # >0 => enc-dec; n_layers is the decoder depth
    # VLM -----------------------------------------------------------------------
    cross_attn_every: int = 0  # insert one cross-attn layer after every N layers
    n_context_tokens: int = 0  # stubbed modality frontend: frames / patches
    # Vocab padding for clean TP sharding (Megatron-style) ------------------------
    vocab_pad_multiple: int = 128

    def __post_init__(self) -> None:
        if self.n_layers <= 0 or self.d_model <= 0:
            raise ValueError("bad config")
        if self.family not in ("dense", "moe", "rwkv", "hybrid", "encdec", "vlm"):
            raise ValueError(f"unknown family {self.family}")
        if self.family == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError("moe needs n_experts and top_k")

    # -- derived -----------------------------------------------------------

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_pad_multiple)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.dh

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.dh

    def is_global_layer(self, i: int) -> bool:
        """Local:global interleave (gemma3 style: every (r+1)-th is global)."""
        if self.local_global_ratio <= 0:
            return self.sliding_window is None  # all-global unless pure SWA
        return (i + 1) % (self.local_global_ratio + 1) == 0

    @property
    def attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §4)."""
        if self.family in ("rwkv", "hybrid"):
            return True
        # SWA-everywhere or local:global with windowed locals is sub-quadratic
        # in cache for all but the global layers; global layers stream O(S).
        return self.sliding_window is not None

    # -- parameter counts (drive MODEL_FLOPS and the memory model) ------------

    def param_count(self) -> int:
        """Exact trainable parameter count."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        emb = V * D
        head = 0 if self.tie_embeddings else V * D
        per_attn = (D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D)
        if self.qkv_bias:
            per_attn += self.q_dim + 2 * self.kv_dim
        gated = self.mlp in ("swiglu", "geglu")
        per_mlp = D * F * (3 if gated else 2)
        norms = 2 * D

        def dense_layer() -> int:
            return per_attn + per_mlp + norms

        def moe_layer() -> int:
            fe = self.expert_d_ff
            expert = D * fe * (3 if gated else 2)
            router = D * self.n_experts
            shared = self.n_shared_experts * expert
            return per_attn + norms + router + self.n_experts * expert + shared

        if self.family == "rwkv":
            # time-mix (r,k,v,g,o + decay lora) + channel-mix, per layer
            tm = 5 * D * D + 2 * (D * 64 + 64 * D)
            cm = 2 * D * int(self.d_ff)
            body = self.n_layers * (tm + cm + norms)
            return emb + head + body + 2 * D
        if self.family == "hybrid":
            ssm = self.ssm_state and (2 * D * self.ssm_state + D * 16)
            body = self.n_layers * (per_attn + per_mlp + norms + ssm)
            return emb + head + body + 2 * D
        if self.family == "moe":
            return emb + head + self.n_layers * moe_layer() + D
        if self.family == "encdec":
            enc = self.encoder_layers * dense_layer()
            dec = self.n_layers * (dense_layer() + per_attn + D)  # + cross attn
            return emb + head + enc + dec + 2 * D
        if self.family == "vlm":
            n_cross = self.n_layers // max(self.cross_attn_every, 1)
            cross = n_cross * (per_attn + per_mlp + norms + D)
            return emb + head + self.n_layers * dense_layer() + cross + D
        return emb + head + self.n_layers * dense_layer() + D

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        D, V = self.d_model, self.padded_vocab
        gated = self.mlp in ("swiglu", "geglu")
        fe = self.expert_d_ff
        expert = D * fe * (3 if gated else 2)
        per_attn = (D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D)
        active_layer = (per_attn + 2 * D + D * self.n_experts
                        + (self.top_k + self.n_shared_experts) * expert)
        emb = V * D
        head = 0 if self.tie_embeddings else V * D
        return emb + head + self.n_layers * active_layer + D
