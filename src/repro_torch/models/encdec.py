"""Encoder-decoder backbone, seamless-m4t-large-v2 (counterpart of
``repro.models.encdec``).

The audio frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings ``ctx`` (B, S_enc, d_model).  The encoder is
a bidirectional transformer over them, rope over frame positions, through
the flash kernel with ``causal=False``; the decoder is a causal
transformer with a cross-attention layer in every block.  Decode caches:
each layer's self ``k``/``v`` (full length) and its projected encoder
output ``cross_k``/``cross_v`` (L, B, S_enc, K, Dh), written once at
prefill.  ``forward`` (training) encodes the context, then runs the
decoder over the whole sequence.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (EMBED, HEAD, NORM, PSpec,
                                       checkpointed, mlp_apply, mlp_specs,
                                       rms_norm, stack_tree, unstack)
from repro_torch.models.transformer import embed_tokens, layer_params, lm_head


def enc_block_specs(cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    return {"ln1": PSpec((d,), NORM, init="zeros"),
            "attn": attn.attn_specs(cfg),
            "ln2": PSpec((d,), NORM, init="zeros"),
            "mlp": mlp_specs(d, cfg.d_ff, cfg.mlp)}


def dec_block_specs(cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    return {"ln1": PSpec((d,), NORM, init="zeros"),
            "attn": attn.attn_specs(cfg),
            "ln_x": PSpec((d,), NORM, init="zeros"),
            "xattn": attn.attn_specs(cfg, cross=True),
            "ln2": PSpec((d,), NORM, init="zeros"),
            "mlp": mlp_specs(d, cfg.d_ff, cfg.mlp)}


def encdec_specs(cfg: ModelConfig) -> dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    return {"embed": PSpec((v, d), EMBED, init="small"),
            "enc_layers": stack_tree(enc_block_specs(cfg),
                                     cfg.encoder_layers),
            "enc_ln": PSpec((d,), NORM, init="zeros"),
            "layers": stack_tree(dec_block_specs(cfg), cfg.n_layers),
            "ln_f": PSpec((d,), NORM, init="zeros"),
            "head": PSpec((d, v), HEAD)}


def encode(params: dict, ctx: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings (encdec.py:58-73)."""
    x = ctx
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.encoder_layers):
        lp = layer_params(params, i, "enc_layers")
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = attn.attn_full(lp["attn"], h, cfg, positions=positions,
                                 causal=False)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h, cfg.mlp)
    return rms_norm(x, params["enc_ln"], cfg.norm_eps)


def _dec_block_full(lp: dict, x: torch.Tensor, enc_out: torch.Tensor,
                    positions: torch.Tensor, cfg: ModelConfig):
    """A decoder block over the whole prompt (encdec.py:76-86): causal self
    attention, cross-attention to the encoder output, the MLP.  Returns
    (x, k, v, ck, cv)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, k, v = attn.attn_full(lp["attn"], h, cfg, positions=positions)
    x = x + a
    h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
    ck, cv = attn.context_kv(lp["xattn"], enc_out, cfg)
    x = x + attn.cross_attn_full(lp["xattn"], h, (ck, cv), cfg)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg.mlp), k, v, ck, cv


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            ctx: Optional[torch.Tensor] = None, remat: bool = False,
            train: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(f32 logits (B, S, V_padded), a zero f32 aux loss): ``encode`` the
    context, then every decoder layer over ``tokens`` (encdec.py:89-107);
    ``remat`` recomputes each decoder layer in the backward, as JAX
    checkpoints the decoder's body alone.  ``train`` is the family
    signature's, unused."""
    del train
    if ctx is None:
        raise ValueError(f"{cfg.name}: the encoder-decoder forward needs "
                         f"a context")
    enc_out = encode(params, ctx, cfg)
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def body(lp, x):
        return _dec_block_full(lp, x, enc_out, positions, cfg)[0]

    body = checkpointed(body, remat)
    for lp in unstack(params["layers"]):
        x = body(lp, x)
    return (lm_head(params, x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None, ctx: torch.Tensor
            ) -> tuple[torch.Tensor, dict]:
    """Encode ``ctx``, run the prompt; returns (last-position logits (B,
    V), cache) with bf16 ``k``/``v`` of ``max_len`` rows and
    ``cross_k``/``cross_v`` of the encoder's rows (encdec.py:111-131)."""
    enc_out = encode(params, ctx, cfg)
    b, s = tokens.shape
    max_len = max_len or s
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, device=tokens.device)
    cache = {key: torch.zeros(shape, dtype=dtype, device=x.device)
             for key, (shape, dtype) in cache_specs(cfg, b, max_len).items()}
    for i in range(cfg.n_layers):
        x, k, v, ck, cv = _dec_block_full(layer_params(params, i), x,
                                          enc_out, positions, cfg)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        cache["cross_k"][i] = ck
        cache["cross_v"][i] = cv
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return lm_head(params, x[:, -1:], cfg)[:, 0], cache


def decode_step(params: dict, token: torch.Tensor, cache: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """token: (B,) int32.  One step (encdec.py:134-155): self attention
    against (and writing, in place) each layer's cache, cross-attention
    against its ``cross_k``/``cross_v`` at ``cache_len = S_enc``.  Returns
    (logits (B, V), cache) with ``pos + 1``."""
    pos = cache["pos"]
    x = embed_tokens(params, token[:, None], cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = attn.attn_decode(lp["attn"], h, cache["k"][i],
                                   cache["v"][i], pos, cfg)
        x = x + a
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        x = x + attn.cross_attn_decode(lp["xattn"], h, cache["cross_k"][i],
                                       cache["cross_v"][i], cfg)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h, cfg.mlp)
    return lm_head(params, x, cfg)[:, 0], dict(cache, pos=pos + 1)


def cache_specs(cfg: ModelConfig, batch: int, rows: int
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """bf16 self ``k``/``v`` (L, batch, rows, K, Dh) and ``cross_k``/
    ``cross_v`` (L, batch, S_enc, K, Dh), as JAX's ``cache_shapes`` lays
    them out (model.py:193-201)."""
    l, kv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.dh
    self_kv = ((l, batch, rows, kv, dh), torch.bfloat16)
    cross = ((l, batch, cfg.n_context_tokens, kv, dh), torch.bfloat16)
    return {"k": self_kv, "v": self_kv, "cross_k": cross, "cross_v": cross}
