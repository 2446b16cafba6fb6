"""llama-3.2-vision-11b [vlm]: 40L d=4096 32H GQA(kv=8) d_ff=14336 V=128256.

Gated cross-attention image layers after every 5 self layers (8 in all)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  The vision frontend is
a stub, as in ``repro.configs.llama3_2_vision_11b``: the caller passes
precomputed patch embeddings (B, 1600, d_model) as ``ctx``.  The same two
configs: the full-width model and a 4-layer smoke cut (a cross layer
after every 2 self layers).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256,
        mlp="swiglu", rope_theta=5e5,
        cross_attn_every=5, n_context_tokens=1600,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke", family="vlm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8,
        mlp="swiglu", cross_attn_every=2, n_context_tokens=12,
    )
