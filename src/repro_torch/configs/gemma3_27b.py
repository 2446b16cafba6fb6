"""gemma3-27b [dense]: 62L d=5376 32H GQA(kv=16) d_ff=21504 V=262144.

5:1 local:global attention interleave, sliding window 1024 on local
layers [hf:google/gemma-3-*], head_dim 128 (so q_dim 4096 != d_model),
GeGLU MLP, tied embeddings with the sqrt(d_model) embedding scale.  The
same two configs as ``repro.configs.gemma3_27b``: the full-width model and
a 6-layer smoke cut (window 8, 2:1 interleave).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=21504, vocab_size=262144,
        mlp="geglu", rope_theta=1e6, tie_embeddings=True, embed_scale=True,
        sliding_window=1024, local_global_ratio=5,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b-smoke", family="dense",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8,
        mlp="geglu", tie_embeddings=True, embed_scale=True,
        sliding_window=8, local_global_ratio=2,
    )
