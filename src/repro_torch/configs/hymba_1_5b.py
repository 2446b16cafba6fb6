"""hymba-1.5b [hybrid]: 32L d=1600 25H GQA(kv=5) d_ff=5504 V=32001 ssm=16.

Parallel attention + Mamba (SSM) heads fused per layer, 128 learnable meta
tokens [arXiv:2411.13676; hf].  All attention layers sliding-window (1024),
as in ``repro.configs.hymba_1_5b`` (Hymba keeps 3 global layers).  The same
two configs as the JAX package: the full-width model and a 2-layer smoke
cut.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001,
        mlp="swiglu", ssm_state=16, sliding_window=1024,
        n_context_tokens=128,  # meta tokens
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8,
        ssm_state=8, sliding_window=8, n_context_tokens=4,
    )
