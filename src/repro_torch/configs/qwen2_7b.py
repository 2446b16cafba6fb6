"""qwen2-7b [dense]: 28L d=3584 28H GQA(kv=4) d_ff=18944 V=152064.

GQA with QKV bias [arXiv:2407.10671; hf].  The same two configs as
``repro.configs.qwen2_7b``: the full-width model and a 2-layer smoke cut.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064,
        qkv_bias=True, mlp="swiglu", rope_theta=1e6,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8,
        qkv_bias=True, mlp="swiglu", rope_theta=1e6,
    )
