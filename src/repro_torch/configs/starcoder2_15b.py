"""starcoder2-15b [dense]: 40L d=6144 48H GQA(kv=4) d_ff=24576 V=49152.

GQA + RoPE [arXiv:2402.19173; hf], GELU MLP with biases, QKV bias.  The
same two configs as ``repro.configs.starcoder2_15b``: the full-width model
and a 2-layer smoke cut (RMSNorm in place of LayerNorm, as there).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab_size=49152,
        qkv_bias=True, mlp="gelu", rope_theta=1e5,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8,
        qkv_bias=True, mlp="gelu",
    )
