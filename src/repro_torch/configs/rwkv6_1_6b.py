"""rwkv6-1.6b [ssm]: 24L d=2048 attention-free, d_ff=7168 V=65536.

RWKV-6 "Finch" with data-dependent decay [arXiv:2404.05892; unverified].
Head size 64 (32 heads).  The same two configs as
``repro.configs.rwkv6_1_6b``: the full-width model and a 2-layer smoke cut.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="rwkv",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab_size=65536,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="rwkv",
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=256, vocab_size=256, vocab_pad_multiple=8,
    )
