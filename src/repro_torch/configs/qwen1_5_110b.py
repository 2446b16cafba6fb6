"""qwen1.5-110b [dense]: 80L d=8192 64H GQA(kv=8) d_ff=49152 V=152064.

SwiGLU with QKV bias [hf:Qwen/Qwen1.5-110B family].  The same two configs
as ``repro.configs.qwen1_5_110b``: the full-width model, which needs more
than one card in bf16 (a sharded pod over several cards, ROADMAP.md
Queue 1 item 11b), and a
3-layer smoke cut of head dim 8, which the card's attention kernels are
not built for (``launch/serve.py`` refuses it there; it runs on the CPU).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=49152, vocab_size=152064,
        qkv_bias=True, mlp="swiglu", rope_theta=1e6,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=192, vocab_size=256, vocab_pad_multiple=8,
        qkv_bias=True, mlp="swiglu",
    )
