"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H GQA(kv=16) V=151936.

MoE: 60 routed experts top-4 + 4 shared experts, expert d_ff=1408
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  QKV bias; shared-expert sigmoid gate.
The same two configs as ``repro.configs.qwen2_moe_a2_7b``: the
full-width model and a 2-layer smoke cut.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=151936,
        qkv_bias=True, mlp="swiglu", rope_theta=1e6,
        n_experts=60, top_k=4, n_shared_experts=4, moe_d_ff=1408,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=256, vocab_pad_multiple=8,
        qkv_bias=True, n_experts=8, top_k=2, n_shared_experts=2, moe_d_ff=64,
        moe_cf_eval=8.0,
    )
