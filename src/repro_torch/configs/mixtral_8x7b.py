"""mixtral-8x7b [moe]: 32L d=4096 32H GQA(kv=8) expert d_ff=14336 V=32000.

8 routed experts top-2, sliding-window attention (W=4096)
[arXiv:2401.04088; hf]: a rolled cache of the window on every layer,
continuous batching with exact-length prefills.  The same two configs as
``repro.configs.mixtral_8x7b``.  All 32 layers (93.4 GB in bf16) fit no
card, nor a pod of it on one card (every member holds the replicated
``w_down`` of every expert): they serve as a 2-member pod over two cards,
62.81 GB a member (``scripts/mixtral_pod_cards.py``; the weights staged
by ``serving.modelstore.stage_drawn``).  On one card ``chip_smoke.py``
serves the full widths at 8 of the 32 layers.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        mlp="swiglu", rope_theta=1e6,
        n_experts=8, top_k=2, sliding_window=4096,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8,
        n_experts=4, top_k=2, sliding_window=16, moe_cf_eval=4.0,
    )
