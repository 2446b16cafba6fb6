"""seamless-m4t-large-v2 [audio]: enc-dec 24L d=1024 16H d_ff=8192 V=256206.

Encoder-decoder multimodal backbone [arXiv:2308.11596; hf].  The audio
frontend is a stub, as in ``repro.configs.seamless_m4t_large_v2``: the
caller passes precomputed frame embeddings (B, n_context_tokens=1024,
d_model) as ``ctx``; the bidirectional encoder and the decoder with
per-layer cross-attention are fully implemented (``models/encdec.py``).
The same two configs: the full-width model and a 2+2-layer smoke cut.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=24, encoder_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=256206,
        mlp="gelu", n_context_tokens=1024,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-smoke", family="encdec",
        n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8,
        mlp="gelu", n_context_tokens=12,
    )
