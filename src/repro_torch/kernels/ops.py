"""Attention ops the models call: the port's counterpart of
``repro.kernels.ops`` for this slice.

Each op dispatches on the device of its input: a CPU tensor goes to the
plain PyTorch version, a CUDA tensor to the hand-written kernel (or the
call raises — there is no fallback).  ``greedy_sample`` has no kernel of
its own (the JAX package has no Pallas original for it) and stays a torch
op on both devices.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["flash_attention", "decode_attention", "paged_decode_attention",
           "greedy_sample"]


def greedy_sample(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """On-device greedy sampler: argmax over the (padded) vocab, clipped to
    the real ``vocab_size`` (ops.py:176-177).  Returns int32 tokens with
    the leading shape of ``logits``."""
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.clamp(tok, max=vocab_size - 1)
