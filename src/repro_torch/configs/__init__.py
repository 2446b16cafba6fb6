"""Configs the port serves.  ``get_config(name, reduced=...)``.

Registered so far: the dense qwen2-7b, starcoder2-15b, gemma3-27b and
qwen1.5-110b, the moe qwen2-moe-a2.7b and mixtral-8x7b, rwkv6-1.6b, and
hymba-1.5b (hybrid); the encoder-decoder and vision architectures of
``repro.configs`` arrive with their model families (ROADMAP.md, Queue 1
item 10).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ("qwen2_7b", "gemma3_27b", "starcoder2_15b", "qwen1_5_110b",
         "rwkv6_1_6b", "qwen2_moe_a2_7b", "mixtral_8x7b", "hymba_1_5b")

# CLI ids (--arch <id>) -> module names.
ALIASES = {"qwen2-7b": "qwen2_7b", "gemma3-27b": "gemma3_27b",
           "starcoder2-15b": "starcoder2_15b", "qwen1.5-110b": "qwen1_5_110b",
           "rwkv6-1.6b": "rwkv6_1_6b", "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
           "mixtral-8x7b": "mixtral_8x7b", "hymba-1.5b": "hymba_1_5b"}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported yet (see ROADMAP.md, Queue 1); "
            f"known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced_config() if reduced else mod.config()


def all_arch_ids() -> list[str]:
    return list(ALIASES)
