"""Configs the port serves.  ``get_config(name, reduced=...)``.

Every architecture of ``repro.configs`` is registered, in its order: the
dense qwen2-7b, gemma3-27b, starcoder2-15b and qwen1.5-110b, the
encoder-decoder seamless-m4t-large-v2, rwkv6-1.6b, the vision
llama-3.2-vision-11b, the moe qwen2-moe-a2.7b and mixtral-8x7b, and
hymba-1.5b (hybrid).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ("qwen2_7b", "gemma3_27b", "starcoder2_15b", "qwen1_5_110b",
         "seamless_m4t_large_v2", "rwkv6_1_6b", "llama3_2_vision_11b",
         "qwen2_moe_a2_7b", "mixtral_8x7b", "hymba_1_5b")

# CLI ids (--arch <id>) -> module names.
ALIASES = {"qwen2-7b": "qwen2_7b", "gemma3-27b": "gemma3_27b",
           "starcoder2-15b": "starcoder2_15b", "qwen1.5-110b": "qwen1_5_110b",
           "seamless-m4t-large-v2": "seamless_m4t_large_v2",
           "rwkv6-1.6b": "rwkv6_1_6b",
           "llama-3.2-vision-11b": "llama3_2_vision_11b",
           "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
           "mixtral-8x7b": "mixtral_8x7b", "hymba-1.5b": "hymba_1_5b"}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced_config() if reduced else mod.config()


def all_arch_ids() -> list[str]:
    return list(ALIASES)
