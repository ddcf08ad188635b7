"""Architecture registry of the port.

The ids are the JAX package's (``repro.configs``), and each has a
``<arch>.py`` module exposing ``CONFIG`` with the exact published
dimensions (source cited in the module docstring), copied from the JAX
package. ``repro_torch.models.build_model`` builds every family here (the
decoder-only transformers, MoE, the Mamba and RWKV mixers, the
encoder-decoder and the vision-language model).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "qwen2_7b",
    "deepseek_moe_16b",
    "whisper_large_v3",
    "codeqwen15_7b",
    "qwen3_32b",
    "llava_next_mistral_7b",
    "jamba_15_large",
    "qwen15_32b",
    "olmoe_1b_7b",
    "rwkv6_7b",
)

# CLI ids (dashes) → module names
ALIASES = {
    "qwen2-7b": "qwen2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-large-v3": "whisper_large_v3",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "qwen3-32b": "qwen3_32b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "jamba-1.5-large-398b": "jamba_15_large",
    "qwen1.5-32b": "qwen15_32b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "rwkv6-7b": "rwkv6_7b",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
