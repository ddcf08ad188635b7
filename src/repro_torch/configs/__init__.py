"""Architecture registry of the port.

The ids are the JAX package's (``repro.configs``). Each ported
architecture has a ``<arch>.py`` module exposing ``CONFIG`` with the exact
published dimensions; an id whose model family the port does not run yet
raises, naming ROADMAP.md, where the remaining work is queued.
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

#: the architectures the port runs
PORTED = ("qwen2_7b",)

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
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to PyTorch yet (ported: "
            f"{', '.join(PORTED)}); see ROADMAP.md, queue 1"
        )
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
