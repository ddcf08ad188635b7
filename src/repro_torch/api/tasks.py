"""LM presets and the ``lm`` task's model-config resolution (the serving
part of the JAX package's ``repro.api.tasks``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.models.config import LowRankPolicy, ModelConfig, reduced

#: named LM presets (the JAX package's, same values)
PRESETS = {
    # ~100M-param dense decoder for the end-to-end example
    "llm-100m": ModelConfig(
        name="llm-100m", family="dense", num_layers=12, d_model=640,
        num_heads=10, num_kv_heads=10, head_dim=64, d_ff=2560,
        vocab_size=8192, compute_dtype="float32", param_dtype="float32",
        lowrank=LowRankPolicy(rank_frac=0.25, r_cap=160, min_dim=256),
        attn_q_chunk=256,
    ),
    # CPU-feasible demo (~2M params)
    "llm-tiny": ModelConfig(
        name="llm-tiny", family="dense", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=512,
        vocab_size=512, compute_dtype="float32", param_dtype="float32",
        lowrank=LowRankPolicy(rank_frac=0.25, r_cap=32, min_dim=32),
        attn_q_chunk=64,
    ),
}


def lm_model_config(m) -> ModelConfig:
    """Resolve a ModelSpec's architecture (preset/arch × smoke × kernels,
    then the depth and dtype overrides)."""
    if m.preset is not None:
        if m.preset not in PRESETS:
            raise ValueError(f"unknown preset {m.preset!r}; known: {sorted(PRESETS)}")
        cfg = PRESETS[m.preset]
    else:
        cfg = get_config(m.arch)
    if m.smoke:
        cfg = reduced(cfg)
    changes = {}
    if m.kernels != cfg.kernels:
        changes["kernels"] = m.kernels
    if m.layers:
        changes["num_layers"] = m.layers
    if m.dtype:
        changes["compute_dtype"] = changes["param_dtype"] = m.dtype
    return dataclasses.replace(cfg, **changes) if changes else cfg
