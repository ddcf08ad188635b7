"""Top-level model for serving: init / init_cache / serve_prefill /
serve_step — the decoder-only families of the JAX package's
``models/model.py``, in PyTorch.

``build_model(cfg)`` returns a :class:`Model` with

- ``init(gen) → params``: a nested dict of LowRankFactor and dense leaves
  in the JAX package's layout, drawn from the ``torch.Generator`` ``gen``
  on its device;
- ``init_cache(params, batch, cache_len, per_slot=False)``;
- ``serve_prefill(params, batch, cache_len=0, last_index=None) → (logits,
  cache)`` and ``serve_step(params, cache, tokens) → (logits, cache)``:
  KV-cached decode. The cache's k/v tensors are updated in place.

Training (``loss_fn``) comes with the training slice; see ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Builder,
    apply_embedding,
    apply_linear,
    rms_norm,
)
from repro_torch.models.transformer import (
    build_block,
    init_cache_stack,
    stack_apply,
)


def torch_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _check_family(cfg: ModelConfig) -> None:
    if cfg.is_encdec or cfg.family == "vlm" or cfg.vision_tokens:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported to PyTorch "
            f"yet; see ROADMAP.md, queue 1"
        )


def build_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    _check_family(cfg)
    pol = cfg.lowrank
    b = Builder(gen, pol, dtype=torch_dtype(cfg.param_dtype))
    NB = cfg.superblocks
    b.linear("embed", cfg.vocab_size, cfg.d_model, force_dense=not pol.factorize_embed)
    b.linear("lm_head", cfg.d_model, cfg.vocab_size, force_dense=not pol.factorize_head)
    b.vector("final_norm", (cfg.d_model,))
    for i, kind in enumerate(cfg.block_pattern):
        build_block(b, f"blocks/pos{i}", kind, cfg, NB, moe_here=cfg.moe_on_layer(i))
    return b.build()


def _logits(params, h, kernels: str = "off"):
    return apply_linear(params["lm_head"], h, kernels=kernels)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]
    serve_prefill: Callable[..., Tuple[torch.Tensor, Any]]
    serve_step: Callable[[Any, Any, torch.Tensor], Tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    _check_family(cfg)
    dt = torch_dtype(cfg.compute_dtype)

    def init_cache(params, batch: int, cache_len: int, *, per_slot: bool = False):
        """``per_slot=True``: positions tracked per batch row — ``pos`` is
        (batch,) and the attention write indices are (NB, batch) — so a
        continuous-batching engine can admit a request into a freed slot
        while the others keep decoding."""
        device = params["final_norm"].device
        return {
            "stack": init_cache_stack(cfg, batch, cache_len, dt, device, per_slot=per_slot),
            "pos": torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=device),
        }

    def serve_prefill(params, batch, cache_len: int = 0, last_index: Optional[int] = None):
        """Process the full prompt; returns (last-token logits, cache).

        ``last_index`` reads the logits at that sequence position instead
        of the final one and stamps ``pos`` to ``last_index + 1``: right-
        padded prompts stay exact, since the causal mask keeps pad keys out
        of every real query, and the serving engine's slot insert stamps
        the cache index with the true length so the pad entries are masked.
        """
        tokens = batch["tokens"]  # (B, S)
        emb = apply_embedding(
            params["embed"], tokens, dtype=torch.float32, kernels=cfg.kernels
        ).to(dt)
        cache = init_cache(params, tokens.shape[0], cache_len or emb.shape[1])
        positions = torch.arange(emb.shape[1], device=emb.device)
        h, new_stack = stack_apply(params["blocks"], emb, cfg, positions=positions,
                                   caches=cache["stack"])
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        cache["stack"] = new_stack
        if last_index is None:
            last = emb.shape[1] - 1
        else:
            last = int(last_index)
        cache["pos"] = torch.tensor(last + 1, dtype=torch.int32, device=emb.device)
        logits = _logits(params, h[:, last:last + 1], cfg.kernels)[:, 0]
        return logits, cache

    def serve_step(params, cache, tokens):
        """One decode step. tokens: (B, 1) → (logits (B, vocab), cache).

        With a per-slot cache (``pos`` shaped (B,)), positions broadcast to
        (B, T) and every row attends at its own depth."""
        emb = apply_embedding(
            params["embed"], tokens, dtype=torch.float32, kernels=cfg.kernels
        ).to(dt)
        pos = cache["pos"]
        positions = pos[..., None] + torch.arange(tokens.shape[1], device=emb.device)
        h, new_stack = stack_apply(params["blocks"], emb, cfg, positions=positions,
                                   caches=cache["stack"])
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        new_cache = dict(cache, stack=new_stack, pos=pos + tokens.shape[1])
        logits = _logits(params, h[:, -1:], cfg.kernels)[:, 0]
        return logits, new_cache

    return Model(
        cfg=cfg,
        init=lambda gen: build_params(cfg, gen),
        serve_prefill=serve_prefill,
        serve_step=serve_step,
        init_cache=init_cache,
    )
