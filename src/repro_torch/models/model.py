"""Top-level model: init / loss_fn / init_cache / serve_prefill /
serve_step — the JAX package's ``models/model.py`` in PyTorch, for every
family (dense, MoE, SSM, hybrid, the encoder-decoder audio family and the
VLM family).

``build_model(cfg)`` returns a :class:`Model` with

- ``init(gen) → (params, specs)``: a nested dict of LowRankFactor and
  dense leaves in the JAX package's layout, drawn from the
  ``torch.Generator`` ``gen`` on its device, and the matching tree of
  sharding specs (:mod:`repro_torch.models.sharding`);
- ``loss_fn(params, batch) → scalar``: next-token cross-entropy on
  ``batch["tokens"]`` (B, T+1), on the cache-free path, plus the MoE
  blocks' auxiliary loss. Factor leaves may be AugmentedFactors (the
  FeDLRT client loop);
- ``init_cache(params, batch, cache_len, per_slot=False)``;
- ``serve_prefill(params, batch, cache_len=0, last_index=None) → (logits,
  cache)`` and ``serve_step(params, cache, tokens) → (logits, cache)``:
  cached decode: attention's k/v tensors are updated in place, a Mamba or
  RWKV block's state is returned anew.

Batch layouts by family (as in the JAX package):
  dense / moe / ssm / hybrid: {"tokens": (B, T+1)}
  vlm:   + {"vision_embeds": (B, n_vis, d)}, the stub frontend's output,
         prepended to the token embeddings (the loss reads only the
         tokens' positions)
  audio: {"frames": (B, n_frames, d), "tokens": (B, T+1)}: a bidirectional
         encoder over the stub frames, whose states every decoder block
         attends to; sinusoidal positions in both stacks, no rotary ones
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models import sharding
from repro_torch.utils import meshctx
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Builder,
    apply_embedding,
    apply_linear,
    rms_norm,
    sinusoidal_positions,
)
from repro_torch.models.transformer import (
    build_block,
    init_cache_stack,
    stack_apply,
)


def torch_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


#: rows of the sinusoidal table a decode step indexes (the JAX package's
#: ``serve_step`` builds 8192 and clamps a position past its end)
DECODE_POSITIONS = 8192


def has_recurrent_mixer(cfg: ModelConfig) -> bool:
    """Whether a block of ``cfg`` carries a recurrent state (Mamba, RWKV):
    such a model's prefill is exact only at the prompt's true length."""
    return bool(set(cfg.block_pattern) & {"mamba", "rwkv"})


def build_params(cfg: ModelConfig, gen: torch.Generator):
    """``(params, specs)``: the parameter tree and its spec tree."""
    pol = cfg.lowrank
    b = Builder(gen, pol, dtype=torch_dtype(cfg.param_dtype))
    NB = cfg.superblocks
    # embed's U stays replicated (the gather is local); lm_head's V is
    # vocab-sharded (logits computed shard-local)
    b.linear("embed", cfg.vocab_size, cfg.d_model, li=None, lo="embed",
             force_dense=not pol.factorize_embed)
    b.linear("lm_head", cfg.d_model, cfg.vocab_size, li="embed", lo="vocab",
             force_dense=not pol.factorize_head)
    b.vector("final_norm", (cfg.d_model,))
    for i, kind in enumerate(cfg.block_pattern):
        build_block(b, f"blocks/pos{i}", kind, cfg, NB, moe_here=cfg.moe_on_layer(i),
                    cross=cfg.is_encdec)
    if cfg.is_encdec:  # the encoder's pattern is ("attn",)
        build_block(b, "enc_blocks/pos0", "attn", cfg, cfg.encoder.num_layers, moe_here=False)
        b.vector("enc_norm", (cfg.d_model,))
    return b.build()


def _encode(params, frames, cfg: ModelConfig):
    """The Whisper-style encoder over stub frame embeddings: sinusoidal
    positions added in the compute dtype, bidirectional attention, no
    rotary positions, a final ``rms_norm``."""
    dt = torch_dtype(cfg.compute_dtype)
    h = frames.to(dt)
    h = h + sinusoidal_positions(h.shape[1], cfg.d_model, dt, h.device)[None]
    pos = torch.arange(h.shape[1], device=h.device)
    h, _, _ = stack_apply(params["enc_blocks"], h, cfg, positions=pos, causal=False,
                          use_rope=False, pattern=("attn",))
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _logits(params, h, kernels: str = "off"):
    logits = apply_linear(params["lm_head"], h, kernels=kernels)
    # sequence-sharded logits: the cross-entropy is elementwise over (B, T)
    return sharding.shard(logits, "batch", "seq", None)


def _xent(logits, labels, mask=None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32. The gold logit is read through a
    one-hot mask rather than a gather, whose backward scatters with atomics
    on CUDA; the forward value is the same (every other term is zero)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    hit = labels[..., None] == torch.arange(logits.shape[-1], device=labels.device)
    gold = torch.sum(torch.where(hit, logits, torch.zeros_like(logits)), dim=-1)
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / (torch.sum(mask) + 1e-6)
    return torch.mean(nll)


def _on_mesh(fn):
    """Under a mesh (sharding enabled) run ``fn`` with plain tensors (the
    positions, masks and constants the model makes) taken as DTensors every
    rank holds whole; without one, call it as it is."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not sharding.ENABLED:
            return fn(*args, **kwargs)
        with meshctx.implicit_replication():
            return fn(*args, **kwargs)

    return run


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Tuple[Any, Any]]
    loss_fn: Callable[[Any, Any], torch.Tensor]
    serve_prefill: Callable[..., Tuple[torch.Tensor, Any]]
    serve_step: Callable[[Any, Any, torch.Tensor], Tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    dt = torch_dtype(cfg.compute_dtype)
    use_rope = not cfg.is_encdec
    tables = {}

    def decode_positions(device):
        """The enc-dec decode step's sinusoidal table, built once per device
        (the JAX package rebuilds it at every step)."""
        key = str(device)
        if key not in tables:
            tables[key] = sinusoidal_positions(DECODE_POSITIONS, cfg.d_model, dt, device)
        return tables[key]

    def embed_inputs(params, batch, emb):
        """The VLM's vision prefix prepended to ``emb``, or the enc-dec's
        encoder states with sinusoidal positions added to ``emb``. Returns
        (emb, cross_kv, n_prefix)."""
        cross_kv, n_prefix = None, 0
        if cfg.family == "vlm" and "vision_embeds" in batch:
            vis = batch["vision_embeds"].to(dt)
            emb = torch.cat([vis, emb], dim=1)
            n_prefix = vis.shape[1]
        if cfg.is_encdec:
            cross_kv = _encode(params, batch["frames"], cfg)
            emb = emb + sinusoidal_positions(emb.shape[1], cfg.d_model, dt, emb.device)[None]
        return emb, cross_kv, n_prefix

    def loss_fn(params, batch):
        """Cross-entropy of the next token plus the MoE auxiliary loss in
        f32, over the tokens' positions (a vision prefix is cut off before
        the head)."""
        tokens = batch["tokens"].long()
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        emb = apply_embedding(params["embed"], inputs, dtype=dt, kernels=cfg.kernels)
        emb = sharding.shard(emb, "batch", None, None)
        emb, cross_kv, n_prefix = embed_inputs(params, batch, emb)
        positions = torch.arange(emb.shape[1], device=emb.device)
        h, _, aux = stack_apply(params["blocks"], emb, cfg, positions=positions,
                                cross_kv=cross_kv, use_rope=use_rope, with_aux=True)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)[:, n_prefix:]
        loss = _xent(_logits(params, h, cfg.kernels), labels)
        return loss + aux if torch.is_tensor(aux) else loss

    def init_cache(params, batch: int, cache_len: int, *, per_slot: bool = False):
        """``per_slot=True``: positions tracked per batch row — ``pos`` is
        (batch,) and the attention write indices are (NB, batch) — so a
        continuous-batching engine can admit a request into a freed slot
        while the others keep decoding (not for the enc-dec family, whose
        sinusoidal lookup indexes one shared position). An enc-dec cache
        also holds the encoder's states, ``enc_h``."""
        if per_slot and cfg.is_encdec:
            raise ValueError(
                "per-slot decode needs per-row positions; the enc-dec "
                "sinusoidal lookup indexes one shared position"
            )
        device = params["final_norm"].device
        cache = {
            "stack": init_cache_stack(cfg, batch, cache_len, dt, device, per_slot=per_slot),
            "pos": torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=device),
        }
        if cfg.is_encdec:
            cache["enc_h"] = torch.zeros((batch, cfg.encoder.num_frames, cfg.d_model),
                                         dtype=dt, device=device)
        if sharding.ENABLED and device.type != "meta":
            if per_slot:
                raise ValueError("a per-slot cache is not laid out on a mesh")
            return sharding.distribute_cache(cache, batch, meshctx.mesh())
        return cache

    def serve_prefill(params, batch, cache_len: int = 0, last_index: Optional[int] = None):
        """Process the full prompt; returns (last-token logits, cache).

        ``last_index`` reads the logits at that sequence position instead
        of the final one and stamps ``pos`` to ``last_index + 1``. For
        attention, right-padded prompts stay exact: the causal mask keeps
        pad keys out of every real query, and the serving engine's slot
        insert stamps the cache index with the true length so the pad
        entries are masked. A recurrent block has no mask: pad tokens
        would advance its state, so the engine runs such a model's prompt
        at its true length (:func:`has_recurrent_mixer`). A VLM's vision
        prefix counts in the positions, ``last_index`` included; an
        enc-dec model's encoder states go into the cache.
        """
        tokens = batch["tokens"]  # (B, S)
        emb = apply_embedding(
            params["embed"], tokens, dtype=torch.float32, kernels=cfg.kernels
        ).to(dt)
        emb, cross_kv, _ = embed_inputs(params, batch, emb)
        cache = init_cache(params, tokens.shape[0], cache_len or emb.shape[1])
        if cross_kv is not None:
            cache["enc_h"] = cross_kv
        positions = torch.arange(emb.shape[1], device=emb.device)
        h, new_stack, _ = stack_apply(params["blocks"], emb, cfg, positions=positions,
                                      caches=cache["stack"], cross_kv=cross_kv,
                                      use_rope=use_rope)
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
        (B, T) and every row attends at its own depth. An enc-dec step adds
        the sinusoidal row at ``pos`` (clamped to the table, as the JAX
        package's ``dynamic_slice`` clamps it), indexed on the device: the
        step reads no value back to the host, so a CUDA graph can capture
        it."""
        emb = apply_embedding(
            params["embed"], tokens, dtype=torch.float32, kernels=cfg.kernels
        ).to(dt)
        pos = cache["pos"]
        positions = pos[..., None] + torch.arange(tokens.shape[1], device=emb.device)
        cross_kv = None
        if cfg.is_encdec:
            cross_kv = cache["enc_h"]
            row = torch.clamp(pos, max=DECODE_POSITIONS - 1).reshape(1)
            emb = emb + decode_positions(emb.device).index_select(0, row)[None]
        h, new_stack, _ = stack_apply(params["blocks"], emb, cfg, positions=positions,
                                      caches=cache["stack"], cross_kv=cross_kv,
                                      use_rope=use_rope)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        new_cache = dict(cache, stack=new_stack, pos=pos + tokens.shape[1])
        logits = _logits(params, h[:, -1:], cfg.kernels)[:, 0]
        return logits, new_cache

    return Model(
        cfg=cfg,
        init=lambda gen: build_params(cfg, gen),
        loss_fn=_on_mesh(loss_fn),
        serve_prefill=_on_mesh(serve_prefill),
        serve_step=_on_mesh(serve_step),
        init_cache=init_cache,
    )
