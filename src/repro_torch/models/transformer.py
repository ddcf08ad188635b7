"""Block assembly: attention + MLP blocks over stacked layer parameters.

Parameters of each position of ``cfg.block_pattern`` are stacked over the
superblocks (leading dim ``NB``), as in the JAX package; its ``lax.scan``
over that axis is a Python loop here that indexes the stack. Serving
threads one cache slice per block through the loop.

The port runs the attention mixer and the (gated) MLP. Mamba, RWKV, MoE and
cross-attention raise ``NotImplementedError``: see ROADMAP.md, queue 1.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.factorization import is_factor
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Builder,
    apply_linear,
    apply_rope,
    attention,
    rms_norm,
)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet; see ROADMAP.md, queue 1"
    )


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


def build_attn(b: Builder, prefix: str, cfg: ModelConfig, n_blocks: int):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    bs = (n_blocks,)
    b.linear(f"{prefix}/q", d, H * hd, batch_shape=bs, bias=cfg.qkv_bias)
    b.linear(f"{prefix}/k", d, Hkv * hd, batch_shape=bs, bias=cfg.qkv_bias)
    b.linear(f"{prefix}/v", d, Hkv * hd, batch_shape=bs, bias=cfg.qkv_bias)
    b.linear(f"{prefix}/o", H * hd, d, batch_shape=bs)
    if cfg.qk_norm:
        b.vector(f"{prefix}/q_norm", bs + (hd,))
        b.vector(f"{prefix}/k_norm", bs + (hd,))


def build_mlp(b: Builder, prefix: str, cfg: ModelConfig, n_blocks: int):
    d, dff = cfg.d_model, cfg.d_ff
    bs = (n_blocks,)
    if cfg.gated_mlp:
        b.linear(f"{prefix}/gate", d, dff, batch_shape=bs)
    b.linear(f"{prefix}/up", d, dff, batch_shape=bs)
    b.linear(f"{prefix}/down", dff, d, batch_shape=bs)


def build_block(b: Builder, prefix: str, kind: str, cfg: ModelConfig,
                n_blocks: int, *, moe_here: bool):
    if kind != "attn":
        raise _not_ported(f"the {kind!r} mixer")
    if moe_here:
        raise _not_ported("the MoE block")
    bs = (n_blocks,)
    b.vector(f"{prefix}/ln1", bs + (cfg.d_model,))
    b.vector(f"{prefix}/ln2", bs + (cfg.d_model,))
    build_attn(b, f"{prefix}/attn", cfg, n_blocks)
    build_mlp(b, f"{prefix}/mlp", cfg, n_blocks)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def attn_mix(p: dict, x, cfg: ModelConfig, *, positions, cache: Optional[dict]):
    """Self-attention with an optional KV cache.

    cache: {"k": (B,S,Hkv,hd), "v": ..., "idx": () int32} or None. A
    *per-slot* cache carries ``idx`` of shape (B,): one write position per
    sequence (continuous batching), with ``positions`` (B, T). The port
    writes the new keys and values into the cache tensors in place; the
    returned cache holds the same k/v tensors and the advanced ``idx``.
    Returns (y, new_cache).
    """
    B, T, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = apply_linear(p["q"], x, bias=p.get("q_b"), kernels=cfg.kernels).reshape(B, T, H, hd)
    k = apply_linear(p["k"], x, bias=p.get("k_b"), kernels=cfg.kernels).reshape(B, T, Hkv, hd)
    v = apply_linear(p["v"], x, bias=p.get("v_b"), kernels=cfg.kernels).reshape(B, T, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        ck, cv, idx = cache["k"], cache["v"], cache["idx"]
        S = ck.shape[1]
        if cfg.sliding_window and S < cfg.sliding_window and S < 4096:
            raise ValueError("cache smaller than the attention window")
        # ring write at idx (mod cache length). A multi-token write
        # (prefill) must not wrap: callers size the prefill cache at
        # >= prompt length; decode writes are single-token and wrap freely.
        # (index tensors on the device: no host sync on the decode path)
        t_idx = torch.arange(T, device=x.device)
        s_idx = torch.arange(S, dtype=torch.int32, device=x.device)
        if idx.dim():  # per-slot (B,): each row writes at its own position
            rows = torch.arange(B, device=x.device)[:, None]
            cols = (torch.remainder(idx, S)[:, None] + t_idx).long()  # (B, T)
            ck[rows, cols] = k.to(ck.dtype)
            cv[rows, cols] = v.to(cv.dtype)
            newest = idx[:, None] + (T - 1)  # (B, 1)
        else:
            cols = (torch.remainder(idx, S) + t_idx).long()  # (T,)
            ck.index_copy_(1, cols, k.to(ck.dtype))
            cv.index_copy_(1, cols, v.to(cv.dtype))
            newest = idx + (T - 1)
        # absolute position held by each slot: the newest p <= newest with
        # p % S == s; never written -> negative, masked
        kv_pos = newest - torch.remainder(newest - s_idx, S)
        kv_pos = torch.where(kv_pos < 0, torch.full_like(kv_pos, -(10**9)), kv_pos)
        y = attention(q, ck, cv, q_positions=positions, kv_positions=kv_pos,
                      sliding_window=cfg.sliding_window)
        new_cache = {"k": ck, "v": cv, "idx": idx + T}
    else:
        y = attention(q, k, v, q_positions=positions, kv_positions=positions,
                      sliding_window=cfg.sliding_window)
    out = apply_linear(p["o"], y.reshape(B, T, H * hd), kernels=cfg.kernels)
    return out, new_cache


def mlp_apply(p: dict, x, cfg: ModelConfig):
    if cfg.gated_mlp:
        h = F.silu(apply_linear(p["gate"], x, kernels=cfg.kernels)) * apply_linear(
            p["up"], x, kernels=cfg.kernels
        )
    else:
        h = F.gelu(apply_linear(p["up"], x, kernels=cfg.kernels), approximate="tanh")
    return apply_linear(p["down"], h, kernels=cfg.kernels)


def block_apply(p: dict, kind: str, x, cfg: ModelConfig, *, positions,
                cache: Optional[dict]):
    """One (attention + MLP) block with pre-norm residuals.
    Returns (x, new_cache)."""
    if kind != "attn":
        raise _not_ported(f"the {kind!r} mixer")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mix_out, new_cache = attn_mix(p["attn"], h, cfg, positions=positions, cache=cache)
    x = x + mix_out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg), new_cache


# ---------------------------------------------------------------------------
# the stack over superblocks
# ---------------------------------------------------------------------------


def init_cache_stack(cfg: ModelConfig, batch: int, cache_len: int, dtype, device, *,
                     per_slot: bool = False) -> dict:
    """Per-position cache stacks (leading dim = superblocks). ``per_slot``
    makes the write index a vector over the batch, (NB, batch) instead of
    (NB,), so sequences can sit at different positions in one batch."""
    NB = cfg.superblocks
    Hkv, hd = cfg.num_kv_heads, cfg.hd
    idx_shape = (NB, batch) if per_slot else (NB,)
    caches = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind != "attn":
            raise _not_ported(f"the {kind!r} mixer's decode state")
        caches[f"pos{i}"] = {
            "k": torch.zeros((NB, batch, cache_len, Hkv, hd), dtype=dtype, device=device),
            "v": torch.zeros((NB, batch, cache_len, Hkv, hd), dtype=dtype, device=device),
            "idx": torch.zeros(idx_shape, dtype=torch.int32, device=device),
        }
    return caches


def _layer(tree, i: int):
    """Member ``i`` of a stacked parameter or cache tree (views)."""
    if is_factor(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def stack_apply(blocks: dict, x, cfg: ModelConfig, *, positions,
                caches: Optional[dict] = None):
    """Run the superblock stack. blocks/caches: dicts of stacked params and
    cache slices. Returns (x, new_caches); the new caches are stacked like
    the old ones (their k/v tensors are the old ones, written in place)."""
    pattern = cfg.block_pattern
    h = x
    new_idx = {f"pos{i}": [] for i in range(len(pattern))}
    for sb in range(cfg.superblocks):
        for i, kind in enumerate(pattern):
            key = f"pos{i}"
            c_i = _layer(caches[key], sb) if caches is not None else None
            h, nc = block_apply(_layer(blocks[key], sb), kind, h, cfg,
                                positions=positions, cache=c_i)
            if nc is not None:
                new_idx[key].append(nc["idx"])
    if caches is None:
        return h, None
    new_caches = {
        key: {"k": c["k"], "v": c["v"], "idx": torch.stack(new_idx[key])}
        for key, c in caches.items()
    }
    return h, new_caches
