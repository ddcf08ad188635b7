"""Block assembly: attention / Mamba / RWKV mixers with MLP / MoE blocks
over stacked layer parameters.

Parameters of each position of ``cfg.block_pattern`` are stacked over the
superblocks (leading dim ``NB``), as in the JAX package; its ``lax.scan``
over that axis is a Python loop here that indexes the stack. Serving
threads one cache slice per block through the loop: an attention block's
k/v written in place, a recurrent block's state returned new. On the loss
path the MoE blocks' auxiliary losses are summed over it, layer by layer,
as the scan carries them. An attention block of the encoder-decoder
family adds a cross-attention block over the encoder's states.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.factorization import is_factor
from repro_torch.kernels.ops import _local
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Builder,
    apply_linear,
    apply_rope,
    attention,
    rms_norm,
)
from repro_torch.models.moe import build_moe, moe_block
from repro_torch.models.ssm import (
    build_mamba,
    build_rwkv,
    mamba_init_state,
    mamba_mix,
    rwkv_init_state,
    rwkv_mix,
)
from repro_torch.utils import meshctx


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


def build_attn(b: Builder, prefix: str, cfg: ModelConfig, n_blocks: int, *,
               cross: bool = False):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    bs, ba = (n_blocks,), ("layers",)
    b.linear(f"{prefix}/q", d, H * hd, li="embed", lo="heads",
             batch_shape=bs, batch_axes=ba, bias=cfg.qkv_bias)
    b.linear(f"{prefix}/k", d, Hkv * hd, li="embed", lo="kv_heads",
             batch_shape=bs, batch_axes=ba, bias=cfg.qkv_bias)
    b.linear(f"{prefix}/v", d, Hkv * hd, li="embed", lo="kv_heads",
             batch_shape=bs, batch_axes=ba, bias=cfg.qkv_bias)
    b.linear(f"{prefix}/o", H * hd, d, li="heads", lo="embed",
             batch_shape=bs, batch_axes=ba)
    if cfg.qk_norm:
        b.vector(f"{prefix}/q_norm", bs + (hd,), axes=ba + (None,))
        b.vector(f"{prefix}/k_norm", bs + (hd,), axes=ba + (None,))
    if cross:
        b.linear(f"{prefix}/xq", d, H * hd, li="embed", lo="heads",
                 batch_shape=bs, batch_axes=ba)
        b.linear(f"{prefix}/xk", d, Hkv * hd, li="embed", lo="kv_heads",
                 batch_shape=bs, batch_axes=ba)
        b.linear(f"{prefix}/xv", d, Hkv * hd, li="embed", lo="kv_heads",
                 batch_shape=bs, batch_axes=ba)
        b.linear(f"{prefix}/xo", H * hd, d, li="heads", lo="embed",
                 batch_shape=bs, batch_axes=ba)
        b.vector(f"{prefix}/ln_x", bs + (d,), axes=ba + (None,))


def build_mlp(b: Builder, prefix: str, cfg: ModelConfig, n_blocks: int):
    d, dff = cfg.d_model, cfg.d_ff
    bs, ba = (n_blocks,), ("layers",)
    if cfg.gated_mlp:
        b.linear(f"{prefix}/gate", d, dff, li="embed", lo="ffn",
                 batch_shape=bs, batch_axes=ba)
    b.linear(f"{prefix}/up", d, dff, li="embed", lo="ffn",
             batch_shape=bs, batch_axes=ba)
    b.linear(f"{prefix}/down", dff, d, li="ffn", lo="embed",
             batch_shape=bs, batch_axes=ba)


def build_block(b: Builder, prefix: str, kind: str, cfg: ModelConfig,
                n_blocks: int, *, moe_here: bool, cross: bool = False):
    bs, ba = (n_blocks,), ("layers",)
    b.vector(f"{prefix}/ln1", bs + (cfg.d_model,), axes=ba + (None,))
    b.vector(f"{prefix}/ln2", bs + (cfg.d_model,), axes=ba + (None,))
    if kind == "attn":
        build_attn(b, f"{prefix}/attn", cfg, n_blocks, cross=cross)
    elif kind == "mamba":
        build_mamba(b, f"{prefix}/mamba", cfg, n_blocks)
    elif kind == "rwkv":
        build_rwkv(b, f"{prefix}/rwkv", cfg, n_blocks)
    else:
        raise ValueError(kind)
    if moe_here:
        build_moe(b, f"{prefix}/moe", cfg, n_blocks)
    else:
        build_mlp(b, f"{prefix}/mlp", cfg, n_blocks)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def attn_mix(p: dict, x, cfg: ModelConfig, *, positions, cache: Optional[dict],
             causal: bool = True, cross_kv=None, use_rope: bool = True):
    """Self-attention with an optional KV cache, then an optional
    cross-attention block.

    cache: {"k": (B,S,Hkv,hd), "v": ..., "idx": () int32} or None. A
    *per-slot* cache carries ``idx`` of shape (B,): one write position per
    sequence (continuous batching), with ``positions`` (B, T). The port
    writes the new keys and values into the cache tensors in place; the
    returned cache holds the same k/v tensors and the advanced ``idx``.
    ``use_rope`` rotates q and k (the encoder-decoder family adds
    sinusoidal positions to its inputs instead). ``cross_kv``: the
    encoder's states (B, Tenc, d), projected through ``xk`` / ``xv`` at
    every call and attended to without a mask but the positions' own.
    Returns (y, new_cache).
    """
    B, T, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _heads(apply_linear(p["q"], x, bias=p.get("q_b"), kernels=cfg.kernels), H, hd)
    k = _heads(apply_linear(p["k"], x, bias=p.get("k_b"), kernels=cfg.kernels), Hkv, hd)
    v = _heads(apply_linear(p["v"], x, bias=p.get("v_b"), kernels=cfg.kernels), Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # context parallelism: the queries stay sequence-sharded
    q = sharding.shard(q, "batch", "seq", None, None)

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
        if isinstance(ck, DTensor):
            cols = (torch.remainder(idx, S) + t_idx).long()
            _write_sharded(ck, k, cols)
            _write_sharded(cv, v, cols)
            newest = idx + (T - 1)
        elif idx.dim():  # per-slot (B,): each row writes at its own position
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
        y = attention(q, ck, cv, q_positions=positions, kv_positions=kv_pos, causal=causal,
                      sliding_window=cfg.sliding_window, q_chunk=cfg.attn_q_chunk)
        new_cache = {"k": ck, "v": cv, "idx": idx + T}
    else:
        y = attention(q, k, v, q_positions=positions, kv_positions=positions, causal=causal,
                      sliding_window=cfg.sliding_window, q_chunk=cfg.attn_q_chunk)
    y = sharding.shard(y, "batch", "seq", None, None)
    out = apply_linear(p["o"], y.reshape(B, T, H * hd), kernels=cfg.kernels)

    if cross_kv is not None:
        # the block's normed input plus the self-attention's output, as the
        # JAX package normalises it (not the residual stream)
        xh = rms_norm(x + out, p["ln_x"], cfg.norm_eps)
        qx = _heads(apply_linear(p["xq"], xh, kernels=cfg.kernels), H, hd)
        Tenc = cross_kv.shape[1]
        ek = _heads(apply_linear(p["xk"], cross_kv, kernels=cfg.kernels), Hkv, hd)
        ev = _heads(apply_linear(p["xv"], cross_kv, kernels=cfg.kernels), Hkv, hd)
        yx = attention(qx, ek, ev, q_positions=positions,
                       kv_positions=torch.arange(Tenc, device=x.device),
                       causal=False, sliding_window=0, q_chunk=cfg.attn_q_chunk)
        out = out + apply_linear(p["xo"], yx.reshape(B, T, H * hd), kernels=cfg.kernels)
    return out, new_cache


def _heads(t, H: int, hd: int):
    """(B, T, H·hd) → (B, T, H, hd). A DTensor split on its last dim over a
    mesh axis that does not divide ``H`` is gathered on that dim first
    (DTensor cannot split the heads unevenly)."""
    if isinstance(t, DTensor):
        mesh, pl = t.device_mesh, list(t.placements)
        bad = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == t.dim() - 1
               and H % mesh.size(i)]
        if bad:
            t = t.redistribute(mesh, [Replicate() if i in bad else p for i, p in enumerate(pl)])
    return t.reshape(tuple(t.shape[:-1]) + (H, hd))


def _write_sharded(c, new, cols):
    """``c[:, cols] = new`` on the local shard of the DTensor cache ``c``
    (B, S, Hkv, hd): ``new`` (B, T, Hkv, hd) takes ``c``'s placements on
    the batch and head dims; a cache sharded on its sequence dim (a batch
    smaller than the data axes) writes each slot on the rank that holds it."""
    mesh = c.device_mesh
    want, seq = [], []
    for i, pl in enumerate(c.placements):
        if isinstance(pl, Shard) and pl.dim == 1:
            want.append(Replicate())
            seq.append(i)
        else:
            want.append(pl)
    local = c.to_local()
    nl = _local(meshctx.as_dtensor(new, mesh), mesh, want, [None] * mesh.ndim).to(local.dtype)
    cols = cols.full_tensor() if isinstance(cols, DTensor) else cols
    if not seq:
        local.index_copy_(1, cols, nl)
        return
    n = local.shape[1]
    off = 0
    for i in seq:
        off = off * mesh.size(i) + mesh.get_local_rank(i)
    if nl.shape[1] == 1:  # a decode step: one slot, on one rank
        at = cols - off * n
        mine = (at >= 0) & (at < n)
        at = torch.clamp(at, 0, n - 1)
        old = local.index_select(1, at)
        local.index_copy_(1, at, torch.where(mine[None, :, None, None], nl, old))
        return
    # a prefill writes T contiguous slots from cols[0] (it does not wrap):
    # each local slot takes its token, if one falls on it
    t = off * n + torch.arange(n, device=local.device) - cols[0]
    mine = (t >= 0) & (t < nl.shape[1])
    rows = nl.index_select(1, torch.clamp(t, 0, nl.shape[1] - 1))
    local.copy_(torch.where(mine[None, :, None, None], rows, local))


def mlp_apply(p: dict, x, cfg: ModelConfig):
    if cfg.gated_mlp:
        h = F.silu(apply_linear(p["gate"], x, kernels=cfg.kernels)) * apply_linear(
            p["up"], x, kernels=cfg.kernels
        )
    else:
        h = F.gelu(apply_linear(p["up"], x, kernels=cfg.kernels), approximate="tanh")
    h = sharding.shard(h, "batch", "seq", None)
    return apply_linear(p["down"], h, kernels=cfg.kernels)


def block_apply(p: dict, kind: str, x, cfg: ModelConfig, *, positions,
                cache: Optional[dict], causal: bool = True, cross_kv=None,
                use_rope: bool = True, with_aux: bool = False):
    """One (mixer + MLP or MoE) block with pre-norm residuals. Returns (x,
    new_cache, aux_loss); aux_loss is None but for a MoE block asked
    ``with_aux``. A recurrent mixer reads no positions: its cache is its
    state. ``causal``, ``cross_kv`` and ``use_rope`` reach attention only
    (:func:`attn_mix`)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        mix_out, new_cache = attn_mix(p["attn"], h, cfg, positions=positions, cache=cache,
                                      causal=causal, cross_kv=cross_kv, use_rope=use_rope)
    elif kind == "mamba":
        mix_out, new_cache = mamba_mix(p["mamba"], h, cfg, state=cache)
    elif kind == "rwkv":
        mix_out, new_cache = rwkv_mix(p["rwkv"], h, cfg, state=cache)
    else:
        raise ValueError(kind)
    x = x + mix_out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        ffn_out, aux = moe_block(p["moe"], h2, cfg, with_aux=with_aux)
    else:
        ffn_out, aux = mlp_apply(p["mlp"], h2, cfg), None
    return x + ffn_out, new_cache, aux


# ---------------------------------------------------------------------------
# the stack over superblocks
# ---------------------------------------------------------------------------


def init_cache_stack(cfg: ModelConfig, batch: int, cache_len: int, dtype, device, *,
                     per_slot: bool = False) -> dict:
    """Per-position cache stacks (leading dim = superblocks). ``per_slot``
    makes the attention write index a vector over the batch, (NB, batch)
    instead of (NB,), so sequences can sit at different positions in one
    batch. A Mamba position holds {"h" f32, "conv"} and an RWKV position
    {"S" f32, "shift"}, each with batch on axis 1."""
    NB = cfg.superblocks
    Hkv, hd = cfg.num_kv_heads, cfg.hd
    idx_shape = (NB, batch) if per_slot else (NB,)
    caches = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "attn":
            c = {
                "k": torch.zeros((NB, batch, cache_len, Hkv, hd), dtype=dtype, device=device),
                "v": torch.zeros((NB, batch, cache_len, Hkv, hd), dtype=dtype, device=device),
                "idx": torch.zeros(idx_shape, dtype=torch.int32, device=device),
            }
        elif kind in ("mamba", "rwkv"):
            init = mamba_init_state if kind == "mamba" else rwkv_init_state
            c = {k: v.expand((NB,) + v.shape).contiguous()
                 for k, v in init(cfg, batch, dtype, device).items()}
        else:
            raise ValueError(kind)
        caches[f"pos{i}"] = c
    return caches


def _layer(tree, i: int):
    """Member ``i`` of a stacked parameter or cache tree (views)."""
    if is_factor(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def stack_apply(blocks: dict, x, cfg: ModelConfig, *, positions,
                caches: Optional[dict] = None, causal: bool = True, cross_kv=None,
                use_rope: bool = True, pattern=None, with_aux: bool = False):
    """Run the superblock stack. blocks/caches: dicts of stacked params and
    cache slices, one entry per position of ``pattern`` (by default
    ``cfg.block_pattern``); the number of superblocks is the stacks'
    leading dim, so the encoder's stack of ``encoder.num_layers`` under
    ``("attn",)`` runs here too. Returns (x, new_caches, total_aux); the new caches are
    stacked like the old ones. A leaf a block wrote in place (attention's
    k/v) stays the old stack; every other leaf (attention's ``idx``, a
    recurrent block's state) is a new stack of the blocks' new values, so
    the old caches still hold the state the step started from.
    ``with_aux``: ``total_aux`` is the f32 sum of the MoE blocks'
    auxiliary losses in layer order (0 where there are none); otherwise 0."""
    pattern = pattern or cfg.block_pattern
    h = x
    aux = 0
    new = {f"pos{i}": {} for i in range(len(pattern))}
    for sb in range(blocks["pos0"]["ln1"].shape[0]):
        h = sharding.shard(h, "batch", "seq", None)
        for i, kind in enumerate(pattern):
            # the residual stream's layout is pinned at every layer
            h = sharding.shard(h, "batch", "seq", None)
            key = f"pos{i}"
            c_i = _layer(caches[key], sb) if caches is not None else None
            h, nc, a = block_apply(_layer(blocks[key], sb), kind, h, cfg,
                                   positions=positions, cache=c_i, causal=causal,
                                   cross_kv=cross_kv, use_rope=use_rope, with_aux=with_aux)
            if a is not None:
                aux = aux + a
            for name, leaf in (nc or {}).items():
                if leaf is not c_i[name]:
                    new[key].setdefault(name, []).append(leaf)
    if caches is None:
        return h, None, aux
    new_caches = {
        key: {name: torch.stack(new[key][name]) if name in new[key] else leaf
              for name, leaf in c.items()}
        for key, c in caches.items()
    }
    return h, new_caches, aux
