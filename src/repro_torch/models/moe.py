"""Mixture-of-Experts block with capacity-based routing and low-rank
experts — the JAX package's ``models/moe.py`` in PyTorch.

Routing is the JAX package's sort-based dispatch: the router's softmax
picks each token's top-k experts, and per expert the first ``cap`` tokens
that chose it, by position, are gathered into an ``(E, cap, d)`` batch
(``cap = min(max(int(cf·k·N/E), 1), N)``; slots no token fills carry a
filler row of weight 0). Expert weights are stacked factors ``U:(E, d,
r)``, so through :func:`~repro_torch.core.factorization.lr_matmul` the
kernel chain runs the expert axis as its grid axis: one ``xus`` and one
``avt`` launch per projection for all E experts.

The combine gathers where the JAX package scatter-adds: each token reads
the ``(expert, slot)`` rows of its kept choices and sums them in ascending
expert order, which is the order of the JAX package's scatter-add, with
no atomics on the card. The dispatch and the combine are each other's
backward (:class:`_Dispatch`, :class:`_Combine`): gathers of N·k or E·cap
rows, the same bits on every run.

FeDLRT treats every expert's ``(U_e, S_e, V_e)`` like any other factor
leaf: the stacked axis is one more batch dim of the augmentation and the
truncation.

Under a mesh the expert pipeline is pinned to the expert-parallel layout
(the experts on "model", as the JAX package pins it), and the routing,
which DTensor has no rule for (a stable sort, gathers over all tokens),
runs on each rank over every token of its batch (:func:`_sharded_moe`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.factorization import is_factor, lr_matmul
from repro_torch.kernels.ops import _from_local, _local
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import Builder
from repro_torch.utils import meshctx


def build_moe(b: Builder, prefix: str, cfg: ModelConfig, n_blocks: int):
    """Register MoE params for a stack of ``n_blocks`` layers."""
    m = cfg.moe
    d = cfg.d_model
    bs, ba = (n_blocks, m.num_experts), ("layers", "experts")
    b.linear(f"{prefix}/router", d, m.num_experts, batch_shape=(n_blocks,),
             batch_axes=("layers",), force_dense=True, init_scale=0.02)
    # expert-parallel only: the expert dim carries the "model" axis, so the
    # per-expert feature dims stay unsharded (a mesh axis appears once a spec)
    b.linear(f"{prefix}/up", d, m.d_expert, li=None, lo=None,
             batch_shape=bs, batch_axes=ba)
    b.linear(f"{prefix}/gate", d, m.d_expert, li=None, lo=None,
             batch_shape=bs, batch_axes=ba)
    b.linear(f"{prefix}/down", m.d_expert, d, li=None, lo=None,
             batch_shape=bs, batch_axes=ba)
    if m.num_shared_experts:
        ds = m.d_shared or m.d_expert * m.num_shared_experts
        b.linear(f"{prefix}/shared_up", d, ds, li="embed", lo="ffn",
                 batch_shape=(n_blocks,), batch_axes=("layers",))
        b.linear(f"{prefix}/shared_gate", d, ds, li="embed", lo="ffn",
                 batch_shape=(n_blocks,), batch_axes=("layers",))
        b.linear(f"{prefix}/shared_down", ds, d, li="ffn", lo="embed",
                 batch_shape=(n_blocks,), batch_axes=("layers",))


def _stacked_linear(w, x, kernels: str = "off") -> torch.Tensor:
    """x: (E, cap, n_in) through the stacked (E, n_in, n_out) dense weight
    or factor; under a kernel policy a factor's chain runs E as the
    kernels' grid axis."""
    if is_factor(w):
        if kernels != "off":
            return lr_matmul(x, w, kernels=kernels)
        h = torch.matmul(x, w.U.to(x.dtype))
        h = torch.matmul(h, w.S.to(x.dtype))
        return torch.matmul(h, w.V.to(x.dtype).transpose(-1, -2))
    return torch.matmul(x, w.to(x.dtype))


#: the shared experts' unstacked (n_in, n_out) weights on (N, n_in) rows:
#: the same chain (``torch.matmul`` broadcasts where the JAX package needs
#: a second einsum)
_dense_linear = _stacked_linear


def _shared_ffn(p: dict, xf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The shared ("always-on") experts of the DeepSeekMoE design: one
    gated FFN of ``shared_gate`` / ``shared_up`` / ``shared_down`` that
    every token of ``xf`` ((N, d), or (B, T, d) under a mesh) passes
    through beside its routed experts."""
    hs = F.silu(_dense_linear(p["shared_gate"], xf, cfg.kernels)) * _dense_linear(
        p["shared_up"], xf, cfg.kernels
    )
    return _dense_linear(p["shared_down"], hs, cfg.kernels)


class Routing(NamedTuple):
    """One MoE block's routing of N tokens over E experts."""

    probs: torch.Tensor    # (N, E) f32 router softmax
    topi: torch.Tensor     # (N, k) chosen experts, by descending probability
    chose: torch.Tensor    # (N, E) f32 normalised gate where chosen, else 0
    take: torch.Tensor     # (cap, E) token ids dispatched to each expert
    w_taken: torch.Tensor  # (cap, E) their gates; 0 marks a filler row
    cap: int


def route(router: torch.Tensor, xf: torch.Tensor, m: MoEConfig) -> Routing:
    """Top-k routing and capacity dispatch of ``xf`` (N, d), with the JAX
    package's tie rules: top-k breaks ties toward the lower expert (a
    stable descending sort, as ``lax.top_k``) and the dispatch keeps the
    first choosing tokens by position, then fills with the first
    non-choosing ones (a stable argsort, as ``jnp.argsort``)."""
    N = xf.shape[0]
    E, k = m.num_experts, m.top_k
    cap = max(int(m.capacity_factor * k * N / E), 1)
    cap = min(cap, N)
    # the router's product in the activation dtype, then f32 (as the JAX
    # package: in bf16 serving the choices follow the bf16 logits)
    logits = (xf @ router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = ranked[:, :k], order[:, :k]
    gates = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-9)
    chose = torch.zeros_like(probs).scatter(1, topi, gates)
    tok = torch.arange(N, device=xf.device)[:, None]
    prio = torch.where(chose > 0, tok, torch.full_like(tok, N))
    take = torch.argsort(prio, dim=0, stable=True)[:cap]  # (cap, E)
    w_taken = torch.gather(chose, 0, take)
    return Routing(probs=probs, topi=topi, chose=chose, take=take, w_taken=w_taken, cap=cap)


class _Slots(NamedTuple):
    """Where each token's choices sit in the ``(E·cap, d)`` expert rows."""

    take: torch.Tensor       # (cap, E) token ids dispatched to each expert
    src: torch.Tensor        # (N, k) row e·cap + slot of each choice, experts ascending
    kept: torch.Tensor       # (N, k) the choice fit in its expert's capacity
    kept_rows: torch.Tensor  # (E, cap) the row holds a kept choice, not a filler


def _slots(r: Routing) -> _Slots:
    # a kept choice of expert e sits in the slot of its rank among e's
    # choosers
    chosen = r.chose > 0
    slot = torch.cumsum(chosen.to(torch.int32), dim=0) - 1  # (N, E)
    kept = chosen & (slot < r.cap)
    experts, _ = torch.sort(r.topi, dim=-1)  # (N, k)
    kept = torch.gather(kept, 1, experts)
    slot = torch.gather(slot, 1, experts).clamp(0, r.cap - 1)
    return _Slots(take=r.take, src=experts * r.cap + slot, kept=kept,
                  kept_rows=(r.w_taken > 0).T)


def _zero_where_not(mask, rows):
    return torch.where(mask[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))


def _sum_kept(rows: torch.Tensor, s: _Slots) -> torch.Tensor:
    """(E·cap, d) rows → (N, d): each token's kept rows summed in ascending
    expert order; a dropped choice adds 0."""
    got = _zero_where_not(s.kept, rows[s.src])  # (N, k, d)
    out = got[:, 0]
    for j in range(1, got.shape[1]):
        out = out + got[:, j]
    return out


class _Dispatch(torch.autograd.Function):
    """``xf[take.T]``, the (E, cap, d) expert batch. The backward sums each
    token's kept rows (:func:`_sum_kept`) and leaves the filler rows out:
    in :func:`moe_block` their gradient is 0, as their gate is."""

    @staticmethod
    def forward(ctx, xf, s):
        ctx.s = s
        return xf[s.take.T]

    @staticmethod
    def backward(ctx, g):
        E, cap, d = g.shape
        return _sum_kept(g.reshape(E * cap, d), ctx.s), None


class _Combine(torch.autograd.Function):
    """:func:`_sum_kept` of the (E, cap, d) expert outputs. The backward
    hands each kept row its token's gradient, and each filler row 0."""

    @staticmethod
    def forward(ctx, ye, s):
        ctx.s = s
        E, cap, d = ye.shape
        return _sum_kept(ye.reshape(E * cap, d), s)

    @staticmethod
    def backward(ctx, g):
        return _zero_where_not(ctx.s.kept_rows, g[ctx.s.take.T]), None


def _sharded_dispatch(p: dict, x, m: MoEConfig):
    """The routing and dispatch of :func:`moe_block` on DTensor tokens.

    Every rank gathers all N tokens and routes them (the routing is a
    stable sort and gathers over all tokens, which DTensor has no rule
    for), then dispatches the rows of its own experts: the experts' mesh
    axes are those the expert factors are sharded on. Each rank's combine
    sums the rows of its experts, so the output is a partial sum over those
    axes, and so is each rank's share of the auxiliary loss; the local
    gradients of the gathered tokens and of the router are declared partial
    sums likewise. ``x`` is (B, T, d); the combine returns (B, T, d).
    Returns (xe, gate weights, combine, aux share)."""
    mesh = x.device_mesh
    nd = mesh.ndim
    w_up = p["up"].U if is_factor(p["up"]) else p["up"]
    edims = [i for i in range(nd) if mesh.size(i) > 1
             and isinstance(w_up.placements[i], Shard) and w_up.placements[i].dim == 0]
    ne = 1
    coord = 0
    for i in edims:
        ne *= mesh.size(i)
        coord = coord * mesh.size(i) + mesh.get_local_rank(i)
    rep = [Replicate()] * nd
    grad = [Partial() if i in edims else Replicate() for i in range(nd)]
    on_experts = [Shard(0) if i in edims else Replicate() for i in range(nd)]
    summed = [Partial() if i in edims else Replicate() for i in range(nd)]
    B, T, d = x.shape
    xl = _local(x, mesh, rep, grad).reshape(B * T, d)
    router = _local(meshctx.as_dtensor(p["router"], mesh), mesh, rep, grad)
    r = route(router, xl, m)
    s = _slots(r)
    E = m.num_experts
    El = E // ne
    e0, e1 = coord * El, (coord + 1) * El
    mine = (s.src >= e0 * r.cap) & (s.src < e1 * r.cap)
    sl = _Slots(take=s.take[:, e0:e1], src=torch.where(mine, s.src - e0 * r.cap, 0),
                kept=s.kept & mine, kept_rows=s.kept_rows[e0:e1])
    xe = _Dispatch.apply(xl, sl) if xl.requires_grad else xl[sl.take.T]
    xe = _from_local(xe, mesh, on_experts, (E, r.cap, d))
    w = _from_local(r.w_taken[:, e0:e1].T[..., None], mesh, on_experts, (E, r.cap, 1))

    def combine(ye):
        yl = ye.to_local()
        out = (_Combine.apply(yl, sl) if yl.requires_grad
               else _sum_kept(yl.reshape(El * r.cap, d), sl))
        return _from_local(out.reshape(B, T, d), mesh, summed, (B, T, d))

    frac_routed = torch.mean((r.chose > 0).to(torch.float32), dim=0)  # (E,)
    aux = m.aux_loss_weight * E * torch.sum(frac_routed * torch.mean(r.probs, dim=0))
    return xe, w, combine, _from_local(aux / ne, mesh, summed, ())


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              with_aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply one MoE FFN. x: (B, T, d) → (y, aux_loss); the aux loss is
    None unless ``with_aux`` (the loss path asks for it, serving does not).

    All B·T tokens compete for one capacity pool, as in the JAX package, so
    a token's output depends on the batch it shares when the capacity
    binds (ROADMAP.md, "In the reference")."""
    m = cfg.moe
    B, T, d = x.shape
    N = B * T
    E = m.num_experts
    if isinstance(x, DTensor):
        # the shared experts below take (B, T, d): a DTensor split on T
        # cannot be flattened into rows
        xe, w, combine, aux = _sharded_dispatch(p, x, m)
        xf = x
    else:
        xf = x.reshape(N, d)
        r = route(p["router"], xf, m)
        s = _slots(r)
        xe = _Dispatch.apply(xf, s) if xf.requires_grad else xf[s.take.T]  # (E, cap, d)
        w = r.w_taken.T[..., None]

        def combine(ye):
            if ye.requires_grad:
                return _Combine.apply(ye, s)
            return _sum_kept(ye.reshape(E * r.cap, d), s)

        aux = None
    # every stage of the expert pipeline is pinned to the expert-parallel
    # layout
    xe = sharding.shard(xe, "experts", None, None)
    gate_h = sharding.shard(_stacked_linear(p["gate"], xe, cfg.kernels), "experts", None, None)
    up_h = sharding.shard(_stacked_linear(p["up"], xe, cfg.kernels), "experts", None, None)
    h = F.silu(gate_h) * up_h
    ye = _stacked_linear(p["down"], h, cfg.kernels)  # (E, cap, d)
    ye = sharding.shard(ye, "experts", None, None)
    ye = ye * w.to(ye.dtype)
    out = combine(ye)

    if "shared_up" in p:
        out = out + _shared_ffn(p, xf, cfg)
    out = out.reshape(B, T, d)
    if not with_aux:
        return out, None
    if aux is not None:
        return out, aux

    # switch-style load-balance auxiliary loss
    frac_routed = torch.mean((r.chose > 0).to(torch.float32), dim=0)  # (E,)
    mean_prob = torch.mean(r.probs, dim=0)
    return out, m.aux_loss_weight * E * torch.sum(frac_routed * mean_prob)
