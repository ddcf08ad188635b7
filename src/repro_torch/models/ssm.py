"""State-space and linear-RNN sequence mixers: Mamba (Jamba) and RWKV6
(Finch), the JAX package's ``models/ssm.py`` in PyTorch.

Both are attention-free O(T) mixers. Their projections (Mamba's in / out,
x and dt projections; RWKV's r / k / v / g / out) go through
:func:`apply_linear`, so a factorized one launches one ``xus`` and one
``avt`` kernel on the card; the recurrence parameters (A, the conv taps,
the decay LoRA, the bonus u) are small dense tensors.

The JAX package computes both recurrences in XLA, not in a Pallas kernel.
The port writes them so:

- Mamba, with a state (the serving prefill and every decode step) or
  without one (training, from a zero state): the reference's recurrence in
  its sequential order, at any T, as one call of the Hopper selective-scan
  kernel (:func:`repro_torch.kernels.selective_scan.selective_scan`: token
  by token, the state in registers, ``y_t = Σ_n h_t C_t`` fused in; its
  plain version on CPU tensors, its custom op on fake ones), so every step
  sums in the reference's serving order: the recurrence over T tokens is
  the recurrence over the first few and then the rest a token at a time,
  bit for bit. With a gradient its forward keeps the state every 16 steps
  and its backward is the Hopper kernel of the reference's reverse
  recurrence, so no (B, T, d_inner, N) tensor is formed. The JAX package's
  training branch takes ``associative_scan`` in chunks of
  ``cfg.mamba.scan_chunk``; the port's scan forms no workspace, so the
  chunk does not change what it computes.
- :func:`linear_recurrence`: the diagonal recurrence
  ``h_t = a_t ⊙ h_{t-1} + b_t`` as a log-depth doubling scan with the
  reference's reverse-recurrence backward, the counterpart of the JAX
  package's public ``linear_recurrence``; no model path calls it.
- RWKV6: chunked linear attention (per-chunk quadratic mixing, a loop over
  the chunk states), in f32 whatever the compute dtype.

The dtypes are the JAX package's: the scan's state is the compute dtype
(bf16 at full width), Mamba's returned state ``h``, ``A = -exp(A_log)``
and the whole wkv are f32.

Under a mesh RWKV's wkv and decay LoRA run on each rank's rows and heads
(:func:`_sharded_wkv`, :func:`repro_torch.kernels.ops.rowwise_local`), and
Mamba's scan on each rank's rows and channels
(:func:`_sharded_selective_scan`; :func:`_sharded_recurrence` for
:func:`linear_recurrence`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.ops import _from_local, _local, rowwise_local
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Builder, apply_linear, rms_norm
from repro_torch.utils import meshctx


# ===========================================================================
# Mamba
# ===========================================================================


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t ⊙ h_{t-1} + b_t`` along axis 1 from
    ``h_{-1} = 0``, by recursive doubling: after the pass at offset ``s``
    each (a_t, b_t) composes the steps ``t - 2s + 1 .. t``."""
    T, s = a.shape[1], 1
    while s < T:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])], dim=1)
        if 2 * s < T:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


class _LinearRecurrence(torch.autograd.Function):
    """Forward: the doubling scan. Backward: the JAX package's reverse
    recurrence (``_linrec_bwd``), from the residuals ``a``, ``h`` and
    ``h0`` alone:

        λ_t = ḡ_t + a_{t+1} ⊙ λ_{t+1};  ā_t = λ_t ⊙ h_{t-1};  b̄_t = λ_t;
        h̄0 = a_0 ⊙ λ_0.
    """

    @staticmethod
    def forward(ctx, a, b, h0):
        b0 = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
        h = _scan(a, b0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        a_rev = torch.flip(a, dims=(1,))
        a_shift = torch.cat([torch.ones_like(a_rev[:, :1]), a_rev[:, :-1]], dim=1)
        lam = torch.flip(_scan(a_shift, torch.flip(dh, dims=(1,))), dims=(1,))
        h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
        return lam * h_prev, lam, a[:, 0] * lam[:, 0]


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t ⊙ h_{t-1} + b_t`` along axis 1 from ``h0``, returning
    every ``h_t``. a, b: (B, T, ...); h0: (B, ...). The backward keeps only
    ``a``, ``h`` and ``h0`` (the reason the JAX package gives its scan a
    custom VJP: differentiating the scan itself keeps O(log T) full-size
    intermediates a layer). Under a mesh it runs on each rank's rows and
    channels, over all of T (:func:`_sharded_recurrence`)."""
    if isinstance(a, DTensor):
        return _sharded_recurrence(a, b, h0)
    return _LinearRecurrence.apply(a, b, h0)


def _sharded_recurrence(a, b, h0):
    """:func:`linear_recurrence` on DTensors: elementwise over the batch and
    the channels, so each rank runs its shard of them; a split of T is
    gathered (the recurrence runs along all of it)."""
    mesh = a.device_mesh
    b, h0 = meshctx.as_dtensor(b, mesh), meshctx.as_dtensor(h0, mesh)
    pa, ph = [], []
    for i, p in enumerate(a.placements):
        if mesh.size(i) == 1 or not isinstance(p, Shard) or p.dim == 1:
            pa.append(p if mesh.size(i) == 1 else Replicate())
            ph.append(h0.placements[i] if mesh.size(i) == 1 else Replicate())
        else:  # the batch (dim 0) or a channel dim (h0 has no T dim)
            pa.append(p)
            ph.append(Shard(p.dim if p.dim == 0 else p.dim - 1))
    none = [None] * mesh.ndim
    h = _LinearRecurrence.apply(_local(a, mesh, pa, none), _local(b, mesh, pa, none),
                                _local(h0, mesh, ph, none))
    return _from_local(h, mesh, [Replicate() if mesh.size(i) == 1 else p
                                 for i, p in enumerate(pa)], tuple(a.shape))


def _sharded_selective_scan(delta, x, Bp, Cp, A, h0, scan_dt):
    """:func:`selective_scan` on DTensors, each rank on its shards: the
    batch split (every operand but ``A`` on its rows) and the channel split
    (delta and x on their last dim, ``A`` and ``h0`` on their channels) are
    kept, with ``Bp`` and ``Cp`` whole on a channel split, where their
    gradients are partial sums over the channels, as ``A``'s is over the
    rows on a batch split; a split of T is gathered (the recurrence runs
    along all of it)."""
    mesh = delta.device_mesh
    x, Bp, Cp, A, h0 = (meshctx.as_dtensor(t, mesh) for t in (x, Bp, Cp, A, h0))
    rep = Replicate()
    pd, pb, pa, ph, gb, ga = [], [], [], [], [], []
    for i, p in enumerate(delta.placements):
        if mesh.size(i) == 1:
            pd.append(rep), pb.append(rep), pa.append(rep), ph.append(rep)
            gb.append(None), ga.append(None)
        elif isinstance(p, Shard) and p.dim == 0:  # the batch
            pd.append(p), pb.append(p), pa.append(rep), ph.append(Shard(0))
            gb.append(None), ga.append(Partial())
        elif isinstance(p, Shard) and p.dim == 2:  # the channels
            pd.append(p), pb.append(rep), pa.append(Shard(0)), ph.append(Shard(1))
            gb.append(Partial()), ga.append(None)
        else:
            pd.append(rep), pb.append(rep), pa.append(rep), ph.append(rep)
            gb.append(None), ga.append(None)
    none = [None] * mesh.ndim
    y, hT = selective_scan(*(_local(t, mesh, pl, g).contiguous() for t, pl, g in
                             ((delta, pd, none), (x, pd, none), (Bp, pb, gb), (Cp, pb, gb),
                              (A, pa, ga), (h0, ph, none))),
                           scan_dt)
    return (_from_local(y, mesh, pd, tuple(delta.shape)),
            _from_local(hT, mesh, ph, tuple(h0.shape)))


def mamba_dims(cfg: ModelConfig):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, m.d_state, m.d_conv


def build_mamba(b: Builder, prefix: str, cfg: ModelConfig, n_blocks: int):
    """Mamba's parameters. ``dt_proj`` keeps the JAX package's zero bias
    leaf ``dt_proj_b``, which :func:`mamba_mix` does not read (it adds
    ``dt_bias``), so parameter trees and checkpoints match key for key."""
    d = cfg.d_model
    d_inner, dt_rank, d_state, d_conv = mamba_dims(cfg)
    bs, ba = (n_blocks,), ("layers",)
    b.linear(f"{prefix}/in_x", d, d_inner, li="embed", lo="mamba_inner",
             batch_shape=bs, batch_axes=ba)
    b.linear(f"{prefix}/in_z", d, d_inner, li="embed", lo="mamba_inner",
             batch_shape=bs, batch_axes=ba)
    b.linear(f"{prefix}/x_proj", d_inner, dt_rank + 2 * d_state,
             li="mamba_inner", lo=None, batch_shape=bs, batch_axes=ba)
    b.linear(f"{prefix}/dt_proj", dt_rank, d_inner, li=None, lo="mamba_inner",
             batch_shape=bs, batch_axes=ba, bias=True)
    b.linear(f"{prefix}/out", d_inner, d, li="mamba_inner", lo="embed",
             batch_shape=bs, batch_axes=ba)
    b.normal(f"{prefix}/conv_w", bs + (d_conv, d_inner),
             axes=ba + (None, "mamba_inner"), scale=0.5 / d_conv)
    # f32 whatever the parameter dtype, as in the JAX package
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32, device=b.device))
    b._put(f"{prefix}/A_log", a_log.expand(bs + (d_inner, d_state)).contiguous(),
           sharding.spec(*ba, "mamba_inner", None))
    b.vector(f"{prefix}/D", bs + (d_inner,), axes=ba + ("mamba_inner",), init=1.0)
    b.vector(f"{prefix}/dt_bias", bs + (d_inner,), axes=ba + ("mamba_inner",),
             init=-4.6)  # softplus⁻¹(0.01)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: Optional[torch.Tensor]):
    """Depthwise causal conv along T. x: (B, T, C), w: (K, C). ``tail`` is
    the last K-1 inputs of the previous call (the decode state). Returns
    (y, new tail)."""
    K, T = w.shape[0], x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)  # (B, T+K-1, C)
    y = xp[:, 0:T] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T] * w[i]
    return y, xp[:, -(K - 1):]


def mamba_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              state: Optional[dict] = None) -> Tuple[torch.Tensor, Optional[dict]]:
    """Selective-SSM mixer. x: (B, T, d). ``state`` (decode, and the
    serving prefill): {"h": (B, d_inner, N) f32, "conv": (B, K-1, d_inner)}.

    ``F.softplus`` returns its input above 20, where ``jax.nn.softplus``
    computes ``log1p(exp(x))``: the two agree to f32 rounding there.
    The recurrence is one :func:`selective_scan` call, from ``state["h"]``
    or, without a state (training), from a zero f32 state, token by token
    as the reference's state branch, at every T. The port's scan forms no
    (B, chunk, d_inner, N) workspace, so ``cfg.mamba.scan_chunk`` (the
    reference's training chunk, which the spec hash reads) changes nothing
    here.
    """
    d_inner, dt_rank, d_state, _ = mamba_dims(cfg)
    dt = x.dtype
    kernels = cfg.kernels

    xz = apply_linear(p["in_x"], x, kernels=kernels)
    z = apply_linear(p["in_z"], x, kernels=kernels)
    xz = sharding.shard(xz, "batch", None, "mamba_inner")
    tail = state["conv"] if state is not None else None
    xc, new_tail = _causal_conv(xz, p["conv_w"].to(dt), tail)
    xc = F.silu(xc)

    proj = apply_linear(p["x_proj"], xc, kernels=kernels).float()
    dt_low, Bp, Cp = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    delta = F.softplus(apply_linear(p["dt_proj"], dt_low.to(dt), bias=p["dt_bias"],
                                    kernels=kernels).float())  # (B, T, d_inner)
    # channel-sharded (unpinned it would be replicated, in f32)
    delta = sharding.shard(delta, "batch", None, "mamba_inner")
    A = -torch.exp(p["A_log"].float())  # (d_inner, N)

    xc32 = xc.float()
    scan_dt = dt  # the compute dtype: bf16 at full width, f32 reduced
    B = xc.shape[0]

    # the reference's sequential order from the given state (or zeros), at
    # any T: one selective-scan call (the decode step's T = 1 included)
    h0 = (state["h"].float() if state is not None else
          torch.zeros((B, d_inner, d_state), dtype=torch.float32, device=x.device))
    scan = _sharded_selective_scan if isinstance(delta, DTensor) else selective_scan
    y, h = scan(delta, xc32, Bp.contiguous(), Cp.contiguous(), A.contiguous(), h0, scan_dt)
    new_state = {"h": h, "conv": new_tail} if state is not None else None

    y = y + p["D"].float() * xc32
    y = y.to(dt) * F.silu(z)
    return apply_linear(p["out"], y, kernels=kernels), new_state


def mamba_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_inner, _, d_state, d_conv = mamba_dims(cfg)
    return {
        "h": torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
    }


# ===========================================================================
# RWKV6 (Finch): data-dependent decay linear attention
# ===========================================================================


def rwkv_dims(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def build_rwkv(b: Builder, prefix: str, cfg: ModelConfig, n_blocks: int):
    d = cfg.d_model
    H, hd = rwkv_dims(cfg)
    lora = cfg.rwkv.decay_lora
    bs, ba = (n_blocks,), ("layers",)
    for name in ("r", "k", "v", "g"):
        b.linear(f"{prefix}/{name}", d, d, li="embed", lo="rwkv_heads",
                 batch_shape=bs, batch_axes=ba)
    b.linear(f"{prefix}/out", d, d, li="rwkv_heads", lo="embed",
             batch_shape=bs, batch_axes=ba)
    # the data-dependent decay LoRA (Finch's mechanism), dense
    b.normal(f"{prefix}/w_lora_a", bs + (d, lora), axes=ba + (None, None), scale=0.02)
    b.normal(f"{prefix}/w_lora_b", bs + (lora, d), axes=ba + (None, "rwkv_heads"), scale=0.02)
    b.vector(f"{prefix}/w0", bs + (d,), axes=ba + ("rwkv_heads",), init=-1.0)
    b.vector(f"{prefix}/u", bs + (H, hd), axes=ba + ("rwkv_heads", None), init=0.5)
    # static token-shift mixing coefficients (the JAX package's
    # simplification of ddlerp)
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        b.vector(f"{prefix}/{name}", bs + (d,), axes=ba + (None,), init=0.5)
    b.vector(f"{prefix}/ln_x", bs + (d,), axes=ba + ("rwkv_heads",), init=1.0)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """Shift right by one along T; ``prev`` is the previous segment's last
    token (the decode state). Returns (shifted, this segment's last)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1), x[:, -1:]


#: bound on the chunk's log-decay exponents: ``k / W_{≤i}`` reaches e^30
CLAMP = 30.0


def _rwkv_chunked(r, k, v, logw, u, S0, chunk: int):
    """Chunked wkv. r, k, v: (B, T, H, hd); logw ≤ 0: (B, T, H, hd); u:
    (H, hd); S0: (B, H, hd, hd). Per head:

        S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
        o_t = r_t S_{t-1} + (r_t ⊙ u)·k_t v_t

    Returns (o: (B, T, H, hd), S_T). Run it in f32: the rescaled keys reach
    e^30."""
    B, T, H, hd = r.shape
    L = min(chunk, T)
    n = -(-T // L)
    pad = n * L - T
    if pad:
        zp = lambda a: torch.cat([a, a.new_zeros((B, pad, H, hd))], dim=1)  # noqa: E731
        r, k, v, logw = zp(r), zp(k), zp(v), zp(logw)
    shp = (B, n, L, H, hd)
    rc, kc, vc, lwc = r.reshape(shp), k.reshape(shp), v.reshape(shp), logw.reshape(shp)

    # within-chunk inclusive log-decay prefix P_t = Σ_{m≤t} logw_m
    lp = torch.cumsum(lwc, dim=2)
    lp_prev = lp - lwc  # exclusive: Σ_{m<t}
    r_t = rc * torch.exp(torch.clamp(lp_prev, min=-CLAMP))  # r_t ⊙ W_{<t}
    k_t = kc * torch.exp(torch.clamp(-lp, max=CLAMP))  # k_i / W_{≤i}

    # intra-chunk, strictly lower triangular (B, n, H, L, L)
    att = torch.einsum("bnlhd,bnmhd->bnhlm", r_t, k_t)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    att = att * tri
    bonus = torch.einsum("bnlhd,hd,bnlhd->bnlh", rc, u, kc)  # the diagonal's bonus term
    intra = torch.einsum("bnhlm,bnmhd->bnlhd", att, vc) + bonus[..., None] * vc

    # across chunks: a loop over the chunk states
    k_for_state = kc * torch.exp(torch.clamp(lp[:, :, -1:] - lp, max=CLAMP))  # k_i ⊙ W_{i+1..L}
    dS = torch.einsum("bnlhd,bnlhe->bnhde", k_for_state, vc)  # (B, n, H, hd, hd)
    wtot = torch.exp(torch.clamp(lp[:, :, -1], min=-CLAMP))  # (B, n, H, hd)
    S, inters = S0, []
    for c in range(n):
        inters.append(torch.einsum("blhd,bhde->blhe", r_t[:, c], S))
        S = S * wtot[:, c, ..., None] + dS[:, c]
    inter = torch.stack(inters, dim=1)  # (B, n, L, H, hd)
    o = (intra + inter).reshape(B, n * L, H, hd)
    return o[:, :T], S


def _rwkv_stepped(r, k, v, logw, u, S0):
    """The wkv token by token, the recurrence :func:`_rwkv_chunked` states,
    in the inputs' dtype: no rescaled keys and no clamp. No model path
    calls it; the checks hold the chunked form to it, run in f64."""
    w = torch.exp(logw)
    S, outs = S0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # k_tᵀ v_t: (B, H, hd, hd)
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, t], S)
                    + torch.einsum("bhd,bhde->bhe", r[:, t] * u, kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1), S


def _sharded_wkv(r, k, v, logw, u, S0, chunk: int):
    """:func:`_rwkv_chunked` on DTensors, each rank on its shards: the
    recurrence runs over all of T, so a sequence split is gathered; a batch
    split and a split of the heads are kept (r, k, v, logw on their batch
    and head dims, u on its heads, the state on its batch and heads); an
    operand whole on an axis that splits the others takes a partial
    gradient there."""
    mesh = r.device_mesh
    u, S0 = meshctx.as_dtensor(u, mesh), meshctx.as_dtensor(S0, mesh)
    H = r.shape[2]
    rep = Replicate()
    p4, pu, ps, g4, gu, gs, po = [], [], [], [], [], [], []
    for i in range(mesh.ndim):
        a = r.placements[i]
        if mesh.size(i) == 1:
            p4.append(a), pu.append(u.placements[i]), ps.append(S0.placements[i])
            g4.append(None), gu.append(None), gs.append(None), po.append(rep)
        elif isinstance(a, Shard) and a.dim == 0:
            p4.append(Shard(0)), pu.append(rep), ps.append(Shard(0)), po.append(Shard(0))
            g4.append(None), gu.append(Partial()), gs.append(None)
        elif H % mesh.size(i) == 0 and (isinstance(a, Shard) and a.dim == 2
                                       or isinstance(S0.placements[i], Shard)):
            p4.append(Shard(2)), pu.append(Shard(0)), ps.append(Shard(1)), po.append(Shard(2))
            g4.append(None), gu.append(None), gs.append(None)
        else:
            p4.append(rep), pu.append(rep), ps.append(rep), po.append(rep)
            g4.append(None), gu.append(None), gs.append(None)
    loc = [_local(t, mesh, p4, g4) for t in (r, k, v, logw)]
    o, S_T = _rwkv_chunked(*loc, _local(u, mesh, pu, gu), _local(S0, mesh, ps, gs), chunk)
    pS = [Shard(1) if isinstance(q, Shard) and q.dim == 2 else q for q in po]
    return (_from_local(o, mesh, po, tuple(r.shape)),
            _from_local(S_T, mesh, pS, tuple(S0.shape)))


def rwkv_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
             state: Optional[dict] = None) -> Tuple[torch.Tensor, Optional[dict]]:
    """RWKV6 time mixing. x: (B, T, d); ``state``: {"S": (B, H, hd, hd)
    f32, "shift": (B, 1, d)}. Decode runs the same chunked wkv at T = 1.
    ``ln_x`` is an RMS norm over all of d, as in the JAX package (not a
    per-head group norm)."""
    B, T, d = x.shape
    H, hd = rwkv_dims(cfg)
    dt = x.dtype
    kernels = cfg.kernels

    xx, last = _token_shift(x, state["shift"] if state is not None else None)

    def mix(mu):
        return x + (xx - x) * mu.to(dt)

    r = apply_linear(p["r"], mix(p["mu_r"]), kernels=kernels).reshape(B, T, H, hd)
    k = apply_linear(p["k"], mix(p["mu_k"]), kernels=kernels).reshape(B, T, H, hd)
    v = apply_linear(p["v"], mix(p["mu_v"]), kernels=kernels).reshape(B, T, H, hd)
    g = apply_linear(p["g"], mix(p["mu_g"]), kernels=kernels)

    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(x A) B))
    xw = mix(p["mu_w"]).float()

    def decay_lora(x_, a_, b_):
        return torch.tanh(x_ @ a_) @ b_

    lora = (p["w_lora_a"].float(), p["w_lora_b"].float())
    if isinstance(xw, DTensor):  # rows split over two axes: on the local rows
        dd = rowwise_local(decay_lora, xw, *lora)
    else:
        dd = decay_lora(xw, *lora)
    logw = -torch.exp(torch.clamp(p["w0"].float() + dd, -8.0, 4.0)).reshape(B, T, H, hd)

    S0 = (state["S"].float() if state is not None
          else torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device))
    wkv = _sharded_wkv if isinstance(r, DTensor) else _rwkv_chunked
    o, S_T = wkv(r.float(), k.float(), v.float(), logw, p["u"].float(), S0, cfg.rwkv.chunk_len)
    o = rms_norm(o.reshape(B, T, d), p["ln_x"], cfg.norm_eps).to(dt)
    o = o * F.silu(g)
    out = apply_linear(p["out"], o, kernels=kernels)
    return out, ({"S": S_T, "shift": last} if state is not None else None)


def rwkv_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    H, hd = rwkv_dims(cfg)
    return {
        "S": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
    }
