"""Layer primitives: parameter builder, maybe-factorized linears, norms,
rotary and sinusoidal positions and attention — the JAX package's ``models/layers.py`` in
PyTorch.

Every weight matrix goes through :meth:`Builder.linear`, which decides from
the :class:`LowRankPolicy` whether the layer is a FeDLRT-managed
:class:`LowRankFactor` or a plain dense tensor. :func:`apply_linear`
dispatches on the leaf type. The numerics follow the JAX functions line by
line (the casts are noted where they matter), so the port's logits agree
with the JAX package's on the same parameters.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.factorization import init_factor, is_factor
from repro_torch.kernels.coeff_grad import atb
from repro_torch.kernels.ops import _from_local, _local, lowrank_apply_nd, use_kernels_for
from repro_torch.kernels.ref import atb_ref
from repro_torch.models import sharding
from repro_torch.models.config import LowRankPolicy
from repro_torch.utils import meshctx


# ---------------------------------------------------------------------------
# parameter builder
# ---------------------------------------------------------------------------


class Builder:
    """Collects (params, specs) as parallel nested dicts keyed by '/'-paths,
    drawing every random value from one generator (on the generator's
    device). A spec is the :mod:`~repro_torch.models.sharding` spec of the
    leaf's logical axes, resolved against the mesh enabled at build time
    (all ``None`` without one)."""

    def __init__(self, gen: torch.Generator, policy: LowRankPolicy, dtype=torch.float32):
        self.policy = policy
        self.dtype = dtype
        self.gen = gen
        self.device = gen.device
        self.params: dict = {}
        self.specs: dict = {}

    def _put(self, path: str, value, spec_leaf):
        parts = path.split("/")
        p, s = self.params, self.specs
        for part in parts[:-1]:
            p = p.setdefault(part, {})
            s = s.setdefault(part, {})
        if parts[-1] in p:
            raise ValueError(f"duplicate param {path}")
        p[parts[-1]] = value
        s[parts[-1]] = spec_leaf

    def linear(
        self,
        path: str,
        n_in: int,
        n_out: int,
        *,
        li: Optional[str] = None,
        lo: Optional[str] = None,
        batch_shape: Tuple[int, ...] = (),
        batch_axes: Tuple[Optional[str], ...] = (),
        bias: bool = False,
        force_dense: bool = False,
        init_scale: Optional[float] = None,
    ):
        """A (possibly factorized) ``n_in → n_out`` weight at ``path``, its
        dims named ``li`` / ``lo``; ``batch_shape`` / ``batch_axes`` add
        leading stacking dims (the layer stack, the experts). A dense weight
        is drawn with standard deviation ``init_scale``, He's
        ``sqrt(2 / n_in)`` by default."""
        if len(batch_shape) != len(batch_axes):
            raise ValueError(f"{path}: batch_shape {batch_shape} vs batch_axes {batch_axes}")
        if self.policy.applies(n_in, n_out) and not force_dense:
            r_max = self.policy.r_max_for(n_in, n_out)
            init_rank = max(int(self.policy.init_rank_frac * r_max), 1)
            f = init_factor(
                self.gen, n_in, n_out, r_max, init_rank=init_rank,
                dtype=self.dtype, batch_shape=batch_shape,
            )
            self._put(path, f, sharding.factor_spec(batch_axes, li, lo))
        else:
            scale = init_scale if init_scale is not None else (2.0 / n_in) ** 0.5
            w = scale * torch.randn(
                tuple(batch_shape) + (n_in, n_out), generator=self.gen,
                device=self.device, dtype=torch.float32,
            )
            # a dense weight uses each mesh axis once: when both logical
            # dims resolve to the same axis (embed and ffn → model), the
            # output dim keeps it (the Megatron convention)
            if sharding._resolve(li) is not None and sharding._resolve(li) == sharding._resolve(lo):
                li = None
            self._put(path, w.to(self.dtype), sharding.spec(*batch_axes, li, lo))
        if bias:
            self._put(
                path + "_b",
                torch.zeros(tuple(batch_shape) + (n_out,), dtype=self.dtype, device=self.device),
                sharding.spec(*batch_axes, lo),
            )

    def vector(self, path: str, shape, *, axes=(), init: float = 1.0):
        self._put(path, torch.full(tuple(shape), init, dtype=self.dtype, device=self.device),
                  sharding.spec(*axes))

    def normal(self, path: str, shape, *, axes=(), scale: float = 0.02):
        """A dense tensor drawn with standard deviation ``scale`` (the
        Mamba conv taps, the RWKV decay LoRA)."""
        w = scale * torch.randn(tuple(shape), generator=self.gen, device=self.device,
                                dtype=torch.float32)
        self._put(path, w.to(self.dtype), sharding.spec(*axes))

    def build(self):
        return self.params, self.specs


# ---------------------------------------------------------------------------
# apply helpers
# ---------------------------------------------------------------------------


def apply_linear(w, x, *, bias=None, dtype=None, kernels: str = "off") -> torch.Tensor:
    """``y = x @ W (+ b)`` dispatching on dense vs LowRankFactor leaves.

    ``kernels`` (``ModelConfig.kernels``) routes factor leaves through the
    ``xus``/``avt`` kernel chain; ``"off"`` is the plain chain
    ``((x U) S) Vᵀ`` in the working dtype, which never materializes the
    ``n_in × n_out`` matrix either.
    """
    dtype = dtype or x.dtype
    if is_factor(w):
        if kernels != "off":
            y = lowrank_apply_nd(
                x, w.U.to(dtype), w.S.to(dtype), w.V.to(dtype),
                use_kernels_for(kernels),
            )
        else:
            y = torch.matmul(
                torch.matmul(x, w.U.to(dtype)), w.S.to(dtype)
            ) @ w.V.to(dtype).transpose(-1, -2)
    else:
        y = torch.matmul(x, w.to(dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


class _RowGather(torch.autograd.Function):
    """``table[idx]`` with a backward that is the same bits on every run.

    The backward of a plain ``table[idx]`` scatters the rows' cotangents
    into the table with ``index_put_(accumulate=True)``, whose order of
    additions PyTorch does not fix on every device. Here it is the product
    ``onehot(idx)ᵀ · g`` over the whole table, on the ``atb`` kernel
    (``use_kernels``: an f32 sum over the rows in a fixed order, no
    atomics) or its plain version.
    """

    @staticmethod
    def forward(ctx, table, idx, use_kernels):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.use_kernels = table.shape[0], use_kernels
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g2 = g.reshape(flat.numel(), -1).contiguous()
        onehot = (flat[:, None] == torch.arange(ctx.rows, device=flat.device)).to(g.dtype)
        return (atb if ctx.use_kernels else atb_ref)(onehot, g2), None, None


def _gather_rows(table, tokens, use_kernels: bool):
    if isinstance(table, DTensor):
        return _sharded_gather_rows(table, tokens, use_kernels)
    if table.requires_grad:
        return _RowGather.apply(table, tokens, use_kernels)
    return table[tokens]


class _SliceGather(torch.autograd.Function):
    """``table[idx]`` for the rows ``[v0, v0 + len(table))`` of a table split
    by rows; 0 for the other tokens. Its backward is :class:`_RowGather`'s
    over the slice: ``onehot(idx - v0)ᵀ · g`` on ``atb`` (or its plain
    version), the (tokens × slice) one-hot instead of (tokens × table)."""

    @staticmethod
    def forward(ctx, table, idx, v0, use_kernels):
        at = idx - v0
        mine = (at >= 0) & (at < table.shape[0])
        at = torch.where(mine, at, torch.zeros_like(at))
        ctx.save_for_backward(at, mine)
        ctx.rows, ctx.use_kernels = table.shape[0], use_kernels
        return torch.where(mine[..., None], table[at], torch.zeros((), dtype=table.dtype,
                                                                  device=table.device))

    @staticmethod
    def backward(ctx, g):
        at, mine = ctx.saved_tensors
        flat, keep = at.reshape(-1), mine.reshape(-1)
        g2 = g.reshape(flat.numel(), -1).contiguous()
        onehot = ((flat[:, None] == torch.arange(ctx.rows, device=flat.device))
                  & keep[:, None]).to(g.dtype)
        return (atb if ctx.use_kernels else atb_ref)(onehot, g2), None, None, None


def _sharded_gather_rows(table, tokens, use_kernels: bool):
    """``table[tokens]`` on the local shards. Per mesh axis of size > 1: a
    table split by columns gathers its columns for every token; tokens
    split over the axis (the batch) gather their rows of the whole table
    (its local gradient then a partial sum); where both are whole, the
    rows of the table split over the axis (vocabulary parallel): each rank
    gathers the tokens in its slice, the rows are summed over the axis, and
    its gradient is its slice's, a one-hot over the slice rather than over
    the whole table."""
    mesh = table.device_mesh
    tokens = meshctx.as_dtensor(tokens, mesh)
    V = table.shape[0]
    pt, pk, py, gt, vocab = [], [], [], [], []
    for i in range(mesh.ndim):
        a, k = table.placements[i], tokens.placements[i]
        if mesh.size(i) == 1:
            pt.append(a), pk.append(k), py.append(Replicate()), gt.append(None)
        elif isinstance(a, Shard) and a.dim == table.dim() - 1:
            pt.append(a), pk.append(Replicate()), py.append(Shard(tokens.dim())), gt.append(None)
        elif isinstance(k, Shard):
            pt.append(Replicate()), pk.append(k), py.append(k), gt.append(Partial())
        elif V % mesh.size(i) == 0:
            pt.append(Shard(0)), pk.append(Replicate()), py.append(Partial()), gt.append(None)
            vocab.append(i)
        else:
            pt.append(Replicate()), pk.append(Replicate()), py.append(Replicate()), gt.append(None)
    tl = _local(table, mesh, pt, gt)
    kl = _local(tokens, mesh, pk, [None] * mesh.ndim)
    shape = tuple(tokens.shape) + (table.shape[-1],)
    if not vocab:
        return _from_local(_gather_rows(tl, kl, use_kernels), mesh, py, shape)
    v0 = 0
    for i in vocab:
        v0 = v0 * mesh.size(i) + mesh.get_local_rank(i)
    rows = _SliceGather.apply(tl, kl, v0 * tl.shape[0], use_kernels)
    out = _from_local(rows, mesh, py, shape)
    return out.redistribute(mesh, [Replicate() if i in vocab else p for i, p in enumerate(py)])


def apply_embedding(w, tokens, *, dtype=torch.float32, kernels: str = "off") -> torch.Tensor:
    """Token embedding lookup (gather of the factor's U rows).

    Kernel path: the gathered rows ``u = U[tokens]`` play the activation
    of the chain with the coefficient as its projection, ``((u S) I) Vᵀ``,
    so the embedding launches one ``xus`` and one ``avt``, as the JAX
    package's kernel path does, and its trainable S takes its gradient
    through the chain's ``dU`` term. The gather itself has a deterministic
    backward (:class:`_RowGather`) when U is being differentiated.
    """
    use_kernels = kernels != "off" and use_kernels_for(kernels)
    if is_factor(w):
        u = _gather_rows(w.U, tokens, use_kernels).to(dtype)  # (..., r)
        if kernels != "off":
            eye = torch.eye(w.S.shape[-1], dtype=dtype, device=u.device)
            return lowrank_apply_nd(
                u, w.S.to(dtype), eye, w.V.to(dtype), use_kernels_for(kernels)
            )
        return torch.matmul(u, w.S.to(dtype)) @ w.V.to(dtype).transpose(-1, -2)
    return _gather_rows(w, tokens, use_kernels).to(dtype)


def rms_norm(x, scale, eps: float) -> torch.Tensor:
    """Normalise in f32, cast to ``x.dtype``, then scale in ``x.dtype``."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# position embeddings: rotary, sinusoidal
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x, positions, theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions broadcastable to (..., T). Computed in
    f32, halves concatenated (not interleaved), cast back to ``x.dtype``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., T, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(T: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(T, d) sine / cosine position table (even columns sine, odd cosine),
    built in f32 and cast to ``dtype``."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    rate = -torch.log(torch.tensor(10000.0, dtype=torch.float32, device=device)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * rate)
    pe = torch.zeros((T, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional sliding window, blockwise over query chunks)
# ---------------------------------------------------------------------------


def _mask(q_positions, kv_positions, causal: bool, sliding_window: int):
    """(1, 1, Tq, Tk) or per-slot (B, 1, Tq, Tk): a kv position that is
    valid, not after the query's (causal), within the window."""
    m = (kv_positions[..., None, :] >= 0) & (q_positions[..., :, None] >= 0)
    if causal:
        m = m & (kv_positions[..., None, :] <= q_positions[..., :, None])
    if sliding_window:
        m = m & (kv_positions[..., None, :] > q_positions[..., :, None] - sliding_window)
    return m[:, None] if m.dim() == 3 else m[None, None]


def _attention_block(q, k, v, q_positions, kv_positions, causal: bool, sliding_window: int,
                     hd: int = 0, reduce_scores=None, split_keys=None):
    """One block of queries. ``hd`` is the head dim the scores are scaled
    by (q's own unless the head dim is split over a mesh axis);
    ``reduce_scores`` then sums the partial scores over it. ``split_keys``
    (keys split over ranks): a pair of reductions across them, of the
    softmax's statistics ``(t, "max" | "sum")`` and of the output, so that
    the softmax is taken over all the keys."""
    B, Tq, H, hd_l = q.shape
    hd = hd or hd_l
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Tq, Hkv, g, hd_l)
    # 1/sqrt(hd) in q.dtype: the divisor is rounded to q.dtype first, as in
    # the JAX package (a host scalar, so a CUDA graph can capture the step)
    scale = float(torch.tensor(math.sqrt(hd), dtype=q.dtype))
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k)
    if reduce_scores is not None:
        s = reduce_scores(s)
    s = s / scale
    s = s.reshape(B, H, Tq, k.shape[1]).float()
    s = torch.where(_mask(q_positions, kv_positions, causal, sliding_window), s, -1e30)
    if split_keys is None:
        p = torch.softmax(s, dim=-1).to(v.dtype)
    else:
        stats, out = split_keys
        e = torch.exp(s - stats(s.amax(-1, keepdim=True), "max"))
        den = stats(e.sum(-1, keepdim=True), "sum")  # (B, H, Tq, 1)
        p = e.to(v.dtype)
    pg = p.reshape(B, Hkv, g, Tq, k.shape[1])
    o = torch.einsum("bkgqt,btkd->bqkgd", pg, v).reshape(B, Tq, H, v.shape[-1])
    if split_keys is None:
        return o
    return (out(o.float()) / den.permute(0, 2, 1, 3)).to(v.dtype)


def attention(
    q, k, v, *, q_positions, kv_positions, causal: bool = True, sliding_window: int = 0,
    q_chunk: int = 0,
) -> torch.Tensor:
    """Masked dot-product attention over absolute positions, blockwise over
    query chunks.

    q: (B, Tq, H, hd); k, v: (B, Tk, Hkv, hd). Query head ``h`` reads KV head
    ``h // (H / Hkv)``. Positions are (Tq,) / (Tk,) or per-slot (B, Tq) /
    (B, Tk); a negative kv position marks a never-written cache slot. The
    scores are scaled by ``1/sqrt(hd)`` in ``q.dtype``, masked with
    ``-1e30`` in f32, and the softmax is cast to ``v.dtype``.

    ``q_chunk`` > 0 evaluates the queries ``q_chunk`` at a time, so the
    live f32 scores are (B, H, q_chunk, Tk) rather than (B, H, Tq, Tk):
    the last chunk is padded with query position -1, which the mask
    rejects, and the output is cut back to ``Tq``. Per-slot positions take
    one block (their decode is Tq = 1). Under a mesh whose "model" axis
    already splits the queries, so that a shard holds at most ``q_chunk``
    rows, the queries take one block too: chunking below the shard's size
    would gather q at every chunk.
    """
    Tq = q.shape[1]
    q_chunk = min(q_chunk or Tq, Tq)
    if meshctx.mesh() is not None and "model" in meshctx.axis_names():
        local_rows = Tq // meshctx.axis_size("model")
        if 0 < local_rows <= q_chunk:
            q_chunk = Tq
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, q_positions, kv_positions, causal, sliding_window,
                                  q_chunk)
    return _chunked_attention(q, k, v, q_positions, kv_positions, causal, sliding_window,
                              q_chunk)


def _chunked_attention(q, k, v, q_positions, kv_positions, causal, sliding_window, q_chunk,
                       **block):
    Tq = q.shape[1]
    q_chunk = min(q_chunk or Tq, Tq)
    if q_positions.dim() > 1 or kv_positions.dim() > 1 or q_chunk == Tq:
        return _attention_block(q, k, v, q_positions, kv_positions, causal, sliding_window,
                                **block)
    n_chunks = -(-Tq // q_chunk)
    pad = n_chunks * q_chunk - Tq
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    pp = torch.nn.functional.pad(q_positions, (0, pad), value=-1)
    outs = [
        _attention_block(qp[:, c * q_chunk:(c + 1) * q_chunk], k, v,
                         pp[c * q_chunk:(c + 1) * q_chunk], kv_positions, causal, sliding_window,
                         **block)
        for c in range(n_chunks)
    ]
    return torch.cat(outs, dim=1)[:, :Tq]


def _sharded_attention(q, k, v, q_positions, kv_positions, causal, sliding_window, q_chunk):
    """:func:`attention` on DTensors, each rank on its shards. Per mesh axis
    of size > 1: a batch split is kept (q, k, v and the positions on the
    same rows); the queries split over the sequence attend to keys and
    values gathered whole (context parallelism; their local gradient is
    then a partial sum); a cache split over its KV heads splits q's heads
    alike; a cache split over its head dim splits q's, sums the partial
    scores over the axis and returns the output split on the head dim; any
    other axis runs the whole attention on every rank; a cache split on its
    sequence (a batch smaller than the data axes, at decode) keeps its keys
    where they are, and the softmax's max and sum and the output are
    reduced across the ranks. The query sequence split comes first: a
    prefill writing into a cache split on its head dim gathers the keys
    rather than summing (B, H, T, S) partial scores."""
    mesh = q.device_mesh
    k, v = meshctx.as_dtensor(k, mesh), meshctx.as_dtensor(v, mesh)
    qpos, kvpos = meshctx.as_dtensor(q_positions, mesh), meshctx.as_dtensor(kv_positions, mesh)
    rep = Replicate()
    pq, pk, pqp, pkp, gkv, hd_dims, key_dims = [], [], [], [], [], [], []
    for i in range(mesh.ndim):
        a, b = q.placements[i], k.placements[i]
        if mesh.size(i) == 1:
            pq.append(a), pk.append(b), pqp.append(qpos.placements[i])
            pkp.append(kvpos.placements[i]), gkv.append(None)
        elif isinstance(a, Shard) and a.dim == 1:
            pq.append(a), pk.append(rep), gkv.append(Partial())
            pqp.append(Shard(qpos.dim() - 1)), pkp.append(rep)
        elif isinstance(b, Shard) and b.dim == 1:
            # a cache split on its sequence (a batch smaller than the data
            # axes): each rank attends to its keys, the softmax spans them all
            pq.append(rep), pk.append(b), pqp.append(rep), pkp.append(Shard(kvpos.dim() - 1))
            gkv.append(None)
            key_dims.append(i)
        elif (isinstance(a, Shard) and a.dim == 0) or (isinstance(b, Shard) and b.dim == 0):
            pq.append(Shard(0)), pk.append(Shard(0)), gkv.append(None)
            pqp.append(Shard(0) if qpos.dim() > 1 else rep)
            pkp.append(Shard(0) if kvpos.dim() > 1 else rep)
        elif isinstance(b, Shard) and b.dim == 3:
            pq.append(Shard(3)), pk.append(Shard(3)), pqp.append(rep), pkp.append(rep)
            gkv.append(None)
            hd_dims.append(i)
        elif k.shape[2] % mesh.size(i) == 0 and (
                (isinstance(a, Shard) and a.dim == 2) or (isinstance(b, Shard) and b.dim == 2)):
            pq.append(Shard(2)), pk.append(Shard(2)), pqp.append(rep), pkp.append(rep)
            gkv.append(None)
        else:
            pq.append(rep), pk.append(rep), pqp.append(rep), pkp.append(rep), gkv.append(None)
    none = [None] * mesh.ndim
    ql = _local(q, mesh, pq, none)
    kl = _local(k, mesh, pk, gkv)
    vl = _local(v, mesh, pk, gkv)
    qp = _local(qpos, mesh, pqp, none)
    kp = _local(kvpos, mesh, pkp, none)
    block = {}
    if hd_dims:
        summed = [Partial() if i in hd_dims else (p if not isinstance(p, Shard) or p.dim == 0
                                                  else rep) for i, p in enumerate(pq)]

        def reduce_scores(s):
            shape = (s.shape[0] * (q.shape[0] // ql.shape[0]),) + tuple(s.shape[1:])
            full = _from_local(s, mesh, summed, shape)
            want = [rep if i in hd_dims else p for i, p in enumerate(summed)]
            return _local(full, mesh, want, [None] * mesh.ndim)

        block = dict(hd=q.shape[-1], reduce_scores=reduce_scores)
    if key_dims:
        # q's splits, as the softmax's statistics (B, H, Tq, 1) and the
        # output (B, Tq, H, hd) carry them; the key axes' partial values
        stat_dim = {0: 0, 1: 2, 2: 1}
        B, Tq, H, hd = q.shape

        def across(t, op, stats):
            pl = []
            for i, p in enumerate(pq):
                if i in key_dims:
                    pl.append(Partial(op))
                elif not isinstance(p, Shard) or mesh.size(i) == 1:
                    pl.append(rep)
                elif stats:
                    pl.append(Shard(stat_dim[p.dim]) if p.dim in stat_dim else rep)
                else:
                    pl.append(p)
            shape = (B, H, Tq, 1) if stats else (B, Tq, H, hd)
            want = [rep if i in key_dims else p for i, p in enumerate(pl)]
            return _local(_from_local(t, mesh, pl, shape), mesh, want, [None] * mesh.ndim)

        block["split_keys"] = (lambda t, op: across(t, op, True),
                               lambda t: across(t, "sum", False))
    out = _chunked_attention(ql, kl, vl, qp, kp, causal, sliding_window, q_chunk, **block)
    py = [rep if mesh.size(i) == 1 else p for i, p in enumerate(pq)]
    return _from_local(out, mesh, py, tuple(q.shape[:3]) + (v.shape[-1],))
