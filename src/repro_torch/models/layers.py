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

from repro_torch.core.factorization import init_factor, is_factor
from repro_torch.kernels.coeff_grad import atb
from repro_torch.kernels.ops import lowrank_apply_nd, use_kernels_for
from repro_torch.kernels.ref import atb_ref
from repro_torch.models.config import LowRankPolicy


# ---------------------------------------------------------------------------
# parameter builder
# ---------------------------------------------------------------------------


class Builder:
    """Collects parameters as nested dicts keyed by '/'-paths, drawing
    every random value from one generator (on the generator's device)."""

    def __init__(self, gen: torch.Generator, policy: LowRankPolicy, dtype=torch.float32):
        self.policy = policy
        self.dtype = dtype
        self.gen = gen
        self.device = gen.device
        self.params: dict = {}

    def _put(self, path: str, value):
        parts = path.split("/")
        p = self.params
        for part in parts[:-1]:
            p = p.setdefault(part, {})
        if parts[-1] in p:
            raise ValueError(f"duplicate param {path}")
        p[parts[-1]] = value

    def linear(
        self,
        path: str,
        n_in: int,
        n_out: int,
        *,
        batch_shape: Tuple[int, ...] = (),
        bias: bool = False,
        force_dense: bool = False,
        init_scale: Optional[float] = None,
    ):
        """A (possibly factorized) ``n_in → n_out`` weight at ``path``;
        ``batch_shape`` adds leading stacking dims (the layer stack, the
        experts). A dense weight is drawn with standard deviation
        ``init_scale``, He's ``sqrt(2 / n_in)`` by default."""
        if self.policy.applies(n_in, n_out) and not force_dense:
            r_max = self.policy.r_max_for(n_in, n_out)
            init_rank = max(int(self.policy.init_rank_frac * r_max), 1)
            f = init_factor(
                self.gen, n_in, n_out, r_max, init_rank=init_rank,
                dtype=self.dtype, batch_shape=batch_shape,
            )
            self._put(path, f)
        else:
            scale = init_scale if init_scale is not None else (2.0 / n_in) ** 0.5
            w = scale * torch.randn(
                tuple(batch_shape) + (n_in, n_out), generator=self.gen,
                device=self.device, dtype=torch.float32,
            )
            self._put(path, w.to(self.dtype))
        if bias:
            self._put(
                path + "_b",
                torch.zeros(tuple(batch_shape) + (n_out,), dtype=self.dtype, device=self.device),
            )

    def vector(self, path: str, shape, *, init: float = 1.0):
        self._put(path, torch.full(tuple(shape), init, dtype=self.dtype, device=self.device))

    def normal(self, path: str, shape, *, scale: float = 0.02):
        """A dense tensor drawn with standard deviation ``scale`` (the
        Mamba conv taps, the RWKV decay LoRA)."""
        w = scale * torch.randn(tuple(shape), generator=self.gen, device=self.device,
                                dtype=torch.float32)
        self._put(path, w.to(self.dtype))

    def build(self) -> dict:
        return self.params


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
    if table.requires_grad:
        return _RowGather.apply(table, tokens, use_kernels)
    return table[tokens]


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


def _attention_block(q, k, v, q_positions, kv_positions, causal: bool, sliding_window: int):
    B, Tq, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Tq, Hkv, g, hd)
    # 1/sqrt(hd) in q.dtype: the divisor is rounded to q.dtype first, as in
    # the JAX package (a host scalar, so a CUDA graph can capture the step)
    scale = float(torch.tensor(math.sqrt(hd), dtype=q.dtype))
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k) / scale
    s = s.reshape(B, H, Tq, k.shape[1]).float()

    m = (kv_positions[..., None, :] >= 0) & (q_positions[..., :, None] >= 0)
    if causal:
        m = m & (kv_positions[..., None, :] <= q_positions[..., :, None])
    if sliding_window:
        m = m & (kv_positions[..., None, :] > q_positions[..., :, None] - sliding_window)
    m = m[:, None] if m.dim() == 3 else m[None, None]
    s = torch.where(m, s, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    pg = p.reshape(B, Hkv, g, Tq, k.shape[1])
    o = torch.einsum("bkgqt,btkd->bqkgd", pg, v)
    return o.reshape(B, Tq, H, v.shape[-1])


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
    one block (their decode is Tq = 1). The JAX package also skips the
    chunking under a mesh whose "model" axis already splits the queries;
    the port has no mesh yet (ROADMAP.md, queue 1, item 7).
    """
    Tq = q.shape[1]
    q_chunk = min(q_chunk or Tq, Tq)
    if q_positions.dim() > 1 or kv_positions.dim() > 1 or q_chunk == Tq:
        return _attention_block(q, k, v, q_positions, kv_positions, causal, sliding_window)
    n_chunks = -(-Tq // q_chunk)
    pad = n_chunks * q_chunk - Tq
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    pp = torch.nn.functional.pad(q_positions, (0, pad), value=-1)
    outs = [
        _attention_block(qp[:, c * q_chunk:(c + 1) * q_chunk], k, v,
                         pp[c * q_chunk:(c + 1) * q_chunk], kv_positions, causal, sliding_window)
        for c in range(n_chunks)
    ]
    return torch.cat(outs, dim=1)[:, :Tq]
