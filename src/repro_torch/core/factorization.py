"""Low-rank factor algebra for FeDLRT, in PyTorch.

A layer weight is ``W = U S Vᵀ`` with orthonormal bases ``U (n_in, r_max)``,
``V (n_out, r_max)``, a coefficient ``S (r_max, r_max)`` and an f32 scalar
``rank``. The buffers keep the fixed width ``r_max``; the invariant that
makes every operation exact under that padding is the JAX package's:

    S is zero outside its leading ``rank × rank`` block; the first ``rank``
    columns of U/V are orthonormal and all columns beyond ``rank`` are ZERO.

Stacked factors (layer stacks) carry leading dims on every field, as in the
JAX package, so parameters carry across as plain copies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class LowRankFactor:
    """``W = U S Vᵀ`` with masked adaptive rank (see module docstring)."""

    U: torch.Tensor  # (..., n_in, r_max)
    S: torch.Tensor  # (..., r_max, r_max); zero outside [:rank, :rank]
    V: torch.Tensor  # (..., n_out, r_max)
    rank: torch.Tensor  # f32, shape (...), active rank

    @property
    def r_max(self) -> int:
        return self.U.shape[-1]

    @property
    def n_in(self) -> int:
        return self.U.shape[-2]

    @property
    def n_out(self) -> int:
        return self.V.shape[-2]

    def __getitem__(self, i) -> "LowRankFactor":
        """One member of a stacked factor (a view)."""
        return LowRankFactor(U=self.U[i], S=self.S[i], V=self.V[i], rank=self.rank[i])


def is_factor(x) -> bool:
    return isinstance(x, LowRankFactor)


def rank_mask(rank: torch.Tensor, width: int, dtype=torch.float32) -> torch.Tensor:
    """``m[..., i] = 1.0 if i < rank else 0.0``; batched over ``rank``'s shape."""
    rank = torch.as_tensor(rank)
    i = torch.arange(width, device=rank.device)
    return (i < rank[..., None]).to(dtype)


def materialize(f: LowRankFactor) -> torch.Tensor:
    """The full ``n_in × n_out`` matrix (tests / tiny layers only)."""
    return torch.einsum("...ir,...rs,...js->...ij", f.U, f.S, f.V)


def lr_matmul(x: torch.Tensor, f: LowRankFactor, *, kernels: str = "off") -> torch.Tensor:
    """``y = x @ (U S Vᵀ)`` through the rank bottleneck; ``kernels``
    ("auto" | "off") routes it through the kernel chain."""
    if kernels != "off":
        from repro_torch.kernels.ops import lowrank_apply_nd, use_kernels_for

        return lowrank_apply_nd(
            x, f.U.to(x.dtype), f.S.to(x.dtype), f.V.to(x.dtype),
            use_kernels_for(kernels),
        )
    h = torch.matmul(x, f.U)
    h = torch.matmul(h, f.S.to(h.dtype))
    return torch.matmul(h, f.V.transpose(-1, -2).to(h.dtype))


def orthonormal_init(
    gen: torch.Generator, n: int, r: int, dtype=torch.float32, batch_shape: tuple = ()
) -> torch.Tensor:
    """Random orthonormal ``n × r`` basis (batched): QR of a Gaussian drawn
    from ``gen``, on ``gen``'s device."""
    a = torch.randn(
        tuple(batch_shape) + (n, r), generator=gen, device=gen.device,
        dtype=torch.float32,
    )
    q, _ = torch.linalg.qr(a)
    return q.to(dtype)


def init_factor(
    gen: torch.Generator,
    n_in: int,
    n_out: int,
    r_max: int,
    *,
    init_rank: Optional[int] = None,
    spectrum_scale: Optional[float] = None,
    dtype=torch.float32,
    batch_shape: tuple = (),
) -> LowRankFactor:
    """``U, V`` orthonormal and ``S`` full-rank diagonal with He-like scale
    (the JAX package's ``init_factor``; the draws differ, the invariants
    and the spectrum do not)."""
    # the augmented basis [U | G] must fit min(n_in, n_out) orthonormal
    # columns, so the rank buffer is capped at half the smaller dimension
    r_cap = max(min(n_in, n_out) // 2, 1)
    r_max = min(r_max, r_cap)
    if init_rank is None:
        init_rank = r_max
    init_rank = min(init_rank, r_max)
    U = orthonormal_init(gen, n_in, r_max, dtype, batch_shape)
    V = orthonormal_init(gen, n_out, r_max, dtype, batch_shape)
    if spectrum_scale is None:
        # Frobenius norm of a He-init dense matrix: ||W||_F² = 2·n_out
        spectrum_scale = (2.0 * n_out / max(init_rank, 1)) ** 0.5
    dev = gen.device
    m = rank_mask(torch.tensor(float(init_rank), device=dev), r_max)
    sigma = spectrum_scale * torch.exp(
        -torch.arange(r_max, dtype=torch.float32, device=dev) / max(init_rank, 1)
    ) * m
    S = torch.diag(sigma).expand(tuple(batch_shape) + (r_max, r_max)).to(dtype).contiguous()
    rank = torch.full(tuple(batch_shape), float(init_rank), device=dev)
    # zero-columns invariant: inactive basis columns are exactly zero
    return LowRankFactor(U=U * m.to(dtype), S=S, V=V * m.to(dtype), rank=rank)
