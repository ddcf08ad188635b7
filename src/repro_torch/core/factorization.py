"""Low-rank factor algebra for FeDLRT, in PyTorch.

A layer weight is ``W = U S Vᵀ`` with orthonormal bases ``U (n_in, r_max)``,
``V (n_out, r_max)``, a coefficient ``S (r_max, r_max)`` and an f32 scalar
``rank``. The buffers keep the fixed width ``r_max``; the invariant that
makes every operation exact under that padding is the JAX package's:

    S is zero outside its leading ``rank × rank`` block; the first ``rank``
    columns of U/V are orthonormal and all columns beyond ``rank`` are ZERO.

Stacked factors (layer stacks) carry leading dims on every field, as in the
JAX package, so parameters carry across as plain copies.

Between basis augmentation and truncation a factor is an
:class:`AugmentedFactor` of width ``2·r_max``, whose active directions are
``[0, r) ∪ [r_max, r_max + r)`` (:func:`augmented_mask`). ``rank`` is a
float32 tensor that never takes part in differentiation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.utils.tree import tree_map


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


@dataclasses.dataclass
class AugmentedFactor:
    """Augmented state between basis augmentation and truncation.

    ``U, V`` are ``(..., n, 2·r_max)``, ``S`` is ``(..., 2·r_max, 2·r_max)``.
    The active directions are ``[0, r) ∪ [r_max, r_max + r)`` with ``r`` the
    pre-augmentation rank: the original basis columns, then the
    orthonormalized basis-gradient columns (rank r → 2r, paper Eq. (6)).
    """

    U: torch.Tensor
    S: torch.Tensor
    V: torch.Tensor
    rank: torch.Tensor  # pre-augmentation rank

    @property
    def r_max(self) -> int:
        return self.U.shape[-1] // 2

    @property
    def n_in(self) -> int:
        return self.U.shape[-2]

    @property
    def n_out(self) -> int:
        return self.V.shape[-2]

    def __getitem__(self, i) -> "AugmentedFactor":
        """One member of a stacked factor (a view)."""
        return AugmentedFactor(U=self.U[i], S=self.S[i], V=self.V[i], rank=self.rank[i])


def is_factor(x) -> bool:
    return isinstance(x, (LowRankFactor, AugmentedFactor))


def rank_mask(rank: torch.Tensor, width: int, dtype=torch.float32) -> torch.Tensor:
    """``m[..., i] = 1.0 if i < rank else 0.0``; batched over ``rank``'s shape."""
    rank = torch.as_tensor(rank)
    i = torch.arange(width, device=rank.device)
    return (i < rank[..., None]).to(dtype)


def augmented_mask(rank: torch.Tensor, r_max: int, dtype=torch.float32) -> torch.Tensor:
    """Active-direction mask of the augmented basis, last dim ``2·r_max``:
    the first ``rank`` original columns plus the first ``rank`` gradient
    columns (which start at offset ``r_max``). Batched over ``rank``."""
    rank = torch.as_tensor(rank)
    i = torch.arange(2 * r_max, device=rank.device)
    r = rank[..., None]
    active = (i < r) | ((i >= r_max) & (i < r_max + r))
    return active.to(dtype)


def pad_coeff(S, r_max: int):
    """The DTensor coefficient ``S`` (…, r, r) zero-padded into the top-left
    block of (…, 2r, 2r), on each rank's shard: the rank dims are never
    split, so the placements carry over (DTensor's own rule for ``pad``
    drops a mesh dim in torch 2.11)."""
    local = torch.nn.functional.pad(S.to_local(), (0, r_max, 0, r_max))
    shape = tuple(S.shape[:-2]) + (2 * r_max, 2 * r_max)
    return DTensor.from_local(local, S.device_mesh, S.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def mask_coeff(S: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero S outside the active block: ``m ⊙ S ⊙ mᵀ`` (batched over ...)."""
    return S * mask[..., :, None] * mask[..., None, :]


def materialize(f) -> torch.Tensor:
    """The full ``n_in × n_out`` matrix (tests / tiny layers only), in the
    promoted dtype of U, S and V (a training factor's f32 bases with a bf16
    S give f32, as ``jnp.einsum`` does)."""
    dt = _promoted(f)
    return torch.einsum("...ir,...rs,...js->...ij", f.U.to(dt), f.S.to(dt), f.V.to(dt))


def _promoted(f) -> torch.dtype:
    return torch.promote_types(torch.promote_types(f.U.dtype, f.S.dtype), f.V.dtype)


def lr_matmul(x: torch.Tensor, f, *, kernels: str = "off") -> torch.Tensor:
    """``y = x @ (U S Vᵀ)`` through the rank bottleneck, for a
    :class:`LowRankFactor` or an :class:`AugmentedFactor` (whose zero
    inactive columns keep the chain equal to the masked one); ``kernels``
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


def training_dtypes(params):
    """A model's parameters in the JAX package's initial dtypes for
    training: its ``init_factor`` multiplies the bases (in ``param_dtype``)
    by an f32 rank mask, so U and V start in f32 beside an S in
    ``param_dtype``, and the round keeps each factor's dtypes
    (``augment_basis``, ``truncate``): a bf16 round carries f32 bases,
    orthonormal to f32 precision. The values are the ``param_dtype`` ones.
    Every training caller (the ``lm`` task, the dry run's train shapes)
    starts from these; serving keeps its bases in ``param_dtype``."""
    return tree_map(
        lambda x: dataclasses.replace(x, U=x.U.float(), V=x.V.float()) if is_factor(x) else x,
        params, is_leaf=is_factor,
    )


def lr_rowlookup(idx: torch.Tensor, f: LowRankFactor, *, out_dtype=None) -> torch.Tensor:
    """Row lookup ``W[idx, :]`` of a factorized table: a gather of the
    ``r``-wide rows of U and two small products; the ``vocab × d`` table is
    never formed."""
    dt = _promoted(f)
    out = (f.U[idx].to(dt) @ f.S.to(dt)) @ f.V.to(dt).transpose(-1, -2)
    return out.to(out_dtype) if out_dtype is not None else out


def factor_param_count(f: LowRankFactor) -> int:
    """Static parameter count of the communicated / stored factors."""
    return f.U.numel() + f.S.numel() + f.V.numel()


def effective_rank(f: LowRankFactor) -> torch.Tensor:
    return f.rank


def check_invariants(f: LowRankFactor, *, atol: float = 1e-4) -> dict:
    """Diagnostics (tests): active-block orthonormality, zero inactive
    columns, S-mask violation. Stacked factors report the max over the stack."""
    m = rank_mask(f.rank, f.r_max)
    eye = torch.eye(f.r_max, device=m.device)

    def defect(B):
        B = B.float()
        gram = B.transpose(-1, -2) @ B
        block = m[..., None, :] * m[..., :, None]
        active_err = torch.linalg.norm((gram - eye * block) * block, dim=(-2, -1))
        inactive_err = torch.linalg.norm(B * (1 - m)[..., None, :], dim=(-2, -1))
        return torch.max(active_err + inactive_err)

    s_violation = torch.linalg.norm(f.S - mask_coeff(f.S, m), dim=(-2, -1))
    return {
        "u_ortho_defect": defect(f.U),
        "v_ortho_defect": defect(f.V),
        "s_mask_violation": torch.max(s_violation),
    }
