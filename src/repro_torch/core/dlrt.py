"""Dynamical low-rank (BUG splitting) primitives: augment and truncate —
the server side of FeDLRT (paper §3.1), the JAX package's
``repro.core.dlrt`` in PyTorch.

- :func:`augment_basis`: Eq. (6). Orthonormalize ``[Uᵗ | G_U]`` /
  ``[Vᵗ | G_V]`` and assemble ``S̃ = [[Sᵗ, 0], [0, 0]]`` (Lemma 1: no
  projection product is needed).
- :func:`truncate`: automatic compression. A ``2r × 2r`` SVD of the
  aggregated coefficient, the rank chosen by the singular-value tail
  ``‖[σ_{r₁}, …, σ_{2r}]‖₂ < ϑ``, the bases rotated by the singular vectors.

Cholesky, the triangular solve, QR and SVD are ``torch.linalg`` calls, as
the JAX package runs them outside any Pallas kernel. QR and SVD leave the
signs of basis vectors free, so results agree with the JAX package's on
spans, on ``U S Vᵀ``, on σ and on the chosen rank, not on raw bases.

Under a mesh (DTensor factors) the bases stay sharded on their feature
dim (``u_spec`` / ``v_spec``): every product here contracts over rows into
an ``r × r`` sum or is row-local, and the Cholesky, the triangular solve
and the SVD, which DTensor has no rule for, run on whole copies of their
small ``r × r`` / ``2r × 2r`` operands on every rank
(:func:`repro_torch.utils.meshctx.replicated_local`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.factorization import (
    AugmentedFactor,
    LowRankFactor,
    augmented_mask,
    mask_coeff,
    pad_coeff,
    rank_mask,
)
from repro_torch.utils import meshctx
from repro_torch.utils.tree import tree_map


def _mT(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def qr_pos(a: torch.Tensor) -> torch.Tensor:
    """QR with the sign convention ``diag(R) ≥ 0`` (batched over leading dims).

    When the leading columns of ``a`` are already orthonormal (as in
    ``[Uᵗ | G_U]``), ``Q``'s leading columns then equal them up to roundoff,
    not up to a sign, which is what makes Lemma 1 (``S̃`` without a
    projection) valid.
    """
    q, r = torch.linalg.qr(a)
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d).to(q.dtype)
    return q * d[..., None, :]


def _chol_inv(C: torch.Tensor) -> torch.Tensor:
    """``L⁻¹`` of ``C = L Lᵀ``; a failed batch member gives NaN."""
    eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
    L, info = torch.linalg.cholesky_ex(C)
    L = torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)
    return torch.linalg.solve_triangular(L, eye.expand(C.shape), upper=False, left=True)


def _ortho_complement_cholqr2(U: torch.Tensor, G: torch.Tensor, eps: float = 1e-7,
                              spec=None) -> torch.Tensor:
    """Orthonormalize ``G`` against the orthonormal ``U`` by CholeskyQR2.

    The left block is already orthonormal, so the span of ``qr([U | G])`` is
    had by projecting ``G`` off ``U`` and running CholeskyQR twice: batched
    products and an ``r × r`` Cholesky. ``Q L⁻ᵀ`` uses an explicit
    triangular inverse (a solve against the identity) and a product, as the
    JAX package does.

    A severely rank-deficient block can make the Cholesky fail. JAX then
    returns a NaN factor; ``cholesky_ex`` does not raise, and its failed
    batch members are set to NaN here so that both packages take the same
    path: every non-finite column is zeroed, and a zero basis column is
    inert in ``Ũ S̃ Ṽᵀ``.

    ``spec`` (under a mesh) pins the rows of Q to the basis' sharding, so
    no step gathers the basis.
    """
    if isinstance(G, DTensor) or isinstance(U, DTensor):
        return _ortho_complement_sharded(U, G, eps, spec)

    def once(Q):
        Q = Q - U @ (_mT(U) @ Q)
        C = _mT(Q) @ Q
        eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
        C = C + eps * eye
        L, info = torch.linalg.cholesky_ex(C)
        L = torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)
        L_inv = torch.linalg.solve_triangular(L, eye.expand(C.shape), upper=False, left=True)
        return Q @ _mT(L_inv)

    def finite(Q):
        return torch.where(torch.isfinite(Q), Q, torch.zeros_like(Q))

    return finite(once(finite(once(G))))


def _ortho_complement_sharded(U, G, eps: float, spec):
    """:func:`_ortho_complement_cholqr2` on DTensors: the ``r × r`` Gram
    matrix is summed over the row shards, its Cholesky inverse taken on
    every rank, and the rows of Q stay pinned to ``spec``."""

    def pin(Q):
        return meshctx.constrain(Q, spec) if spec is not None else Q

    def once(Q):
        Q = pin(Q - U @ (_mT(U) @ Q))
        C = _mT(Q) @ Q
        C = C + eps * torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
        return pin(Q @ _mT(meshctx.replicated_local(_chol_inv, C)))

    def finite(Q):
        return torch.where(torch.isfinite(Q), Q, torch.zeros_like(Q))

    return finite(once(finite(once(G))))


def _split_by_member(f):
    """``(mesh, placements)`` when no axis of size > 1 splits the DTensor
    factor ``f`` but on its stack dims (the experts): each rank then holds
    whole members, which augmentation and truncation treat one by one, so
    both run unchanged on the local shards (on a mesh of size-1 axes, the
    same calls as without a mesh). The placements keep the stack splits and
    are ``Replicate`` elsewhere. None otherwise."""
    if not isinstance(f.U, DTensor):
        return None
    mesh, ns = f.U.device_mesh, f.U.dim() - 2
    pl = []
    for i, p in enumerate(f.U.placements):
        if mesh.size(i) == 1:
            pl.append(Replicate())
        elif (isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim < ns)) and all(
                isinstance(t, DTensor) and t.placements[i] == p for t in (f.V, f.S)):
            pl.append(p)
        else:
            return None
    return mesh, tuple(pl)


def _members_local(fn, split, *tensors):
    """``fn`` on the local members of ``tensors`` (laid out as ``split``
    says); its tensor outputs (a tuple, possibly of factors and dicts) come
    back as DTensors split the same way."""
    mesh, pl = split

    def local(t):
        if not isinstance(t, DTensor):
            return t
        if any(p != q and mesh.size(i) > 1 for i, (p, q) in enumerate(zip(t.placements, pl))):
            t = t.redistribute(mesh, pl)
        return t.to_local()  # a size-1 axis holds it whole, however tagged

    def wrap(t):
        if not torch.is_tensor(t):
            return t
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(i)
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    out = fn(*(tree_map(local, t) for t in tensors))
    return tree_map(wrap, out)


def augment_basis(
    f: LowRankFactor, G_U: torch.Tensor, G_V: torch.Tensor, *, method: str = "cholqr2",
    u_spec=None, v_spec=None,
) -> AugmentedFactor:
    """Paper Eq. (6) + Lemma 1: ``Ũ = qr([Uᵗ | G_U])`` (and likewise for V).

    The gradient block is masked to the active rank first and normalized
    (the span does not change). ``method``: ``"cholqr2"`` (default,
    :func:`_ortho_complement_cholqr2`) or ``"householder"`` (the paper's
    QR). Returns the augmented factor with ``S̃ = [[Sᵗ, 0], [0, 0]]``.
    ``u_spec`` / ``v_spec`` (under a mesh) pin the complements' rows to the
    bases' sharding.
    """
    split = _split_by_member(f)
    if split is not None:
        return _members_local(lambda f, gu, gv: augment_basis(f, gu, gv, method=method),
                              split, f, G_U, G_V)
    r_max = f.r_max
    if 2 * r_max > min(f.n_in, f.n_out):
        raise ValueError(
            f"augmentation needs 2*r_max <= min(n_in, n_out); got r_max={r_max} "
            f"for a {f.n_in}x{f.n_out} layer (init_factor caps this)"
        )
    m = rank_mask(f.rank, r_max)
    gu = G_U.float() * m[..., None, :]
    gv = G_V.float() * m[..., None, :]
    gu = gu / (torch.linalg.norm(gu, dim=(-2, -1), keepdim=True) + 1e-12)
    gv = gv / (torch.linalg.norm(gv, dim=(-2, -1), keepdim=True) + 1e-12)
    U32, V32 = f.U.float(), f.V.float()
    if method == "cholqr2":
        # inactive columns come out (numerically) zero; mask exactly. Each
        # side's gradient block and complement are dropped as soon as its
        # augmented basis is formed: a stack's bases are the round's largest
        # tensors (DeepSeekMoE-16B's expert stacks 2.6 GB each in f32), and
        # the card holds the whole model's gradients beside them
        ubar = _ortho_complement_cholqr2(U32, gu, spec=u_spec) * m[..., None, :]
        del gu
        U_t = torch.cat([U32, ubar], dim=-1)
        del ubar
        vbar = _ortho_complement_cholqr2(V32, gv, spec=v_spec) * m[..., None, :]
        del gv
        V_t = torch.cat([V32, vbar], dim=-1)
        del vbar
    elif method == "householder":
        am = augmented_mask(f.rank, r_max)
        U_t = qr_pos(torch.cat([U32, gu], dim=-1)) * am[..., None, :]
        V_t = qr_pos(torch.cat([V32, gv], dim=-1)) * am[..., None, :]
    else:
        raise ValueError(method)
    if isinstance(f.S, DTensor):  # the same zero padding
        S_t = pad_coeff(f.S, r_max)
    else:
        S_t = torch.zeros(
            f.S.shape[:-2] + (2 * r_max, 2 * r_max), dtype=f.S.dtype, device=f.S.device
        )
        S_t[..., :r_max, :r_max] = f.S
    return AugmentedFactor(U=U_t.to(f.U.dtype), S=S_t, V=V_t.to(f.V.dtype), rank=f.rank)


def coeff_grad_mask(f: AugmentedFactor) -> torch.Tensor:
    """Mask restricting coefficient updates to the paper's 2r active directions."""
    return augmented_mask(f.rank, f.r_max, dtype=f.S.dtype)


def pick_rank(sigma: torch.Tensor, theta, r_max: int) -> torch.Tensor:
    """Smallest ``r₁`` with ``‖σ[r₁:]‖₂ < ϑ``, clipped to ``[1, r_max]``
    (float32). ``sigma`` is descending, batched over leading dims, with
    ``theta`` broadcasting accordingly."""
    tail_sq = torch.flip(torch.cumsum(torch.flip(torch.square(sigma), [-1]), -1), [-1])
    theta = torch.as_tensor(theta, dtype=sigma.dtype, device=sigma.device)
    ok = tail_sq < torch.square(theta)[..., None]
    first = torch.argmax(ok.to(torch.int8), dim=-1)  # first True
    r1 = torch.where(ok.any(dim=-1), first, torch.full_like(first, sigma.shape[-1]))
    return torch.clamp(r1, 1, r_max).to(torch.float32)


def truncate(
    f: AugmentedFactor, *, tau: float, theta_abs: Optional[float] = None
) -> Tuple[LowRankFactor, dict]:
    """Automatic compression (paper §3.1, rank truncation).

    ``ϑ = τ·‖S̃*‖_F`` unless an absolute ``theta_abs`` is given. The SVD
    runs on the ``2r_max × 2r_max`` coefficient only; the weight matrix is
    never formed. Columns past the new rank are zeroed.
    """
    split = _split_by_member(f)
    if split is not None:
        return _members_local(lambda f: truncate(f, tau=tau, theta_abs=theta_abs), split, f)
    r_max = f.r_max

    def small(S):
        """Everything that reads only the 2r × 2r coefficient."""
        S32 = S.float()
        P, sigma, Qt = torch.linalg.svd(S32, full_matrices=False)
        if theta_abs is not None:
            theta = torch.full(S32.shape[:-2], float(theta_abs), device=S32.device)
        else:
            theta = tau * torch.linalg.norm(S32, dim=(-2, -1))
        r1 = pick_rank(sigma, theta, r_max)
        keep = rank_mask(r1, r_max)
        diag_vals = sigma[..., :r_max] * keep
        eye = torch.eye(r_max, dtype=torch.float32, device=S32.device)
        S_new = (eye * diag_vals[..., None, :]).to(S.dtype)
        trunc_err = torch.sqrt(torch.clamp(
            torch.sum(torch.square(sigma), -1) - torch.sum(torch.square(diag_vals), -1), min=0.0
        ))
        return P, Qt, r1, keep, S_new, trunc_err, theta, sigma[..., 0]

    P, Qt, r1, keep, S_new, trunc_err, theta, sigma_max = meshctx.replicated_local(small, f.S)
    U_new = (f.U @ P[..., :, :r_max].to(f.U.dtype)) * keep[..., None, :]
    V_new = (f.V @ _mT(Qt[..., :r_max, :]).to(f.V.dtype)) * keep[..., None, :]
    out = LowRankFactor(U=U_new, S=S_new, V=V_new, rank=r1)
    info = {"rank": r1, "trunc_err": trunc_err, "theta": theta, "sigma_max": sigma_max}
    return out, info


def bug_round_dense_loss(loss_fn, f: LowRankFactor, *, lr: float, tau: float):
    """One non-federated rank-adaptive BUG step (Schotthöfer et al. '22):
    basis-gradient augmentation, one Galerkin coefficient step, truncation.
    The tests' cross-check of the federated scheme in the C = 1 limit."""
    U, V = (t.detach().requires_grad_(True) for t in (f.U, f.V))
    gU, gV = torch.autograd.grad(
        loss_fn(LowRankFactor(U=U, S=f.S, V=V, rank=f.rank)), (U, V)
    )
    aug = augment_basis(f, gU, gV)
    S_aug = aug.S.detach().requires_grad_(True)
    (gS,) = torch.autograd.grad(
        loss_fn(AugmentedFactor(U=aug.U, S=S_aug, V=aug.V, rank=aug.rank)), (S_aug,)
    )
    S_star = aug.S - lr * mask_coeff(gS, coeff_grad_mask(aug))
    return truncate(AugmentedFactor(U=aug.U, S=S_star, V=aug.V, rank=aug.rank), tau=tau)
