"""At-rest factor compression for serving (the JAX package's
``serve/quantize.py``).

Three independent knobs on a factorized parameter tree:

- **int8** (:func:`quantize_params` with ``mode="int8"``): per-*column*
  affine quantization of ``U`` and ``V`` with the wire codec's formula
  ``scale = (hi − lo)/255``, ``q = round((x − lo)/scale) − 128``, so the
  absolute dequantization error is at most ``scale/2`` per element. The
  reduction runs over axis ``-2``, one ``(lo, scale)`` pair per basis
  column, so an **inactive column is exactly zero** (the zero-inactive-
  columns invariant): its ``lo = hi = 0`` and it decodes to exactly
  ``0.0``. ``S`` (``r_max × r_max``, small) keeps its dtype.
- **bf16** (``mode="bf16"``): ``U``/``V`` downcast; ``S`` keeps its dtype.
- **rank slicing** (:func:`rank_slice_params`): drops the exactly-zero
  columns beyond each factor's active rank, shrinking ``r_max``. The
  sliced buffers are contiguous copies, as the kernel wrappers take them.

:func:`materialize_params` is the dense baseline (``U S Vᵀ`` per factor);
:func:`resident_bytes` prices what a prepared tree keeps on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.factorization import (
    LowRankFactor,
    is_factor,
    mask_coeff,
    materialize,
    rank_mask,
)
from repro_torch.utils.tree import tree_leaves, tree_map

QUANT_MODES = ("none", "int8", "bf16")


@dataclasses.dataclass
class QuantizedFactor:
    """int8 at-rest form of a :class:`LowRankFactor`.

    ``u_q``/``v_q`` are int8 with per-column affine parameters ``(lo,
    scale)`` shaped ``(..., 1, r_max)``; ``S`` and ``rank`` ride through
    unchanged. The int8 buffers stay resident; the serving engine
    dequantizes immediately before each forward.
    """

    u_q: torch.Tensor
    u_lo: torch.Tensor
    u_scale: torch.Tensor
    v_q: torch.Tensor
    v_lo: torch.Tensor
    v_scale: torch.Tensor
    S: torch.Tensor
    rank: torch.Tensor

    @property
    def r_max(self) -> int:
        return self.u_q.shape[-1]

    @property
    def n_in(self) -> int:
        return self.u_q.shape[-2]

    @property
    def n_out(self) -> int:
        return self.v_q.shape[-2]


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedFactor)


def is_factor_like(x) -> bool:
    """A factor leaf in either at-rest form (plain or int8)."""
    return is_factor(x) or is_quantized(x)


def _affine_encode(x: torch.Tensor):
    """The wire's int8 affine, per basis column (reduce over axis -2)."""
    x = x.float()
    lo = torch.amin(x, dim=-2, keepdim=True)
    hi = torch.amax(x, dim=-2, keepdim=True)
    scale = torch.clamp_min((hi - lo) / 255.0, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round((x - lo) / scale) - 128.0, -128, 127)
    return q.to(torch.int8), lo, scale


def _affine_decode(q: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() + 128.0) * scale + lo


def quantize_factor(f: LowRankFactor) -> QuantizedFactor:
    u_q, u_lo, u_scale = _affine_encode(f.U)
    v_q, v_lo, v_scale = _affine_encode(f.V)
    return QuantizedFactor(
        u_q=u_q, u_lo=u_lo, u_scale=u_scale,
        v_q=v_q, v_lo=v_lo, v_scale=v_scale,
        S=f.S, rank=f.rank,
    )


def dequantize_factor(qf: QuantizedFactor) -> LowRankFactor:
    """int8 → f32 factor, inactive columns re-masked to exactly zero (a zero
    column round-trips exactly already; the mask makes it structural)."""
    m = rank_mask(qf.rank, qf.r_max)
    u = _affine_decode(qf.u_q, qf.u_lo, qf.u_scale) * m[..., None, :]
    v = _affine_decode(qf.v_q, qf.v_lo, qf.v_scale) * m[..., None, :]
    return LowRankFactor(U=u, S=mask_coeff(qf.S, m), V=v, rank=qf.rank)


def quantization_error_bound(qf: QuantizedFactor) -> float:
    """Max absolute per-element dequantization error: ``max(scale)/2``."""
    worst = torch.maximum(torch.max(qf.u_scale), torch.max(qf.v_scale))
    return float(worst) / 2.0


def quantize_params(params, mode: str):
    """Apply at-rest compression ``mode`` to every factor leaf: ``"none"``
    is the identity, ``"bf16"`` downcasts ``U``/``V`` (the leaf stays a
    :class:`LowRankFactor`), ``"int8"`` rewrites leaves to
    :class:`QuantizedFactor`."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quantize mode must be one of {QUANT_MODES}, got {mode!r}")
    if mode == "none":
        return params

    def one(leaf):
        if not is_factor(leaf):
            return leaf
        if mode == "bf16":
            return LowRankFactor(U=leaf.U.to(torch.bfloat16), S=leaf.S,
                                 V=leaf.V.to(torch.bfloat16), rank=leaf.rank)
        return quantize_factor(leaf)

    return tree_map(one, params, is_leaf=is_factor)


def dequantize_params(params):
    """Restore :class:`LowRankFactor` leaves (identity on everything else)."""
    return tree_map(
        lambda x: dequantize_factor(x) if is_quantized(x) else x,
        params, is_leaf=is_factor_like,
    )


def _sliced_width(rank, r_max: int) -> int:
    """Post-slice buffer width: the largest active rank rounded up to a
    multiple of 8, at least 8 and never above ``r_max``."""
    r = max(int(torch.max(torch.as_tensor(rank)).item()), 1)
    return min(-(-r // 8) * 8, r_max)


def rank_slice_params(params):
    """Drop the exactly-zero inactive columns of every factor leaf.

    A stacked factor is sliced to the largest active rank of its members,
    so its buffers stay rectangular. ``U S Vᵀ`` keeps its value: every
    dropped column is zero (up to the summation order of the products).
    """

    def one(leaf):
        if not is_factor(leaf):
            return leaf
        w = _sliced_width(leaf.rank, leaf.r_max)
        if w == leaf.r_max:
            return leaf
        return LowRankFactor(
            U=leaf.U[..., :, :w].contiguous(),
            S=leaf.S[..., :w, :w].contiguous(),
            V=leaf.V[..., :, :w].contiguous(),
            rank=leaf.rank,
        )

    return tree_map(one, params, is_leaf=is_factor)


def materialize_params(params):
    """Densify every factor to ``U S Vᵀ``: the dense decode baseline, which
    ``apply_linear`` / ``apply_embedding`` run as plain matmuls and gathers."""
    return tree_map(lambda x: materialize(x) if is_factor(x) else x, params, is_leaf=is_factor)


def resident_bytes(params) -> int:
    """Device-resident bytes of a prepared serving tree: int8 factors count
    their codes, affine parameters and ``S``, not the transient f32 views
    the engine decodes each forward."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(params)
                   if isinstance(t, torch.Tensor)))
