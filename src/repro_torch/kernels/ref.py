"""Plain PyTorch versions of the Hopper kernels.

They follow the kernels' numerics, which are the TPU kernels' numerics:
f32 accumulation, ``S`` applied in f32 to the f32 ``x U``, one rounding to
the working type at the output. The wrappers in
:mod:`repro_torch.kernels.lowrank_matmul` use them for CPU tensors, the
tests compare them with the JAX package, and ``chip_smoke.py`` holds each
kernel to its plain version on the card. Leading batch dims broadcast.
"""
from __future__ import annotations

from typing import Optional

import torch


def xus_ref(x: torch.Tensor, U: torch.Tensor, S: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A = (x @ U) @ S.  x: (..., M, K), U: (..., K, R), S: (..., R, R) or
    None for A = x @ U (one rounding, as with S = I)."""
    xu = x.float() @ U.float()
    return (xu if S is None else xu @ S.float()).to(x.dtype)


def avt_ref(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """y = A @ Vᵀ.  A: (..., M, R), V: (..., N, R) → (..., M, N)."""
    return (A.float() @ V.float().transpose(-1, -2)).to(A.dtype)


def lowrank_matmul_ref(x, U, S, V) -> torch.Tensor:
    """y = ((x U) S) Vᵀ — the paper's client-side bottleneck chain."""
    return avt_ref(xus_ref(x, U, S), V)


def atb_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C = Aᵀ @ B, accumulated in f32 and rounded once to ``A.dtype``.
    A: (..., M, Ka), B: (..., M, Kb) → (..., Ka, Kb).

    With A = x Ũ and B = dy Ṽ this is the coefficient gradient
    ``∇_S̃ L = Ũᵀ (xᵀ dy) Ṽ``, the hot op of the client loop's backward."""
    return (A.float().transpose(-1, -2) @ B.float()).to(A.dtype)
