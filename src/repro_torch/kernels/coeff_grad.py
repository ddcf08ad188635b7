"""Wrapper of the Hopper kernel for the coefficient-gradient projection
``C = Aᵀ B`` (``csrc/coeff_grad.cu``).

With ``A = x Ũ`` and ``B = (∂L/∂y) Ṽ`` this is the FeDLRT client's
per-step coefficient gradient ``∇_S̃ L = Aᵀ B``; the backward of
:func:`~repro_torch.kernels.ops.lowrank_apply` also takes the basis
cotangents ``dU = xᵀ (dy V Sᵀ)`` and ``dV = dyᵀ (x U S)`` from it.

:func:`atb` reduces over all of M in f32 and rounds once to ``A.dtype``.
On the card it is one launch (or two: M-split partial tiles, then a
fixed-order sum of the splits). It takes 2-D operands or operands with one
leading batch dim. A CUDA tensor launches the kernel, or the wrapper
raises; a CPU tensor takes the plain version :func:`repro_torch.kernels
.ref.atb_ref`. ``atb.launches`` counts the calls that reached the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load_library
from repro_torch.kernels.lowrank_matmul import (
    _DTYPE_CODE,
    _batched,
    _call,
    _check_cuda,
    _on_device,
    _stream,
)


def atb(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C = Aᵀ @ B.  A: ([G,] M, Ka), B: ([G,] M, Kb) → ([G,] Ka, Kb)."""
    if A.device.type == "cpu":
        return ref.atb_ref(A, B)
    if A.device.type != "cuda":
        raise ValueError(f"atb runs on cuda or cpu tensors, got {A.device}")
    A3, B3 = _batched(A, "A"), _batched(B, "B")
    G, M, Ka = A3.shape
    Kb = B3.shape[-1]
    if B3.shape != (G, M, Kb):
        raise ValueError(
            f"atb shapes disagree: A {tuple(A.shape)}, B {tuple(B.shape)}"
        )
    _check_cuda("atb", A3, B3)
    if B3.dtype != A3.dtype:
        raise TypeError(f"atb dtypes: A {A.dtype}, B {B.dtype} must match")
    lib = load_library()
    C = torch.empty((G, Ka, Kb), dtype=A.dtype, device=A.device)
    work = torch.empty(
        lib.lr_atb_workspace(G, M, Ka, Kb), dtype=torch.float32, device=A.device
    )
    with _on_device(A):
        _call(
            lib.lr_atb, _DTYPE_CODE[A3.dtype], A3.data_ptr(), B3.data_ptr(),
            C.data_ptr(), work.data_ptr(), G, M, Ka, Kb, _stream(),
        )
    atb.launches += 1
    return C if A.dim() == 3 else C[0]


atb.launches = 0
