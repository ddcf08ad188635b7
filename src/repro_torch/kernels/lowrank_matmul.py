"""Wrappers of the Hopper kernels for the low-rank chain ``y = x U S Vᵀ``.

- :func:`xus` computes ``A = (x U) S``: f32 accumulation of ``x·U``, ``S``
  applied in f32, one rounding to ``x.dtype``. On the card it is up to
  three launches of ``csrc/lowrank_matmul.cu``: split-K partial sums, a
  fixed-order reduction of the splits, and an epilogue that applies ``S``.
  ``S=None`` gives ``A = x U`` with one rounding (the backward's ``S = I``
  products) and skips the epilogue.
- :func:`avt` computes ``y = A Vᵀ`` with f32 accumulation.

Both take 2-D operands or operands with one leading batch dim (stacked
factors), which the kernels run as a grid axis. A CUDA tensor launches the
kernel, or the wrapper raises; a CPU tensor takes the plain version in
:mod:`repro_torch.kernels.ref`. Each wrapper counts its launches in a plain
integer attribute (``xus.launches``, ``avt.launches``): one per call that
reached the card.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _batched(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dim() == 2:
        return t.unsqueeze(0)
    if t.dim() == 3:
        return t
    raise ValueError(f"{name} must be 2-D or 3-D (one stack dim), got {tuple(t.shape)}")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices {t.device} / {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if tensors[0].dtype not in _DTYPE_CODE:
        raise TypeError(
            f"{name}: dtype {tensors[0].dtype} not supported "
            f"(float32 or bfloat16)"
        )


def _call(fn, *args) -> None:
    code = fn(*args)
    if code != 0:
        msg = load_library().lr_error_string(code).decode()
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {code} ({msg})")


def _on_device(t: torch.Tensor):
    """Launch on ``t``'s card: the kernels go to the current device and
    its current stream, so switch only when ``t`` lies on another card."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def xus(x: torch.Tensor, U: torch.Tensor, S: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A = (x @ U) @ S.  x: ([G,] M, K), U: ([G,] K, R), S: ([G,] R, R) or
    None for A = x @ U."""
    if x.device.type == "cpu":
        return ref.xus_ref(x, U, S)
    if x.device.type != "cuda":
        raise ValueError(f"xus runs on cuda or cpu tensors, got {x.device}")
    x3, U3 = _batched(x, "x"), _batched(U, "U")
    S3 = None if S is None else _batched(S, "S")
    G, M, K = x3.shape
    R = U3.shape[-1]
    if U3.shape != (G, K, R) or (S3 is not None and S3.shape != (G, R, R)):
        raise ValueError(
            f"xus shapes disagree: x {tuple(x.shape)}, U {tuple(U.shape)}, "
            f"S {None if S is None else tuple(S.shape)}"
        )
    _check_cuda("xus", x3, U3, *(() if S3 is None else (S3,)))
    s_dtype = x3.dtype if S3 is None else S3.dtype
    if U3.dtype != x3.dtype or s_dtype not in (x3.dtype, torch.float32):
        raise TypeError(
            f"xus dtypes: x {x.dtype}, U {U.dtype}, S {s_dtype} (U must match "
            f"x; S must match x or be float32)"
        )
    lib = load_library()
    out = torch.empty((G, M, R), dtype=x.dtype, device=x.device)
    work = torch.empty(
        lib.lr_xus_workspace(G, M, K, R), dtype=torch.float32, device=x.device
    )
    with _on_device(x):
        _call(
            lib.lr_xus, _DTYPE_CODE[x3.dtype], _DTYPE_CODE[s_dtype],
            x3.data_ptr(), U3.data_ptr(), None if S3 is None else S3.data_ptr(),
            out.data_ptr(), work.data_ptr(), G, M, K, R, _stream(),
        )
    xus.launches += 1
    return out if x.dim() == 3 else out[0]


def avt(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """y = A @ Vᵀ.  A: ([G,] M, R), V: ([G,] N, R) → ([G,] M, N)."""
    if A.device.type == "cpu":
        return ref.avt_ref(A, V)
    if A.device.type != "cuda":
        raise ValueError(f"avt runs on cuda or cpu tensors, got {A.device}")
    A3, V3 = _batched(A, "A"), _batched(V, "V")
    G, M, R = A3.shape
    N = V3.shape[1]
    if V3.shape != (G, N, R):
        raise ValueError(
            f"avt shapes disagree: A {tuple(A.shape)}, V {tuple(V.shape)}"
        )
    _check_cuda("avt", A3, V3)
    if V3.dtype != A3.dtype:
        raise TypeError(f"avt dtypes: A {A.dtype}, V {V.dtype} must match")
    lib = load_library()
    y = torch.empty((G, M, N), dtype=A.dtype, device=A.device)
    with _on_device(A):
        _call(
            lib.lr_avt, _DTYPE_CODE[A3.dtype], A3.data_ptr(), V3.data_ptr(),
            y.data_ptr(), G, M, N, R, _stream(),
        )
    avt.launches += 1
    return y if A.dim() == 3 else y[0]


xus.launches = 0
avt.launches = 0
