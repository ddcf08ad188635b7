"""Wrapper of the Hopper kernel for Mamba's state recurrence
(``csrc/selective_scan.cu``).

:func:`selective_scan` runs ``h_t = a_t ⊙ h_{t-1} + b_t`` from a given
state, token by token, with ``a_t = exp(δ_t A)`` and ``b_t = (δ_t x_t) ⊗
B_t`` rounded to the state's working dtype at each step, and returns
``y_t = Σ_n h_t C_t`` with the last state: the JAX package's sequential
``lax.scan`` in ``mamba_mix``'s state branch, which the serving prefill and
every decode step take. The reference computes it in XLA, not in a Pallas
kernel; on the card it is the selective-scan kernel that the reference's
scan re-expresses for the TPU.

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor
takes the plain version :func:`repro_torch.kernels.ref.selective_scan_ref`.
``selective_scan.launches`` counts the calls that reached the card. On
fake tensors it calls the custom op ``repro_torch::selective_scan``
(shapes and a FLOP count, no launch), as ``xus``, ``avt`` and ``atb`` do.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import constraints, ref
from repro_torch.kernels.build import load_library
from repro_torch.kernels.lowrank_matmul import _DTYPE_CODE, _call, _on_device, _stream

#: operations a (b, t, channel, state) element: δA, exp, δx·B, a·h, + b,
#: h·C and its share of the sum over the states
SCAN_OPS = 7


def selective_scan(delta: torch.Tensor, x: torch.Tensor, Bp: torch.Tensor, Cp: torch.Tensor,
                   A: torch.Tensor, h0: torch.Tensor,
                   scan_dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, h_T)`` of Mamba's recurrence from ``h0``. delta, x: (B, T, D)
    f32; Bp, Cp: (B, T, N) f32; A: (D, N) f32; h0: (B, D, N) f32;
    ``scan_dt`` the state's working dtype. y: (B, T, D) f32; h_T: (B, D,
    N) f32."""
    if isinstance(delta, FakeTensor):
        return torch.ops.repro_torch.selective_scan(delta, x, Bp, Cp, A, h0, scan_dt)
    return _selective_scan(delta, x, Bp, Cp, A, h0, scan_dt)


def _selective_scan(delta, x, Bp, Cp, A, h0, scan_dt):
    if delta.device.type == "cpu":
        return ref.selective_scan_ref(delta, x, Bp, Cp, A, h0, scan_dt)
    if delta.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu tensors, got {delta.device}")
    ops = (delta, x, Bp, Cp, A, h0)
    constraints.check_selective_scan(*(t.shape for t in ops), [t.dtype for t in ops], scan_dt)
    constraints.check_operands("selective_scan", [t.device for t in ops],
                               [t.is_contiguous() for t in ops], delta.dtype)
    B, T, D = delta.shape
    N = Bp.shape[-1]
    lib = load_library()
    y = torch.empty((B, T, D), dtype=torch.float32, device=delta.device)
    hT = torch.empty((B, D, N), dtype=torch.float32, device=delta.device)
    with _on_device(delta):
        _call(lib.lr_selective_scan, _DTYPE_CODE[scan_dt], *(t.data_ptr() for t in ops),
              y.data_ptr(), hT.data_ptr(), B, T, D, N, _stream())
    selective_scan.launches += 1
    return y, hT


selective_scan.launches = 0


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def _selective_scan_op(delta: torch.Tensor, x: torch.Tensor, Bp: torch.Tensor, Cp: torch.Tensor,
                       A: torch.Tensor, h0: torch.Tensor,
                       scan_dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    return _selective_scan(delta, x, Bp, Cp, A, h0, scan_dt)


@_selective_scan_op.register_fake
def _(delta, x, Bp, Cp, A, h0, scan_dt):
    B, T, D = delta.shape
    return (delta.new_empty((B, T, D), dtype=torch.float32),
            delta.new_empty((B, D, Bp.shape[-1]), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.selective_scan)
def _selective_scan_flops(delta_shape, x_shape, Bp_shape, *args, out_shape=None, **kwargs) -> int:
    B, T, D = delta_shape
    return SCAN_OPS * B * T * D * Bp_shape[-1]
