"""Wrappers of the Hopper kernels for Mamba's state recurrence and its
gradient (``csrc/selective_scan.cu``).

:func:`selective_scan` runs ``h_t = a_t ⊙ h_{t-1} + b_t`` from a given
state, token by token, with ``a_t = exp(δ_t A)`` and ``b_t = (δ_t x_t) ⊗
B_t`` rounded to the state's working dtype at each step, and returns
``y_t = Σ_n h_t C_t`` with the last state: the JAX package's sequential
``lax.scan`` in ``mamba_mix``'s state branch (the serving prefill and every
decode step) and, from a zero state, its training branch's recurrence. The
reference computes both in XLA, not in a Pallas kernel; on the card it is
the selective-scan kernel that the reference's scans re-express for the
TPU.

When an input requires a gradient (and grad mode is on), the call is an
autograd Function: its forward saves only its inputs and the state every
:data:`SCAN_K` steps (the kernel writes them beside y), and its backward is
:func:`selective_scan_bwd`, the backward kernel, which walks each K-step
segment back after recomputing its states: the JAX package's reverse
recurrence (``_linrec_bwd``) chained through ``a`` and ``b``. No (B, T,
d_inner, N) tensor is saved or written.

A CUDA tensor launches the kernels, or the wrappers raise; a CPU tensor
takes the plain versions :func:`repro_torch.kernels.ref.selective_scan_ref`
and :func:`repro_torch.kernels.ref.selective_scan_bwd_ref`.
``selective_scan.launches`` and ``selective_scan_bwd.launches`` count the
calls that reached the card (a backward call is two device kernels: the
walk and the sum of its blocks' partials). On fake tensors they call the
custom ops ``repro_torch::selective_scan`` and
``repro_torch::selective_scan_bwd`` (shapes and a FLOP count, no launch),
as ``xus``, ``avt`` and ``atb`` do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import constraints, ref
from repro_torch.kernels.build import load_library
from repro_torch.kernels.lowrank_matmul import _DTYPE_CODE, _call, _on_device, _stream

#: operations a (b, t, channel, state) element of the forward: δA, exp,
#: δx·B, a·h, + b, h·C and its share of the sum over the states
SCAN_OPS = 7
#: and of the backward: the segment's states again (δA, exp, δx·B, a·h + b:
#: 5), then δA, exp, dy·C, a·λ + that, λ·h, ·exp, its ·A and + (2), λ·B and
#: + (2), ·δ and + for dA (2), λ·δx (dB), dy·h (dC)
SCAN_BWD_OPS = 20
#: the kernel keeps the state every SCAN_K steps for the backward, which
#: walks these segments back (:data:`constraints.SCAN_K_MAX` at most)
SCAN_K = 16


def selective_scan(delta: torch.Tensor, x: torch.Tensor, Bp: torch.Tensor, Cp: torch.Tensor,
                   A: torch.Tensor, h0: torch.Tensor,
                   scan_dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, h_T)`` of Mamba's recurrence from ``h0``. delta, x: (B, T, D)
    f32; Bp, Cp: (B, T, N) f32; A: (D, N) f32; h0: (B, D, N) f32;
    ``scan_dt`` the state's working dtype. y: (B, T, D) f32; h_T: (B, D,
    N) f32. Differentiable in every tensor."""
    ops = (delta, x, Bp, Cp, A, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return _SelectiveScan.apply(*ops, scan_dt)
    y, hT, _ = _forward(*ops, scan_dt, False)
    return y, hT


class _SelectiveScan(torch.autograd.Function):
    """Forward: the scan, keeping the state every :data:`SCAN_K` steps.
    Backward: :func:`selective_scan_bwd` from those and the inputs."""

    @staticmethod
    def forward(ctx, delta, x, Bp, Cp, A, h0, scan_dt):
        y, hT, ck = _forward(delta, x, Bp, Cp, A, h0, scan_dt, True)
        ctx.save_for_backward(delta, x, Bp, Cp, A, h0, ck)
        ctx.scan_dt = scan_dt
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        delta, x, Bp, Cp, A, h0, ck = ctx.saved_tensors
        dy = torch.zeros_like(delta) if dy is None else dy.contiguous()
        grads = selective_scan_bwd(delta, x, Bp, Cp, A, h0, ck, dy,
                                   None if dhT is None else dhT.contiguous(), ctx.scan_dt)
        return (*grads, None)


def _forward(delta, x, Bp, Cp, A, h0, scan_dt, checkpoints):
    """(y, h_T, the checkpoints or None): the custom op on fake tensors, the
    plain version on CPU tensors (no checkpoints: its backward recomputes
    from h0), the kernel on CUDA tensors."""
    if isinstance(delta, FakeTensor):
        y, hT, ck = torch.ops.repro_torch.selective_scan(delta, x, Bp, Cp, A, h0, scan_dt,
                                                         checkpoints)
        return y, hT, ck if checkpoints else None
    if delta.device.type == "cpu":
        y, hT = ref.selective_scan_ref(delta, x, Bp, Cp, A, h0, scan_dt)
        return y, hT, None
    return _launch_forward(delta, x, Bp, Cp, A, h0, scan_dt, checkpoints)


def _checked(name, ops, shapes_check):
    if ops[0].device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {ops[0].device}")
    shapes_check()
    constraints.check_operands(name, [t.device for t in ops], [t.is_contiguous() for t in ops],
                               ops[0].dtype)


def _launch_forward(delta, x, Bp, Cp, A, h0, scan_dt, checkpoints):
    ops = (delta, x, Bp, Cp, A, h0)
    B, T, D = delta.shape
    N = Bp.shape[-1]
    ck_shape = (B, -(-T // SCAN_K), D, N) if checkpoints else None
    _checked("selective_scan", ops, lambda: constraints.check_selective_scan(
        *(t.shape for t in ops), [t.dtype for t in ops], scan_dt, ck_shape, SCAN_K))
    lib = load_library()
    y = torch.empty((B, T, D), dtype=torch.float32, device=delta.device)
    hT = torch.empty((B, D, N), dtype=torch.float32, device=delta.device)
    ck = (torch.empty(ck_shape, dtype=torch.float32, device=delta.device)
          if checkpoints else None)
    with _on_device(delta):
        _call(lib.lr_selective_scan, _DTYPE_CODE[scan_dt], *(t.data_ptr() for t in ops),
              y.data_ptr(), hT.data_ptr(), None if ck is None else ck.data_ptr(), B, T, D, N,
              SCAN_K, _stream())
    selective_scan.launches += 1
    return y, hT, ck


selective_scan.launches = 0


def selective_scan_bwd(delta, x, Bp, Cp, A, h0, ck: Optional[torch.Tensor], dy,
                       dhT: Optional[torch.Tensor], scan_dt):
    """The scan's gradient ``(dδ, dx, dB, dC, dA, dh0)`` given ``dy`` (B, T,
    D) and ``dh_T`` (B, D, N, or None for none), from its inputs and the
    checkpoints ``ck`` (B, ⌈T / SCAN_K⌉, D, N) its forward kept on the card
    (None on the CPU, where the plain version recomputes from ``h0``)."""
    if isinstance(delta, FakeTensor):
        return torch.ops.repro_torch.selective_scan_bwd(delta, x, Bp, Cp, A, h0, ck, dy, dhT,
                                                        scan_dt)
    if delta.device.type == "cpu":
        return ref.selective_scan_bwd_ref(delta, x, Bp, Cp, A, h0, dy, dhT, scan_dt)
    ops = tuple(t for t in (delta, x, Bp, Cp, A, ck, dy, dhT) if t is not None)
    _checked("selective_scan_bwd", ops, lambda: constraints.check_selective_scan_bwd(
        *(t.shape for t in (delta, x, Bp, Cp, A)), None if ck is None else ck.shape, dy.shape,
        None if dhT is None else dhT.shape, [t.dtype for t in ops], scan_dt, SCAN_K))
    B, T, D = delta.shape
    N = Bp.shape[-1]
    lib = load_library()
    f32 = dict(dtype=torch.float32, device=delta.device)
    out = (torch.empty((B, T, D), **f32), torch.empty((B, T, D), **f32),
           torch.empty((B, T, N), **f32), torch.empty((B, T, N), **f32),
           torch.empty((D, N), **f32), torch.empty((B, D, N), **f32))
    scratch = torch.empty(lib.lr_selective_scan_bwd_scratch(B, T, D, N), **f32)
    with _on_device(delta):
        _call(lib.lr_selective_scan_bwd, _DTYPE_CODE[scan_dt],
              *(t.data_ptr() for t in (delta, x, Bp, Cp, A, ck, dy)),
              None if dhT is None else dhT.data_ptr(), *(t.data_ptr() for t in out),
              scratch.data_ptr(), B, T, D, N, SCAN_K, _stream())
    selective_scan_bwd.launches += 1
    return out


selective_scan_bwd.launches = 0


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def _selective_scan_op(delta: torch.Tensor, x: torch.Tensor, Bp: torch.Tensor, Cp: torch.Tensor,
                       A: torch.Tensor, h0: torch.Tensor, scan_dt: torch.dtype,
                       checkpoints: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    y, hT, ck = _forward(delta, x, Bp, Cp, A, h0, scan_dt, checkpoints)
    return y, hT, delta.new_empty((0,)) if ck is None else ck


@_selective_scan_op.register_fake
def _(delta, x, Bp, Cp, A, h0, scan_dt, checkpoints):
    B, T, D = delta.shape
    N = Bp.shape[-1]
    ck = (B, -(-T // SCAN_K), D, N) if checkpoints else (0,)
    return (delta.new_empty((B, T, D), dtype=torch.float32),
            delta.new_empty((B, D, N), dtype=torch.float32),
            delta.new_empty(ck, dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.selective_scan)
def _selective_scan_flops(delta_shape, x_shape, Bp_shape, *args, out_shape=None, **kwargs) -> int:
    B, T, D = delta_shape
    return SCAN_OPS * B * T * D * Bp_shape[-1]


@torch.library.custom_op("repro_torch::selective_scan_bwd", mutates_args=())
def _selective_scan_bwd_op(
        delta: torch.Tensor, x: torch.Tensor, Bp: torch.Tensor, Cp: torch.Tensor,
        A: torch.Tensor, h0: torch.Tensor, ck: Optional[torch.Tensor], dy: torch.Tensor,
        dhT: Optional[torch.Tensor], scan_dt: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(selective_scan_bwd(delta, x, Bp, Cp, A, h0, ck, dy, dhT, scan_dt))


@_selective_scan_bwd_op.register_fake
def _(delta, x, Bp, Cp, A, h0, ck, dy, dhT, scan_dt):
    return tuple(torch.empty_like(t, dtype=torch.float32) for t in (delta, x, Bp, Cp, A, h0))


@register_flop_formula(torch.ops.repro_torch.selective_scan_bwd)
def _selective_scan_bwd_flops(delta_shape, x_shape, Bp_shape, *args, out_shape=None,
                              **kwargs) -> int:
    B, T, D = delta_shape
    return SCAN_BWD_OPS * B * T * D * Bp_shape[-1]
