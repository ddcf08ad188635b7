"""The low-rank chain ``y = ((x U) S) Vᵀ`` for the shapes model code has.

``lowrank_apply(x, U, S, V, use_kernels)`` runs the chain through the
:func:`~repro_torch.kernels.lowrank_matmul.xus` and
:func:`~repro_torch.kernels.lowrank_matmul.avt` wrappers (the Hopper
kernels on CUDA tensors, their plain versions on CPU tensors), or, with
``use_kernels=False``, as the plain working-dtype chain ``(x U) S Vᵀ`` of
the JAX package's ``"off"`` policy, differentiated by autograd.

The kernel path is a :class:`torch.autograd.Function` whose backward is the
chain of the JAX package's custom VJP (``src/repro/kernels/ops.py``), every
term on a kernel::

    dyV = dy V                   [xus, no S]
    xU  = x U                    [xus, no S]
    dA  = dy V Sᵀ                [xus]
    dx  = dA Uᵀ                  [avt]
    dU  = xᵀ dA                  [atb]
    dS  = (x U)ᵀ (dy V)          [atb: the client loop's hot op]
    xUS = x U S                  [xus]
    dV  = dyᵀ (x U S)            [atb]

with the JAX code's rounding points: every ``xus`` output rounds once to
the working type, ``atb`` accumulates in f32 and rounds once to its first
operand's type, and each cotangent is cast to its primal's dtype. Terms
nobody asked for (``ctx.needs_input_grad``) are skipped, as ``jit`` drops
them in JAX: the FeDLRT client loop, which differentiates only S̃ and the
activations, runs 3 ``xus``, 1 ``avt`` and 1 ``atb`` per call.

The Hopper kernels mask their ragged edges themselves, so nothing here pads
the rank to TPU lanes or the rows to TPU sublanes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.coeff_grad import atb
from repro_torch.kernels.lowrank_matmul import avt, xus
from repro_torch.telemetry import get_hub

#: model-level kernel policies (``ModelConfig.kernels``)
KERNEL_POLICIES = ("auto", "off")


def check_kernel_policy(policy: str) -> None:
    """Raise ``ValueError`` unless ``policy`` is one of :data:`KERNEL_POLICIES`."""
    if policy == "interpret":
        raise ValueError(
            "kernels='interpret' runs the JAX package's Pallas interpreter and "
            "has no counterpart in the port: use 'auto' (Hopper kernels on "
            "CUDA tensors, their plain versions on CPU tensors) or 'off'"
        )
    if policy not in KERNEL_POLICIES:
        raise ValueError(
            f"kernels policy must be one of {KERNEL_POLICIES}, got {policy!r}"
        )


def use_kernels_for(policy: str) -> bool:
    """Resolve a kernel policy to the ``lowrank_apply`` flag.

    - ``"auto"``: the kernel wrappers, which launch the Hopper kernels on
      CUDA tensors and take the plain versions on CPU tensors → ``True``;
    - ``"off"``: the plain working-dtype chain → ``False``.

    Each call counts a ``kernels.dispatch`` event on the process-global hub,
    as in the JAX package (which resolves once per trace, where the port
    resolves once per call).
    """
    check_kernel_policy(policy)
    flag = policy == "auto"
    get_hub().counter("kernels.dispatch", policy=policy, resolved=str(flag))
    return flag


class _LowRankApply(torch.autograd.Function):
    """``y = ((x U) S) Vᵀ`` on the kernels, with the kernel-backed backward
    described in the module docstring. Operands are contiguous, 2-D or with
    one leading stack dim."""

    @staticmethod
    def forward(ctx, x, U, S, V):
        ctx.save_for_backward(x, U, S, V)
        return avt(xus(x, U, S), V)

    @staticmethod
    def backward(ctx, dy):
        x, U, S, V = ctx.saved_tensors
        need_x, need_U, need_S, need_V = ctx.needs_input_grad
        dy = dy.contiguous()
        dx = dU = dS = dV = None
        if need_x or need_U:
            dA = xus(dy, V, S.transpose(-1, -2).float().contiguous())  # dy V Sᵀ
            if need_x:
                dx = avt(dA, U).to(x.dtype)
            if need_U:
                dU = atb(x, dA).to(U.dtype)
        if need_S:
            dS = atb(xus(x, U), xus(dy, V)).to(S.dtype)
        if need_V:
            dV = atb(dy, xus(x, U, S.float())).to(V.dtype)
        return dx, dU, dS, dV


def lowrank_apply(x, U, S, V, use_kernels: bool = False) -> torch.Tensor:
    """y = ((x U) S) Vᵀ.  x: ([G,] M, K), U: ([G,] K, R), S: ([G,] R, R),
    V: ([G,] N, R) → ([G,] M, N)."""
    if use_kernels:
        return _LowRankApply.apply(
            x.contiguous(), U.contiguous(), S.contiguous(), V.contiguous()
        )
    return torch.matmul(torch.matmul(x, U), S.to(x.dtype)) @ V.transpose(-1, -2)


def coeff_grad_kernels(x, dy, U, V) -> torch.Tensor:
    """∇_S L = (x U)ᵀ (dy V) through ``xus`` and ``atb`` (the paper's
    client backward). x: (M, K), dy: (M, N), U: (K, R), V: (N, R) → (R, R)."""
    return atb(xus(x.contiguous(), U.contiguous()), xus(dy.contiguous(), V.contiguous()))


def lowrank_apply_nd(x, U, S, V, use_kernels: bool = False) -> torch.Tensor:
    """:func:`lowrank_apply` for activations with leading batch dims and
    for stacked factors.

    - ``x`` may carry leading batch dims (``(B, T, d)`` activations): they
      are flattened into the kernels' M dim and restored on the output.
    - ``U/S/V`` may carry leading stack dims (the stacked
      :class:`~repro_torch.core.factorization.LowRankFactor` layout);
      ``x`` then leads with the same dims, and the stack runs as one grid
      axis of the kernels.
    """
    stack = tuple(U.shape[:-2])
    if x.shape[: len(stack)] != stack:
        raise ValueError(
            f"x {tuple(x.shape)} must lead with the factors' stack dims {stack}"
        )
    G = math.prod(stack)
    lead = tuple(x.shape[len(stack):-1])
    K, R, N = U.shape[-2], U.shape[-1], V.shape[-2]
    x3 = x.reshape(G, math.prod(lead), K)
    y = lowrank_apply(
        x3 if stack else x3[0],
        U.reshape(G, K, R) if stack else U,
        S.reshape(G, R, R) if stack else S,
        V.reshape(G, N, R) if stack else V,
        use_kernels,
    )
    return y.reshape(stack + lead + (N,))
