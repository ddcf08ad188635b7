"""The low-rank chain ``y = ((x U) S) Vᵀ`` for the shapes model code has.

``lowrank_apply(x, U, S, V, use_kernels)`` runs the chain through the
:func:`~repro_torch.kernels.lowrank_matmul.xus` and
:func:`~repro_torch.kernels.lowrank_matmul.avt` wrappers (the Hopper
kernels on CUDA tensors, their plain versions on CPU tensors), or, with
``use_kernels=False``, as the plain working-dtype chain ``(x U) S Vᵀ`` of
the JAX package's ``"off"`` policy. Forward only: the backward (the
``atb`` kernel) comes with the training slice.

The Hopper kernels mask their ragged edges themselves, so nothing here pads
the rank to TPU lanes or the rows to TPU sublanes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.lowrank_matmul import avt, xus

#: model-level kernel policies (``ModelConfig.kernels``)
KERNEL_POLICIES = ("auto", "off")


def use_kernels_for(policy: str) -> bool:
    """Resolve a kernel policy to the ``lowrank_apply`` flag.

    - ``"auto"``: the kernel wrappers, which launch the Hopper kernels on
      CUDA tensors and take the plain versions on CPU tensors → ``True``;
    - ``"off"``: the plain working-dtype chain → ``False``.
    """
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
    return policy == "auto"


def lowrank_apply(x, U, S, V, use_kernels: bool = False) -> torch.Tensor:
    """y = ((x U) S) Vᵀ.  x: ([G,] M, K), U: ([G,] K, R), S: ([G,] R, R),
    V: ([G,] N, R) → ([G,] M, N)."""
    if use_kernels:
        return avt(xus(x.contiguous(), U.contiguous(), S.contiguous()), V.contiguous())
    return torch.matmul(torch.matmul(x, U), S.to(x.dtype)) @ V.transpose(-1, -2)


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
