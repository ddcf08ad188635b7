"""Wrapper of the Hopper kernel for the coefficient-gradient projection
``C = Aᵀ B`` (``csrc/coeff_grad.cu``).

With ``A = x Ũ`` and ``B = (∂L/∂y) Ṽ`` this is the FeDLRT client's
per-step coefficient gradient ``∇_S̃ L = Aᵀ B``; the backward of
:func:`~repro_torch.kernels.ops.lowrank_apply` also takes the basis
cotangents ``dU = xᵀ (dy V Sᵀ)`` and ``dV = dyᵀ (x U S)`` from it.

:func:`atb` reduces over all of M in f32 and rounds once to ``A.dtype``.
On the card it is one launch of a split-precision tensor-core product,
planned by :func:`atb_plan` from the shapes alone: M is split where the
tiles of C are too few to fill the card, and the last block of each tile
adds the splits' partials in split order. It takes 2-D operands or
operands with one leading batch dim. A CUDA tensor launches the kernel, or
the wrapper raises; a CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.atb_ref`. ``atb.launches`` counts the calls
that reached the card. On fake tensors it calls the custom op
``repro_torch::atb`` instead (shape and FLOP count, no launch), as ``xus``
and ``avt`` do (:mod:`repro_torch.kernels.lowrank_matmul`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import constraints, ref
from repro_torch.kernels.build import load_library
from repro_torch.kernels.constraints import COUNTER_INTS, GRID_X_MAX, GRID_YZ_MAX, grid_fits
from repro_torch.kernels.lowrank_matmul import (
    _DTYPE_CODE,
    _batched,
    _call,
    _cdiv,
    _check_cuda,
    _counter_slot,
    _on_device,
    _record,
)

#: a block's tile of C (Ka × Kb) and the rows of M it stages a step
ATB_TILE = (64, 32)
ATB_STEP = 32
#: M is split while the tile grid is under this many blocks (about 1.5
#: waves of an H100's 132 SMs, as ``xus``'s tiled route aims), each split
#: at least this many rows
ATB_BLOCKS = 200
ATB_MC_MIN = 64
#: the splits' f32 partials stay within this many times the operands'
#: elements (4 splits at the round's 320², 1.25x: on the card 3 splits, the
#: most that 1x allows, were slower)
ATB_PARTIALS = 2


class AtbPlan(NamedTuple):
    """How one ``atb`` call runs on the card (see :func:`atb_plan`)."""

    tile: Tuple[int, int]  # a block's tile of C, (Ka, Kb)
    splits: int            # M splits
    mc: int                # rows of M per split (the last split may be shorter)
    launches: int          # device kernels the call launches
    workspace: int         # f32 elements of scratch: the splits' partials
    counters: int          # ticket counters (0: none)


@functools.lru_cache(maxsize=1024)
def atb_plan(G: int, M: int, Ka: int, Kb: int) -> AtbPlan:
    """Tile, M splits, launches, workspace and counters of ``atb`` on ``G``
    stacked ``(M, Ka)ᵀ · (M, Kb)`` products.

    One launch at every shape: a grid of 64 × 32 tiles of C × M splits × G.
    M is split only while that tile grid is under :data:`ATB_BLOCKS`
    (about 1.5 waves of an H100), into splits of whole 32-row steps of at
    least 64 rows, and only so far that the splits' f32 partials
    (``splits · G · Ka · Kb``) stay within :data:`ATB_PARTIALS` times the
    operands' elements (``G · M · (Ka + Kb)``). A split call takes a ticket
    counter a tile, and does not split where those would not fit in
    :data:`COUNTER_INTS`.
    The plan reads constants and the shapes, never the card, so the
    summation order (and the bits) depend on the shapes alone.
    """
    if min(G, M, Ka, Kb) < 1:
        raise ValueError(f"atb_plan: sizes must be positive, got G={G} M={M} Ka={Ka} Kb={Kb}")
    ta, tb = _cdiv(Ka, ATB_TILE[0]), _cdiv(Kb, ATB_TILE[1])
    tiles = G * ta * tb
    mc = M
    if tiles < ATB_BLOCKS and tiles <= COUNTER_INTS:
        want = min(_cdiv(ATB_BLOCKS, tiles), max(1, ATB_PARTIALS * M * (Ka + Kb) // (Ka * Kb)))
        mc = min(M, max(ATB_MC_MIN, _cdiv(_cdiv(M, want), ATB_STEP) * ATB_STEP))
    splits = _cdiv(M, mc)
    if not grid_fits(ta, tb, G * splits):
        raise ValueError(
            f"atb: grid too large for G={G} M={M} Ka={Ka} Kb={Kb}: {ta} x {tb} tiles x "
            f"{G * splits} (M splits x G); at most {GRID_X_MAX} x {GRID_YZ_MAX} x {GRID_YZ_MAX}"
        )
    if splits == 1:
        return AtbPlan(ATB_TILE, 1, M, 1, 0, 0)
    return AtbPlan(ATB_TILE, splits, mc, 1, G * splits * Ka * Kb, tiles)


def atb(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C = Aᵀ @ B.  A: ([G,] M, Ka), B: ([G,] M, Kb) → ([G,] Ka, Kb)."""
    if isinstance(A, FakeTensor):
        _record("atb", A, A.shape[-1], B.shape[-1])
        return torch.ops.repro_torch.atb(A, B)
    return _atb(A, B)


def _atb(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    if A.device.type == "cpu":
        return ref.atb_ref(A, B)
    if A.device.type != "cuda":
        raise ValueError(f"atb runs on cuda or cpu tensors, got {A.device}")
    A3, B3 = _batched(A, "A"), _batched(B, "B")
    G, M, Ka = A3.shape
    Kb = B3.shape[-1]
    constraints.check_atb_shapes(A.shape, B.shape)
    _check_cuda("atb", A3, B3)
    constraints.check_pair_dtypes("atb", "AB", A.dtype, B.dtype)
    lib = load_library()
    plan = atb_plan(G, M, Ka, Kb)
    C = torch.empty((G, Ka, Kb), dtype=A.dtype, device=A.device)
    work = torch.empty(plan.workspace, dtype=torch.float32, device=A.device)
    # 16-byte copies where the rows are whole vectors and the data is aligned
    v = 16 // A3.element_size()
    ap, bp = A3.data_ptr(), B3.data_ptr()
    vec = int(Ka % v == 0 and Kb % v == 0 and ap % 16 == 0 and bp % 16 == 0)
    with _on_device(A):
        stream = torch.cuda.current_stream().cuda_stream
        counters = _counter_slot(A.device, stream) if plan.counters else None
        _call(
            lib.lr_atb, _DTYPE_CODE[A3.dtype], ap, bp, C.data_ptr(), work.data_ptr(),
            plan.workspace, counters, G, M, Ka, Kb, plan.mc, vec, ctypes.c_void_p(stream),
        )
    atb.launches += 1
    return C if A.dim() == 3 else C[0]


atb.launches = 0


@torch.library.custom_op("repro_torch::atb", mutates_args=())
def _atb_op(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return _atb(A, B)


@_atb_op.register_fake
def _(A, B):
    return A.new_empty(tuple(A.shape[:-2]) + (A.shape[-1], B.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.atb)
def _atb_flops(A_shape, B_shape, *args, out_shape=None, **kwargs) -> int:
    G = A_shape[0] if len(A_shape) == 3 else 1
    return 2 * G * A_shape[-2] * A_shape[-1] * B_shape[-1]
