"""The operand contract of the Hopper kernels ``xus``, ``avt`` and ``atb``.

One table, read twice: the wrappers
(:mod:`repro_torch.kernels.lowrank_matmul`,
:mod:`repro_torch.kernels.coeff_grad`) check every call that reaches the
card against it and raise what it returns, and the port's lint (RPL009,
:mod:`repro_torch.analysis.shapes`) checks every call the kernel path
makes against it statically, so the two cannot drift apart.

It is not the JAX package's TPU tile table: the Hopper kernels mask their
ragged edges, so nothing here pads the rank to 128 lanes or the rows to a
sublane multiple. What a call must meet:

- each operand is 2-D, or 3-D with one leading stack dim
  (:func:`check_stack_dims`);
- the operands lie on one device and are contiguous, in a dtype the
  kernels take (:data:`DTYPE_CODES`; :func:`check_operands`);
- ``xus``: ``U.dtype == x.dtype`` and ``S`` in ``{x.dtype, float32}``;
  ``avt``: ``A`` and ``V`` match; ``atb``: ``A`` and ``B`` match
  (:func:`check_xus_dtypes`, :func:`check_pair_dtypes`);
- the shapes agree (:func:`check_xus_shapes`, :func:`check_avt_shapes`,
  :func:`check_atb_shapes`);
- the launch grid fits the card's limits, :data:`GRID_X_MAX` ×
  :data:`GRID_YZ_MAX` × :data:`GRID_YZ_MAX` (:func:`grid_fits`), and a
  call's ticket counters fit a slot of :data:`COUNTER_INTS`: the plans
  (``xus_plan``, ``avt_plan``, ``atb_plan``) read these.

Every check takes shapes and dtypes (``torch.dtype`` objects or their
names) and raises the ``ValueError`` or ``TypeError`` the wrapper raises;
the lint catches it. The module itself imports nothing.
"""
from __future__ import annotations

from typing import Sequence

#: dtypes the kernels take, by name, and their codes in ``csrc/``
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
#: the one dtype ``S`` may take besides ``x``'s
S_WIDE_DTYPE = "float32"
#: operand ranks: 2-D, or 3-D with one leading stack dim
STACK_DIMS = (2, 3)
#: CUDA grid limits (x, and y / z)
GRID_X_MAX = 2**31 - 1
GRID_YZ_MAX = 65535
#: ticket counters one call may use (a slot of the pool): a stream route
#: ``xus`` call takes G · (column tiles + 1), a tiled one with K splits one
#: a tile a pass, an ``atb`` call with M splits one a tile
COUNTER_INTS = 4096


def dtype_name(dtype) -> str:
    """``"float32"`` for ``torch.float32`` or ``"float32"``."""
    return str(dtype).replace("torch.", "")


def _batch(shape) -> tuple:
    shape = tuple(shape)
    return shape if len(shape) == 3 else (1,) + shape


def check_stack_dims(name: str, shape) -> None:
    if len(shape) not in STACK_DIMS:
        raise ValueError(f"{name} must be 2-D or 3-D (one stack dim), got {tuple(shape)}")


def check_operands(name: str, devices: Sequence, contiguous: Sequence[bool], dtype) -> None:
    """One device, every operand contiguous, the first operand's dtype one
    the kernels take."""
    dev = devices[0]
    for d, c in zip(devices, contiguous):
        if d != dev:
            raise ValueError(f"{name}: operands on different devices {d} / {dev}")
        if not c:
            raise ValueError(f"{name}: operands must be contiguous")
    if dtype_name(dtype) not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32 or bfloat16)")


def check_xus_dtypes(x, U, S) -> None:
    """``U`` matches ``x``; ``S`` (``x``'s dtype when None) matches ``x`` or
    is float32."""
    s = x if S is None else S
    if dtype_name(U) != dtype_name(x) or dtype_name(s) not in (dtype_name(x), S_WIDE_DTYPE):
        raise TypeError(f"xus dtypes: x {x}, U {U}, S {s} (U must match x; S must match x "
                        f"or be float32)")


def check_pair_dtypes(kernel: str, names: str, a, b) -> None:
    """``avt``'s A and V, ``atb``'s A and B: one dtype."""
    if dtype_name(a) != dtype_name(b):
        first, second = names
        raise TypeError(f"{kernel} dtypes: {first} {a}, {second} {b} must match")


def check_xus_shapes(x, U, S) -> None:
    """x: ([G,] M, K), U: ([G,] K, R), S: ([G,] R, R) or None."""
    G, _, K = _batch(x)
    R = tuple(U)[-1]
    if _batch(U) != (G, K, R) or (S is not None and _batch(S) != (G, R, R)):
        raise ValueError(f"xus shapes disagree: x {tuple(x)}, U {tuple(U)}, "
                         f"S {None if S is None else tuple(S)}")


def check_avt_shapes(A, V) -> None:
    """A: ([G,] M, R), V: ([G,] N, R)."""
    G, _, R = _batch(A)
    if _batch(V) != (G, _batch(V)[1], R):
        raise ValueError(f"avt shapes disagree: A {tuple(A)}, V {tuple(V)}")


def check_atb_shapes(A, B) -> None:
    """A: ([G,] M, Ka), B: ([G,] M, Kb)."""
    G, M, _ = _batch(A)
    if _batch(B) != (G, M, _batch(B)[2]):
        raise ValueError(f"atb shapes disagree: A {tuple(A)}, B {tuple(B)}")


def grid_fits(x: int, y: int = 1, z: int = 1) -> bool:
    """A launch grid of ``x × y × z`` blocks fits the card's limits."""
    return x <= GRID_X_MAX and y <= GRID_YZ_MAX and z <= GRID_YZ_MAX
