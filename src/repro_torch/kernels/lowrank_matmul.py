"""Wrappers of the Hopper kernels for the low-rank chain ``y = x U S Vᵀ``.

- :func:`xus` computes ``A = (x U) S``: f32 accumulation of ``x·U``, ``S``
  applied in f32, one rounding to ``x.dtype``. ``S=None`` gives ``A = x U``
  with one rounding (the backward's ``S = I`` products). On the card it
  takes one of two routes of ``csrc/lowrank_matmul.cu``, planned by
  :func:`xus_plan` from the shapes alone: ``"stream"`` (M ≤ 16, serving
  decode: one launch that streams U and finishes in its last block) or
  ``"tiled"`` (larger M, training: a split-precision tensor-core product,
  and a second launch of it that applies S).
- :func:`avt` computes ``y = A Vᵀ``: f32 accumulation, one rounding to
  ``A.dtype``. It takes one of two routes, each one launch, planned by
  :func:`avt_plan` from the shapes alone: ``"stream"`` (M ≤ 16, decode:
  warps that stream their rows of V with 16-byte loads) or ``"tiled"``
  (larger M: a split-precision tensor-core product).

Both take 2-D operands or operands with one leading batch dim (stacked
factors), which the kernels run as a grid axis. A CUDA tensor launches the
kernel, or the wrapper raises; a CPU tensor takes the plain version in
:mod:`repro_torch.kernels.ref`. Each wrapper counts its launches in a plain
integer attribute (``xus.launches``, ``avt.launches``): one per call that
reached the card, whatever number of device kernels the call runs.

On fake tensors (``torch._subclasses.FakeTensorMode``: the multi-card dry
run, :mod:`repro_torch.launch.dryrun`) the wrappers call the custom ops
``repro_torch::xus`` / ``repro_torch::avt`` instead, which give the output's
shape and a FLOP count (``torch.utils.flop_counter``) without a launch;
:func:`record_shapes` collects the local shapes those calls took. Real
tensors never take that route: its dispatch would add an operator to every
call.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import constraints, ref
from repro_torch.kernels.build import load_library
from repro_torch.kernels.constraints import COUNTER_INTS, GRID_X_MAX, GRID_YZ_MAX, grid_fits

_DTYPE_CODE = {getattr(torch, name): code for name, code in constraints.DTYPE_CODES.items()}


def _batched(t: torch.Tensor, name: str) -> torch.Tensor:
    constraints.check_stack_dims(name, t.shape)
    return t.unsqueeze(0) if t.dim() == 2 else t


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    constraints.check_operands(name, [t.device for t in tensors],
                               [t.is_contiguous() for t in tensors], tensors[0].dtype)


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


#: route codes of ``lr_xus`` and ``lr_avt`` (``csrc/lowrank_matmul.cu``)
ROUTES = {"stream": 0, "tiled": 1}
#: the stream routes: rows of x (of A) they take; xus's rank columns per
#: block, and K per split: at least, and at most with up to 4 rows and with
#: up to 16 (a block stages its split's x rows in 32 KB of shared memory)
STREAM_MAX_M = 16
STREAM_COLS = 64
STREAM_KC = (256, 1024, 512)
#: the tiled route: block tile (rows, columns, K step), K per split at
#: least, and the blocks its K splits aim at (about 1.5 waves of an H100's
#: 132 SMs: an llm-100m round was fastest near there, PERF.md)
TILE_M, TILE_N, TILE_K = 64, 32, 32
TILED_KC_MIN = 64
TILED_BLOCKS = 200
#: blocks in one wave: one per SM of an H100. Constants, so a plan depends
#: on the shapes alone and not on the card it runs on.
WAVE = 132
#: avt's stream route: elements of a row of V a lane takes a pass (16 bytes
#: of bf16, 32 of f32), rows of V a lane group owns and warps a block (on
#: the card 4 rows beat 8 and 4 warps beat 8 at every decode shape)
AVT_ELEMS = 8
AVT_ROWS = 4
AVT_WARPS = 4
#: rows of A a block of avt's stream route takes at M > 1 (more rows are
#: more blocks, which read the same rows of V together)
AVT_M_BLOCK = 4


class XusPlan(NamedTuple):
    """How one ``xus`` call runs on the card (see :func:`xus_plan`)."""

    route: str       # "stream" or "tiled"
    splits: int      # K splits
    kc: int          # K per split (the last split may be shorter)
    kc_s: int        # R per split of the tiled route's S pass (R otherwise)
    launches: int    # device kernels the call launches
    workspace: int   # f32 elements of scratch
    counters: int    # ticket counters (0: none)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def xus_plan(G: int, M: int, K: int, R: int, has_s: bool) -> XusPlan:
    """Route, K splits, launches, workspace and counters of ``xus`` on
    ``G`` stacked ``(M, K) · (K, R)`` products, with or without ``S``.

    - ``"stream"`` for ``M ≤ 16`` (decode): bound by U's bytes. One launch
      of ``R / 64`` column tiles × splits × G blocks, the splits sized for
      about one block per SM (K per split a multiple of 32, 256 to 1024
      at M ≤ 4 and to 512 at M ≤ 16: fewer, longer splits cost the blocks
      no extra round trip to memory and shorten the last block's sum). Its
      workspace holds each split's partial and, with S and more than one
      column tile, each tile's product with S, in f64 (two f32 elements
      each).
    - ``"tiled"`` otherwise (training at M = 512): bound by f32 operations.
      K is split only while the 64 × 32 tile grid is under about 1.5
      waves (K per split a multiple of 32, at least 64); the splits' f32
      partials sit in the workspace and the last block of each tile adds
      them (a ticket counter per tile). One launch without S; with S a
      second launch of the same kernel multiplies the f32 x·U the first
      leaves in the workspace by S, its R split the same way.
    """
    if min(G, M, K, R) < 1:
        raise ValueError(f"xus_plan: sizes must be positive, got G={G} M={M} K={K} R={R}")
    ctiles = _cdiv(R, STREAM_COLS)
    if M <= STREAM_MAX_M and G * (ctiles + 1) <= COUNTER_INTS and grid_fits(1, 1, G):
        want = max(1, _cdiv(WAVE, G * ctiles))
        lo, hi4, hi16 = STREAM_KC
        kc = min(hi4 if M <= 4 else hi16, max(lo, _cdiv(_cdiv(K, want), 32) * 32))
        splits = _cdiv(K, kc)
        if grid_fits(1, splits):
            # f64 partials, and f64 products of the column tiles with S
            work = 2 * (G * splits * M * R + (G * ctiles * M * R if has_s and ctiles > 1 else 0))
            return XusPlan("stream", splits, kc, R, 1, work, G * (ctiles + 1))
    tiles = G * _cdiv(M, TILE_M) * _cdiv(R, TILE_N)

    def split(k: int) -> int:
        kc = _cdiv(k, TILE_K) * TILE_K
        if tiles < TILED_BLOCKS:
            want = _cdiv(TILED_BLOCKS, tiles)
            kc = min(kc, max(TILED_KC_MIN, _cdiv(_cdiv(k, want), TILE_K) * TILE_K))
        return kc

    kc, kc_s = split(K), split(R) if has_s else R
    splits, splits_s = _cdiv(K, kc), _cdiv(R, kc_s)
    if not grid_fits(1, _cdiv(M, TILE_M), G * max(splits, splits_s)):
        raise ValueError(f"xus: grid too large for G={G} M={M} K={K} R={R}")
    per_g = M * R
    work = (G * per_g if has_s else 0) + sum(G * n * per_g for n in (splits, splits_s) if n > 1)
    counters = 2 * tiles if max(splits, splits_s) > 1 else 0
    return XusPlan("tiled", splits, kc, kc_s, 2 if has_s else 1, work, counters)


class _Counters:
    """Ticket counters of ``xus`` and ``atb`` on one card: a pool of zeroed
    slots of :data:`COUNTER_INTS`, each call's kernel leaves its counters
    at 0 again. A stream keeps one slot, so calls on two streams never
    share one; a graph capture takes a slot of its own (cycling over the
    slots no stream holds), so graphs captured on one stream and replayed
    on two do not share one either unless the pool has wrapped since."""

    SLOTS = 64

    def __init__(self, device: torch.device):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "xus/atb: the first call that takes ticket counters on a card must not be inside "
                "a CUDA graph capture (its counter pool is zeroed then)"
            )
        self.pool = torch.zeros((self.SLOTS, COUNTER_INTS), dtype=torch.int32, device=device)
        torch.cuda.synchronize(device)  # zeroed before any stream uses it
        self.base = self.pool.data_ptr()
        self.by_stream: dict = {}
        self.by_capture: dict = {}
        self.turn = 0

    def slot(self, stream: int) -> int:
        if not torch.cuda.is_current_stream_capturing():
            i = self.by_stream.get(stream)
            if i is None:
                held = set(self.by_stream.values())
                free = [j for j in range(self.SLOTS) if j not in held]
                if len(free) < 2:
                    raise RuntimeError(f"xus/atb: more than {self.SLOTS - 2} streams in use")
                i = self.by_stream[stream] = free[0]
            return self.base + 4 * COUNTER_INTS * i
        key = (stream, load_library().lr_capture_id(stream))
        i = self.by_capture.get(key)
        if i is None:
            held = set(self.by_stream.values())
            free = [j for j in range(self.SLOTS - 1, -1, -1) if j not in held]
            i = self.by_capture[key] = free[self.turn % len(free)]
            self.turn += 1
        return self.base + 4 * COUNTER_INTS * i


_COUNTERS: dict = {}


def _counter_slot(device: torch.device, stream: int) -> int:
    c = _COUNTERS.get(device.index)
    if c is None:
        c = _COUNTERS[device.index] = _Counters(device)
    return c.slot(stream)


def xus(x: torch.Tensor, U: torch.Tensor, S: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A = (x @ U) @ S.  x: ([G,] M, K), U: ([G,] K, R), S: ([G,] R, R) or
    None for A = x @ U."""
    if isinstance(x, FakeTensor):
        _record("xus", x, U.shape[-2], U.shape[-1], S)
        return torch.ops.repro_torch.xus(x, U, S)
    return _xus(x, U, S)


def _xus(x: torch.Tensor, U: torch.Tensor, S: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.xus_ref(x, U, S)
    if x.device.type != "cuda":
        raise ValueError(f"xus runs on cuda or cpu tensors, got {x.device}")
    x3, U3 = _batched(x, "x"), _batched(U, "U")
    S3 = None if S is None else _batched(S, "S")
    G, M, K = x3.shape
    R = U3.shape[-1]
    constraints.check_xus_shapes(x.shape, U.shape, None if S is None else S.shape)
    _check_cuda("xus", x3, U3, *(() if S3 is None else (S3,)))
    s_dtype = x3.dtype if S3 is None else S3.dtype
    constraints.check_xus_dtypes(x.dtype, U.dtype, s_dtype)
    lib = load_library()
    plan = xus_plan(G, M, K, R, S3 is not None)
    out = torch.empty((G, M, R), dtype=x.dtype, device=x.device)
    work = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    # 16-byte loads where the rows are whole vectors and the data is
    # aligned: of U (stream route), of x and U (bit 0) and of x·U and S
    # (bit 1, its f32 x·U rows whole vectors too) on the tiled route
    v = 16 // x3.element_size()
    xp, up, sp = x3.data_ptr(), U3.data_ptr(), None if S3 is None else S3.data_ptr()
    if plan.route == "stream":
        vec = int(R % v == 0 and up % 16 == 0)
    else:
        vec = int(K % v == 0 and R % v == 0 and xp % 16 == 0 and up % 16 == 0)
        if sp is not None and R % max(v, 16 // S3.element_size()) == 0 and sp % 16 == 0:
            vec |= 2
    with _on_device(x):
        stream = torch.cuda.current_stream().cuda_stream
        counters = _counter_slot(x.device, stream) if plan.counters else None
        _call(
            lib.lr_xus, _DTYPE_CODE[x3.dtype], _DTYPE_CODE[s_dtype], xp, up, sp,
            out.data_ptr(), work.data_ptr(), plan.workspace, counters, G, M, K, R,
            ROUTES[plan.route], plan.kc, plan.kc_s, vec, ctypes.c_void_p(stream),
        )
    xus.launches += 1
    return out if x.dim() == 3 else out[0]


class AvtPlan(NamedTuple):
    """How one ``avt`` call runs on the card (see :func:`avt_plan`)."""

    route: str                        # "stream" or "tiled"
    rows: int                         # stream: rows of V a warp owns (0: tiled)
    warps: int                        # stream: warps a block (0: tiled)
    tile: Optional[Tuple[int, int]]   # tiled: a block's tile of y, (M, N) (None: stream)
    launches: int                     # device kernels the call launches
    workspace: int                    # f32 elements of scratch
    counters: int                     # ticket counters (0: none)


def _avt_lanes(R: int) -> int:
    """Lanes that share a row of V on the stream route: the power of two
    that covers the row's ``R / 8`` lane pieces, at most a warp."""
    return min(32, 1 << (_cdiv(R, AVT_ELEMS) - 1).bit_length())


@functools.lru_cache(maxsize=1024)
def avt_plan(G: int, M: int, N: int, R: int) -> AvtPlan:
    """Route and sizes of ``avt`` on ``G`` stacked ``(M, R) · (N, R)ᵀ``
    products: one launch at every shape, no workspace, no counters (the
    contraction is the rank, which neither route splits).

    - ``"stream"`` for ``M ≤ 16`` (decode): bound by V's bytes. A group of
      :func:`_avt_lanes` lanes reads a row of V in 16-byte pieces, a warp
      has ``32 / lanes`` groups of :data:`AVT_ROWS` rows each, and a block
      :data:`AVT_WARPS` warps and :data:`AVT_M_BLOCK` rows of A (1 at
      M = 1).
    - ``"tiled"`` otherwise (training at M = 512, prefill): bound by f32
      operations. 64 × 32 tiles of y, a 3xTF32 tensor-core product over R.
    The plan reads constants and the shapes, never the card, so the
    summation order (and the bits) depend on the shapes alone.
    """
    if min(G, M, N, R) < 1:
        raise ValueError(f"avt_plan: sizes must be positive, got G={G} M={M} N={N} R={R}")
    if M <= STREAM_MAX_M:
        rows, warps = AVT_ROWS * (32 // _avt_lanes(R)), AVT_WARPS
        blocks = _cdiv(N, rows * warps) * _cdiv(M, 1 if M == 1 else AVT_M_BLOCK)
        if not grid_fits(blocks, 1, G):
            raise ValueError(f"avt: grid too large for G={G} M={M} N={N} R={R}: {blocks} x {G} "
                             f"blocks; at most {GRID_X_MAX} x {GRID_YZ_MAX}")
        return AvtPlan("stream", rows, warps, None, 1, 0, 0)
    tiles = (_cdiv(N, TILE_N), _cdiv(M, TILE_M))
    if not grid_fits(tiles[0], tiles[1], G):
        raise ValueError(f"avt: grid too large for G={G} M={M} N={N} R={R}: {tiles[0]} x "
                         f"{tiles[1]} x {G} tiles; at most {GRID_X_MAX} x {GRID_YZ_MAX} x "
                         f"{GRID_YZ_MAX}")
    return AvtPlan("tiled", 0, 0, (TILE_M, TILE_N), 1, 0, 0)


def avt(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """y = A @ Vᵀ.  A: ([G,] M, R), V: ([G,] N, R) → ([G,] M, N)."""
    if isinstance(A, FakeTensor):
        _record("avt", A, V.shape[-2], V.shape[-1])
        return torch.ops.repro_torch.avt(A, V)
    return _avt(A, V)


def _avt(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    if A.device.type == "cpu":
        return ref.avt_ref(A, V)
    if A.device.type != "cuda":
        raise ValueError(f"avt runs on cuda or cpu tensors, got {A.device}")
    A3, V3 = _batched(A, "A"), _batched(V, "V")
    G, M, R = A3.shape
    N = V3.shape[1]
    constraints.check_avt_shapes(A.shape, V.shape)
    _check_cuda("avt", A3, V3)
    constraints.check_pair_dtypes("avt", "AV", A.dtype, V.dtype)
    lib = load_library()
    plan = avt_plan(G, M, N, R)
    sizes = (plan.rows, plan.warps) if plan.route == "stream" else plan.tile
    y = torch.empty((G, M, N), dtype=A.dtype, device=A.device)
    # 16-byte loads where the rows are whole vectors and the data is aligned
    ap, vp = A3.data_ptr(), V3.data_ptr()
    vec = int(R % (16 // A3.element_size()) == 0 and ap % 16 == 0 and vp % 16 == 0)
    with _on_device(A):
        _call(
            lib.lr_avt, _DTYPE_CODE[A3.dtype], ap, vp, y.data_ptr(), G, M, N, R,
            ROUTES[plan.route], *sizes, vec, _stream(),
        )
    avt.launches += 1
    return y if A.dim() == 3 else y[0]


xus.launches = 0
avt.launches = 0


# ---------------------------------------------------------------------------
# the traced route: custom ops with a fake implementation and a FLOP count
# ---------------------------------------------------------------------------

#: the list :func:`record_shapes` fills, or None
_SHAPES: Optional[list] = None


@contextlib.contextmanager
def record_shapes():
    """Collect ``(kernel, dtype, M, K or N, R, G, S's dtype)`` for every
    traced call of ``xus`` / ``avt`` / ``atb`` (``atb``: ``(atb, dtype, M,
    Ka, Kb, G, None)``; S's dtype None also for ``xus`` without S) made
    inside the block; yields the list."""
    global _SHAPES
    prev, _SHAPES = _SHAPES, []
    try:
        yield _SHAPES
    finally:
        _SHAPES = prev


def _record(kernel: str, a: torch.Tensor, k: int, r: int, s=None) -> None:
    if _SHAPES is not None:
        G = a.shape[0] if a.dim() == 3 else 1
        _SHAPES.append((kernel, str(a.dtype).replace("torch.", ""), a.shape[-2], k, r, G,
                        None if s is None else str(s.dtype).replace("torch.", "")))


@torch.library.custom_op("repro_torch::xus", mutates_args=())
def _xus_op(x: torch.Tensor, U: torch.Tensor, S: Optional[torch.Tensor]) -> torch.Tensor:
    return _xus(x, U, S)


@_xus_op.register_fake
def _(x, U, S):
    return x.new_empty(tuple(x.shape[:-1]) + (U.shape[-1],))


@torch.library.custom_op("repro_torch::avt", mutates_args=())
def _avt_op(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    return _avt(A, V)


@_avt_op.register_fake
def _(A, V):
    return A.new_empty(tuple(A.shape[:-1]) + (V.shape[-2],))


@register_flop_formula(torch.ops.repro_torch.xus)
def _xus_flops(x_shape, U_shape, S_shape, *args, out_shape=None, **kwargs) -> int:
    G = x_shape[0] if len(x_shape) == 3 else 1
    M, K, R = x_shape[-2], x_shape[-1], U_shape[-1]
    return 2 * G * M * K * R + (0 if S_shape is None else 2 * G * M * R * R)


@register_flop_formula(torch.ops.repro_torch.avt)
def _avt_flops(A_shape, V_shape, *args, out_shape=None, **kwargs) -> int:
    G = A_shape[0] if len(A_shape) == 3 else 1
    return 2 * G * A_shape[-2] * A_shape[-1] * V_shape[-2]
