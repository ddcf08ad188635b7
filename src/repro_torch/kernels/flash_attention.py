"""Wrapper of the Hopper flash-attention kernels (``csrc/flash_attention.cu``).

:func:`flash_attention` is online-softmax attention with f32 accumulators,
causal and sliding-window masks from absolute positions (a negative
position marks an invalid slot), and GQA that maps query head ``h`` to KV
head ``h // (H // Hkv)``. It keeps the JAX package's layout and keyword
names (``repro.kernels.flash_attention.flash_attention``, whose Pallas body
``_flash_kernel`` it replaces) without the TPU tiling knobs ``bq``, ``bk``
and ``interpret``. Rows that see no key come out as 0.

The card runs one of two kernels, chosen by dtype:

- bfloat16, ``tensor-core bf16``: both products on tensor cores
  (``mma.sync`` m16n8k16, ``ldmatrix``, ``cp.async`` into a two-stage ring
  of 64-key tiles). Prefill is bound by operations: the kernel keeps Q in
  registers and P out of shared memory, and skips key tiles that no row of
  a block sees. Decode is bound by bytes: GQA row packing (one K/V tile
  read for all ``H / Hkv`` heads of its KV head) and, when the grid is too
  small for the card, a split of the key range (:func:`flash_splits`)
  merged by a second launch in fixed order, so the result is deterministic.
- float32, ``cuda-core f32``: f32 FMAs from shared memory. TF32 tensor
  cores would keep about three digits and break the 1e-4 f32 tolerance.

No model calls it, in either package (the models' attention is plain
tensor code); it is its own entry point. A CUDA tensor launches the kernel,
or the wrapper raises; a CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`.
``flash_attention.launches`` counts the calls that reached the card: one
per call, which launches one kernel, or two with a split.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load_library
from repro_torch.kernels.lowrank_matmul import _DTYPE_CODE, _call, _check_cuda, _on_device, _stream

MAX_HEAD_DIM = 256
#: packed (query, head) rows per block of the bf16 kernel
FLASH_ROWS = 64
#: key granularity of a split: the bf16 kernel's key tile (two at d = 256)
FLASH_KEY_TILE = 64
#: streaming multiprocessors of an H100 SXM, which the split fills
CARD_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flash_splits(B: int, Tq: int, Tk: int, H: int, Hkv: int) -> int:
    """Key-range splits of the bf16 kernel, from the shapes alone.

    1 when the grid ``cdiv(Tq·g, 64)·B·Hkv`` (``g = H / Hkv``) already has
    :data:`CARD_SMS` blocks. Else whole key tiles per split for about two
    blocks per SM (within one wave at the kernel's occupancy), at least one
    block per SM where there are enough tiles; every split is non-empty.
    """
    blocks = _cdiv(Tq * (H // Hkv), FLASH_ROWS) * B * Hkv
    if blocks >= CARD_SMS:
        return 1
    tiles = _cdiv(Tk, FLASH_KEY_TILE)
    return _cdiv(tiles, _cdiv(tiles, _cdiv(2 * CARD_SMS, blocks)))


def flash_split_keys(Tk: int, splits: int) -> int:
    """Keys per split (a multiple of the key tile); the last split holds
    the rest of ``Tk``."""
    return FLASH_KEY_TILE * _cdiv(_cdiv(Tk, FLASH_KEY_TILE), splits)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, sliding_window: int = 0) -> torch.Tensor:
    """q: (B, Tq, H, d); k / v: (B, Tk, Hkv, d) → (B, Tq, H, d)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention takes (B, T, heads, d) tensors, got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    B, Tq, H, d = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Tk, Hkv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if H % Hkv:
        raise ValueError(f"query heads ({H}) must be a multiple of KV heads ({Hkv})")
    if q_positions.shape != (Tq,) or kv_positions.shape != (Tk,):
        raise ValueError(
            f"positions must be ({Tq},) and ({Tk},), got {tuple(q_positions.shape)} "
            f"and {tuple(kv_positions.shape)}"
        )
    if sliding_window < 0:
        raise ValueError(f"sliding_window must be >= 0, got {sliding_window}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(
            q, k, v, q_positions=q_positions, kv_positions=kv_positions,
            causal=causal, sliding_window=sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    _check_cuda("flash_attention", q, k, v, q_positions, kv_positions)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention dtypes: q {q.dtype}, k {k.dtype}, v {v.dtype} must match")
    for name, p in (("q_positions", q_positions), ("kv_positions", kv_positions)):
        if p.dtype != torch.int32:
            raise TypeError(f"flash_attention: {name} must be int32, got {p.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims up to {MAX_HEAD_DIM}, got {d}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B * H = {B * H} exceeds the grid's 65535")
    lib = load_library()
    out = torch.empty_like(q)
    splits = flash_splits(B, Tq, Tk, H, Hkv) if q.dtype == torch.bfloat16 else 1
    part_ml = part_acc = None
    if splits > 1:  # per split and packed row: (m, l), then the f32 accumulators
        rows = splits * B * Tq * H
        part = torch.empty(rows * (2 + d), dtype=torch.float32, device=q.device)
        part_ml = part.data_ptr()
        part_acc = part_ml + 2 * rows * part.element_size()
    with _on_device(q):
        _call(
            lib.lr_flash_attention, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), q_positions.data_ptr(), kv_positions.data_ptr(), out.data_ptr(),
            part_ml, part_acc,
            B, Tq, Tk, H, Hkv, d, int(bool(causal)), int(sliding_window),
            ctypes.c_float(1.0 / (d ** 0.5)), splits, flash_split_keys(Tk, splits), _stream(),
        )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
