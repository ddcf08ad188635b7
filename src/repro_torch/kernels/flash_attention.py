"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

:func:`flash_attention` is online-softmax attention with f32 accumulators,
causal and sliding-window masks from absolute positions (a negative
position marks an invalid slot), and GQA that maps query head ``h`` to KV
head ``h // (H // Hkv)``. It keeps the JAX package's layout and keyword
names (``repro.kernels.flash_attention.flash_attention``) without the TPU
tiling knobs ``bq``, ``bk`` and ``interpret``. Rows that see no key come out
as 0.

No model calls it, in either package (the models' attention is plain
tensor code); it is its own entry point. A CUDA tensor launches the kernel,
or the wrapper raises; a CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`.
``flash_attention.launches`` counts the calls that reached the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load_library
from repro_torch.kernels.lowrank_matmul import _DTYPE_CODE, _call, _check_cuda, _on_device, _stream

MAX_HEAD_DIM = 256


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
    with _on_device(q):
        _call(
            lib.lr_flash_attention, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), q_positions.data_ptr(), kv_positions.data_ptr(), out.data_ptr(),
            B, Tq, Tk, H, Hkv, d, int(bool(causal)), int(sliding_window),
            ctypes.c_float(1.0 / (d ** 0.5)), _stream(),
        )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
