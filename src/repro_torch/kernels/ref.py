"""Plain PyTorch versions of the Hopper kernels.

They follow the kernels' numerics, which are the TPU kernels' numerics:
f32 accumulation, ``S`` applied in f32 to the f32 ``x U``, one rounding to
the working type at the output. The wrappers in
:mod:`repro_torch.kernels.lowrank_matmul` use them for CPU tensors, the
tests compare them with the JAX package, and ``chip_smoke.py`` holds each
kernel to its plain version on the card. Leading batch dims broadcast.
"""
from __future__ import annotations

from typing import Optional

import torch


def xus_ref(x: torch.Tensor, U: torch.Tensor, S: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A = (x @ U) @ S.  x: (..., M, K), U: (..., K, R), S: (..., R, R) or
    None for A = x @ U (one rounding, as with S = I)."""
    xu = x.float() @ U.float()
    return (xu if S is None else xu @ S.float()).to(x.dtype)


def avt_ref(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """y = A @ Vᵀ.  A: (..., M, R), V: (..., N, R) → (..., M, N)."""
    return (A.float() @ V.float().transpose(-1, -2)).to(A.dtype)


def lowrank_matmul_ref(x, U, S, V) -> torch.Tensor:
    """y = ((x U) S) Vᵀ — the paper's client-side bottleneck chain."""
    return avt_ref(xus_ref(x, U, S), V)


def atb_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C = Aᵀ @ B, accumulated in f32 and rounded once to ``A.dtype``.
    A: (..., M, Ka), B: (..., M, Kb) → (..., Ka, Kb).

    With A = x Ũ and B = dy Ṽ this is the coefficient gradient
    ``∇_S̃ L = Ũᵀ (xᵀ dy) Ṽ``, the hot op of the client loop's backward."""
    return (A.float().transpose(-1, -2) @ B.float()).to(A.dtype)


def mha_ref(q, k, v, *, q_positions, kv_positions, causal=True, sliding_window=0):
    """Materialized-scores attention oracle (GQA via head repeat), the JAX
    package's ``repro.kernels.ref.mha_ref``. A row whose keys are all masked
    becomes the mean of V (softmax of a constant ``-1e30``), where
    :func:`flash_attention_ref` and the kernel give 0."""
    d = q.shape[-1]
    g = q.shape[2] // k.shape[2]
    kr = torch.repeat_interleave(k, g, dim=2)
    vr = torch.repeat_interleave(v, g, dim=2)
    # the JAX oracle divides by a 0-d f32 array, which promotes bf16 scores
    s = torch.einsum("bqhd,bthd->bhqt", q, kr).float() / torch.sqrt(torch.tensor(float(d)))
    m = _attention_mask(q_positions, kv_positions, causal, sliding_window)
    s = torch.where(m[None, None], s, torch.tensor(-1e30, device=s.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqt,bthd->bqhd", p, vr)


def _attention_mask(q_positions, kv_positions, causal, sliding_window):
    qp = q_positions.to(torch.int64)[:, None]
    kp = kv_positions.to(torch.int64)[None, :]
    m = (kp >= 0) & (qp >= 0)
    if causal:
        m &= kp <= qp
    if sliding_window:
        m &= kp > qp - sliding_window
    return m


def flash_attention_ref(q, k, v, *, q_positions, kv_positions, causal=True, sliding_window=0):
    """The flash kernel's function with its scores materialized.

    q: (B, Tq, H, d), k / v: (B, Tk, Hkv, d) → (B, Tq, H, d); query head h
    reads KV head ``h // (H // Hkv)``. Scores ``(q·k) · 1/√d`` in f32, masked
    to ``-1e30`` outside ``(kp ≥ 0) & (qp ≥ 0)`` [& causal ``kp ≤ qp``]
    [& window ``kp > qp − window``]; ``p = exp(s − m)`` with the row max m
    (0 for a row that sees no key) and zero where masked; ``p`` rounded to
    V's type before ``p·V`` (f32 accumulation); ``out = acc / max(l, 1e-20)``
    with ``l = Σ p`` unrounded. A row whose keys are all masked is 0.
    """
    B, Tq, H, d = q.shape
    g = H // k.shape[2]
    scale = 1.0 / (d ** 0.5)
    kr = torch.repeat_interleave(k, g, dim=2).float()
    vr = torch.repeat_interleave(v, g, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), kr) * scale
    m = _attention_mask(q_positions, kv_positions, causal, sliding_window)[None, None]
    s = torch.where(m, s, torch.tensor(-1e30, device=s.device))
    mx = torch.amax(s, dim=-1, keepdim=True)
    mx = torch.where(mx <= -5e29, torch.zeros_like(mx), mx)
    p = torch.where(m, torch.exp(s - mx), torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum("bhqt,bthd->bhqd", p.to(v.dtype).float(), vr.float())
    out = acc / torch.clamp_min(l, 1e-20)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_mismatch(out, want) -> tuple[float, float]:
    """How far the flash kernel's ``out`` is from its plain version's
    ``want``: ``(max |out − want|, worst |out − want| / tolerance)``, element
    by element; the two agree when the ratio is at most 1.

    The tolerance is 1e-4 in f32 (the same sums in another order). In bf16
    it is ``min(5e-2, 2⁻⁵ · (|want| + RMS of want's row))``, four bf16 ulps
    of the element or of its row's scale: the output rounds once to bf16
    (one ulp apart where the two f32 values straddle a rounding point), and
    the kernel rounds ``p`` against its running max where the plain version
    uses the row max, which moves an element by a few thousandths of its
    row's scale. A row of thousands of keys averages V to a small value, so
    the row's scale, not a fixed limit, is what a wrong late tile, window
    edge or score scale stands out against. A row that sees no key is 0 in
    both and has tolerance 0.
    """
    w = want.float()
    err = (out.float() - w).abs()
    if want.dtype == torch.float32:
        tol = torch.full_like(w, 1e-4)
    else:
        rms = w.square().mean(-1, keepdim=True).sqrt()
        tol = torch.clamp((w.abs() + rms) * 2.0**-5, max=5e-2)
    ratio = err / tol.clamp_min(1e-30)
    # repro-lint: disable=RPL004 -- a checker's readout for the tests and the
    # card smoke run, never called inside a step
    return err.max().item(), ratio.max().item()
