"""The port's flash attention against the JAX package's Pallas kernel.

Same inputs, made with numpy from a seed, go through the JAX package's
``flash_attention(..., interpret=True)`` (the Pallas kernel run by its
interpreter on the CPU, as ``tests/test_flash_attention.py`` runs it) and
the port's ``flash_attention``, which on CPU tensors takes its plain version
``flash_attention_ref``, on every case of that file: the five oracle cases,
three tilings, the poisoned ring cache, bf16, and fully masked rows.

Tolerances: atol 2e-5 in f32 (the same sums in another order) and 5e-2 in
bf16 (the kernel rounds p to bf16 against the running max, the plain
version against the row max); fully masked rows are exactly 0 in both.
The kernels themselves run only on a card: the ``cuda``-marked tests
(``pytest -m cuda``), which hold them to the plain version (head dims,
GQA row packing, split key ranges), their two staging paths to each other
and a second call to the first, skip here. ``flash_splits``, which plans
the split of the key range from the shapes alone, is checked here.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import mha_ref as jax_mha_ref
from repro_torch.kernels import flash_attention
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    CARD_SMS, FLASH_KEY_TILE, FLASH_ROWS, flash_split_keys, flash_splits,
)

F32_ATOL = 2e-5
BF16_ATOL = 5e-2


def _qkv(B, Tq, Tk, H, Hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, Tq, H, d), (B, Tk, Hkv, d), (B, Tk, Hkv, d))
    )


def _both(q, k, v, qpos, kpos, *, dtype="float32", **kw):
    """(JAX Pallas-interpret output, port output) as f32 numpy."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    bq, bk = kw.pop("bq", 8), kw.pop("bk", 8)
    want = jax_flash(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        q_positions=jnp.asarray(qpos, jnp.int32), kv_positions=jnp.asarray(kpos, jnp.int32),
        bq=bq, bk=bk, interpret=True, **kw,
    )
    got = flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        q_positions=torch.from_numpy(np.asarray(qpos, np.int32)),
        kv_positions=torch.from_numpy(np.asarray(kpos, np.int32)), **kw,
    )
    assert got.dtype == tdt and got.shape == q.shape
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize(
    "B,Tq,Tk,H,Hkv,d,causal,window",
    [
        (2, 16, 16, 4, 2, 8, True, 0),     # GQA self-attn
        (1, 32, 32, 2, 2, 16, True, 8),    # sliding window
        (2, 8, 24, 4, 4, 8, False, 0),     # cross-attention, Tq != Tk
        (1, 16, 16, 4, 1, 8, True, 0),     # MQA
        (1, 64, 64, 2, 2, 32, True, 0),    # bigger tiles
    ],
)
def test_flash_matches_jax_kernel(B, Tq, Tk, H, Hkv, d, causal, window):
    q, k, v = _qkv(B, Tq, Tk, H, Hkv, d, seed=B * Tq + H)
    qpos = np.arange(Tq) + (Tk - Tq if causal else 0)
    kpos = np.arange(Tk)
    want, got = _both(q, k, v, qpos, kpos, causal=causal, sliding_window=window)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("bq,bk", [(4, 4), (8, 16), (16, 8)])
def test_flash_matches_jax_kernel_at_every_tiling(bq, bk):
    q, k, v = _qkv(1, 16, 32, 2, 2, 8, seed=3)
    want, got = _both(q, k, v, np.arange(16) + 16, np.arange(32), bq=bq, bk=bk)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


def test_flash_ring_cache_layout():
    """Invalid (negative-position) slots and wrapped order: poisoning the
    invalid slots of K and V with 1e6 changes nothing."""
    q, k, v = _qkv(1, 4, 16, 2, 2, 8, seed=5)
    kpos = np.array([8, 9, 10, 11, 12, 13, 14, 15] + [-(10**9)] * 8)
    qpos = np.arange(4) + 12
    want, got = _both(q, k, v, qpos, kpos, bq=4)
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[:, 8:] = 1e6
    v_bad[:, 8:] = 1e6
    want_bad, got_bad = _both(q, k_bad, v_bad, qpos, kpos, bq=4)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    np.testing.assert_allclose(got_bad, want_bad, atol=F32_ATOL)
    np.testing.assert_array_equal(got_bad, got)


def test_flash_bf16():
    q, k, v = _qkv(1, 16, 16, 2, 2, 16, seed=7)
    want, got = _both(q, k, v, np.arange(16), np.arange(16), dtype="bfloat16")
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)


def test_flash_fully_masked_rows_are_zero():
    """Rows with no visible key are exactly 0 in both packages; the other
    rows of the same call still agree."""
    q, k, v = _qkv(1, 8, 8, 1, 1, 8, seed=9)
    want, got = _both(q, k, v, np.arange(8), np.full((8,), -(10**9)))
    assert np.all(want == 0.0) and np.all(got == 0.0)
    # half the query rows invalid, the rest see keys
    qpos = np.array([-1, -1, -1, -1, 4, 5, 6, 7])
    want, got = _both(q, k, v, qpos, np.arange(8))
    assert np.all(got[:, :4] == 0.0) and np.all(want[:, :4] == 0.0)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 5e-2)])
def test_mha_ref_matches_jax(dtype, atol):
    """The port's copy of the oracle, on rows that see at least one key
    (where mha_ref and the kernel agree)."""
    q, k, v = _qkv(2, 12, 20, 4, 2, 16, seed=11)
    qpos, kpos = np.arange(12) + 8, np.arange(20)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        want = jax_mha_ref(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                           q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
                           causal=causal, sliding_window=window)
        got = ref.mha_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kpos),
                          causal=causal, sliding_window=window)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)
        plain = ref.flash_attention_ref(
            *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
            q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kpos),
            causal=causal, sliding_window=window)
        np.testing.assert_allclose(plain.float().numpy(), got.float().numpy(), atol=atol)


def test_flash_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 4, 3, 2, 8, seed=1))
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        flash_attention(q, k, v, q_positions=pos, kv_positions=pos)
    q = q[:, :, :2].contiguous()
    with pytest.raises(ValueError, match="positions"):
        flash_attention(q, k, v, q_positions=pos[:3], kv_positions=pos)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                        q_positions=pos.to("meta"), kv_positions=pos.to("meta"))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")


def _card_inputs(B, Tq, Tk, H, Hkv, d, dtype, *, seed, invalid_tail=0, poison=False):
    q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in _qkv(B, Tq, Tk, H, Hkv, d, seed))
    qpos = torch.arange(Tq, device="cuda", dtype=torch.int32) + (Tk - Tq)
    kpos = torch.arange(Tk, device="cuda", dtype=torch.int32)
    if invalid_tail:
        kpos[Tk - invalid_tail:] = -(10**9)
        if poison:  # invalid slots must not reach the sums, not even as 0 * x
            k[:, Tk - invalid_tail:] = 1e6
            v[:, Tk - invalid_tail:] = 1e6
    return q, k, v, qpos, kpos


@pytest.mark.cuda
def test_flash_kernel_matches_plain_version_on_card():
    """Runs on an H100 (``pytest -m cuda``): the kernel against its plain
    version (``ref.flash_mismatch``: 1e-4 in f32, scaled to each row in
    bf16) over head dims 8-256, ragged ``Tq``/``Tk``, GQA and MQA (packed
    rows of 3, 7 and 8 heads), sliding windows, decode against a cache
    (split key ranges, one of them all invalid), a poisoned ring cache and
    rows that see no key, in f32 and bf16."""
    _needs_card()
    cases = [  # B, Tq, Tk, H, Hkv, d, causal, window, invalid tail, poison
        *[(2, 37, 53, 4, 2, d, c, 0, 0, False)
          for d in (8, 16, 32, 64, 100, 128, 256) for c in (True, False)],
        (1, 1, 300, 8, 2, 128, True, 0, 40, False),
        (1, 70, 70, 4, 4, 256, True, 16, 0, False),
        (1, 16, 16, 4, 1, 8, True, 5, 0, False),
        (2, 9, 33, 2, 1, 8, False, 0, 5, False),
        (1, 4, 16, 2, 2, 8, True, 0, 8, True),
        (1, 8, 8, 1, 1, 8, True, 0, 8, False),  # no key visible: all 0
        # GQA row packing: g = 7, 3 and 8 (MQA), Tq * g not a multiple of 64
        (1, 37, 100, 21, 3, 128, True, 0, 0, False),
        (2, 30, 90, 6, 2, 64, True, 0, 0, False),
        (1, 50, 77, 8, 1, 128, True, 0, 0, False),
        (1, 20, 130, 8, 1, 256, False, 24, 0, False),
        # split-KV decode: Tk not a multiple of the split; the last splits'
        # keys all invalid (and poisoned); a window across splits
        (4, 1, 1000, 28, 4, 128, True, 0, 0, False),
        (2, 1, 1000, 8, 2, 128, True, 0, 200, True),
        (1, 2, 600, 4, 4, 64, True, 100, 0, False),
    ]
    split = [c for c in cases if flash_splits(*c[:5]) > 1]
    assert len(split) >= 4 and any(c[2] % flash_split_keys(c[2], flash_splits(*c[:5]))
                                   for c in split)
    for dtype in (torch.float32, torch.bfloat16):
        for B, Tq, Tk, H, Hkv, d, causal, window, tail, poison in cases:
            q, k, v, qpos, kpos = _card_inputs(B, Tq, Tk, H, Hkv, d, dtype, seed=Tq + d,
                                               invalid_tail=tail, poison=poison)
            kw = dict(q_positions=qpos, kv_positions=kpos, causal=causal, sliding_window=window)
            before = flash_attention.launches
            out = flash_attention(q, k, v, **kw)
            assert flash_attention.launches == before + 1
            assert bool(torch.isfinite(out).all())
            err, ratio = ref.flash_mismatch(out, ref.flash_attention_ref(q, k, v, **kw))
            assert ratio <= 1.0, (dtype, B, Tq, Tk, H, Hkv, d, causal, window, tail, err, ratio)


def _off_boundary(t: torch.Tensor) -> torch.Tensor:
    """The same values, contiguous, one element off a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_staging_paths_give_the_same_bits_on_card(dtype):
    """Runs on an H100: the kernel stages Q, K and V with 16-byte loads
    where the rows are aligned and element by element where they are not;
    inputs one element off a 16-byte boundary take the element path, which
    must give the same bits."""
    _needs_card()
    for B, Tq, Tk, H, Hkv, d in ((1, 300, 300, 4, 2, 128), (2, 1, 700, 8, 2, 128),
                                 (1, 45, 77, 2, 1, 64)):
        q, k, v, qpos, kpos = _card_inputs(B, Tq, Tk, H, Hkv, d, dtype, seed=Tk, invalid_tail=5)
        kw = dict(q_positions=qpos, kv_positions=kpos)
        a = flash_attention(q, k, v, **kw)
        b = flash_attention(*(_off_boundary(t) for t in (q, k, v)), **kw)
        assert torch.equal(a, b), (dtype, B, Tq, Tk, H, Hkv, d)


@pytest.mark.cuda
def test_flash_kernel_gives_the_same_bits_twice_on_card():
    """Runs on an H100: two calls on the same inputs give the same bits,
    with a split key range (merged in fixed order) and without."""
    _needs_card()
    for B, Tq, Tk, H, Hkv, d in ((4, 1, 4096, 28, 4, 128), (1, 300, 300, 28, 4, 128)):
        q, k, v, qpos, kpos = _card_inputs(B, Tq, Tk, H, Hkv, d, torch.bfloat16, seed=Tq,
                                           invalid_tail=Tk // 8)
        kw = dict(q_positions=qpos, kv_positions=kpos)
        a = flash_attention(q, k, v, **kw)
        b = flash_attention(q, k, v, **kw)
        assert torch.equal(a, b), (B, Tq, Tk, H, Hkv, d, flash_splits(B, Tq, Tk, H, Hkv))


def _chip_smoke_flash_cases():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLASH_CASES


def test_flash_splits_cover_the_keys_and_fill_the_card():
    """``flash_splits`` is >= 1; every split is non-empty and whole key
    tiles but the last; the prefill cases of ``chip_smoke.FLASH_CASES`` get
    one split, the Qwen2-7B decode case enough blocks for every SM."""
    for B in (1, 2, 4, 16):
        for Tq in (1, 2, 7, 64, 300, 4096):
            for Tk in (1, 63, 64, 65, 300, 1000, 4096, 100_000):
                for H, Hkv in ((28, 4), (32, 8), (8, 1), (4, 4), (21, 3)):
                    splits = flash_splits(B, Tq, Tk, H, Hkv)
                    assert splits >= 1
                    keys = flash_split_keys(Tk, splits)
                    assert keys % FLASH_KEY_TILE == 0
                    bounds = [(i * keys, min(Tk, (i + 1) * keys)) for i in range(splits)]
                    assert all(lo < hi for lo, hi in bounds), (B, Tq, Tk, H, Hkv, splits)
                    assert bounds[-1][1] == Tk
                    blocks = -(-Tq * (H // Hkv) // FLASH_ROWS) * B * Hkv
                    if blocks >= CARD_SMS:
                        assert splits == 1
    cases = {c[0]: c for c in _chip_smoke_flash_cases()}
    for name in ("qwen2-7b prefill", "mistral-7b window 4096"):
        _, B, Tq, Tk, H, Hkv = cases[name][:6]
        assert flash_splits(B, Tq, Tk, H, Hkv) == 1, name
    _, B, Tq, Tk, H, Hkv = cases["qwen2-7b decode vs cache"][:6]
    splits = flash_splits(B, Tq, Tk, H, Hkv)
    assert splits > 1
    assert -(-Tq * (H // Hkv) // FLASH_ROWS) * B * Hkv * splits >= CARD_SMS


def test_flash_mismatch_scales_the_bf16_tolerance_to_the_row():
    """``ref.flash_mismatch``, the rule the card checks use: in bf16 a row
    averaged over thousands of keys is small, so 32 of its 2048 keys
    dropped stays under a 5e-2 max-abs limit yet is rejected against the
    row's scale; the plain version against itself, and rows that see no
    key (0 in both), pass with ratio 0; f32 holds to 1e-4."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 1, 2048, 4, 1, 64, seed=13))
    qpos, kpos = torch.tensor([2047], dtype=torch.int32), torch.arange(2048, dtype=torch.int32)
    want = ref.flash_attention_ref(q, k, v, q_positions=qpos, kv_positions=kpos)
    assert ref.flash_mismatch(want, want) == (0.0, 0.0)
    dropped = kpos.clone()
    dropped[1024:1056] = -1
    got = ref.flash_attention_ref(q, k, v, q_positions=qpos, kv_positions=dropped)
    err, ratio = ref.flash_mismatch(got, want)
    assert err < BF16_ATOL and ratio > 1.0
    empty = ref.flash_attention_ref(q, k, v, q_positions=torch.tensor([-1], dtype=torch.int32),
                                    kv_positions=kpos)
    assert ref.flash_mismatch(empty, empty) == (0.0, 0.0)
    assert ref.flash_mismatch(empty + 1e-3, empty)[1] > 1.0
    w32 = want.float()
    assert ref.flash_mismatch(w32 + 5e-5, w32)[1] <= 1.0
    assert ref.flash_mismatch(w32 + 2e-4, w32)[1] > 1.0
