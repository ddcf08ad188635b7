"""The port's low-rank kernels against the JAX package's Pallas kernels.

On the CPU the port's ``xus``/``avt`` wrappers take their plain PyTorch
versions (the Hopper kernels run only on a CUDA tensor); the JAX kernels
run in Pallas interpret mode, as ``tests/test_kernels.py`` runs them. The
same numpy inputs feed both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lowrank_apply_kernels
from repro.kernels import ref as jref
from repro.kernels.lowrank_matmul import avt as jax_avt
from repro.kernels.lowrank_matmul import xus as jax_xus
from repro.kernels.ops import lowrank_apply_nd as jax_lowrank_apply_nd
from repro_torch.kernels import lowrank_apply, lowrank_apply_nd, ref, use_kernels_for
from repro_torch.kernels.lowrank_matmul import avt, xus

# f32: both sides accumulate in f32 and differ only in summation order.
# bf16: both round once from f32 to bf16 at the output (x·U and S in f32 on
# both sides); sums taken in another order may round to the neighbouring
# bf16 value, up to ~2 ulps (2^-7 relative), and values near zero carry
# the absolute part.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

SHAPES = [
    (8, 16, 8, 8),         # tests/test_kernels.py: tiny
    (64, 96, 80, 24),      # unaligned rank
    (128, 256, 128, 128),  # aligned
    (56, 512, 40, 16),     # M, N not multiples of a block
    (7, 33, 19, 5),        # ragged M, K, N and R
    (1, 100, 77, 24),      # a single row (decode at batch 1)
]


def _inputs(M, K, N, R, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    U = (rng.standard_normal((K, R)) / np.sqrt(K)).astype(np.float32)
    S = rng.standard_normal((R, R)).astype(np.float32)
    V = (rng.standard_normal((N, R)) / np.sqrt(N)).astype(np.float32)
    return x, U, S, V


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return (
        [jnp.asarray(a, dtype=jdt) for a in arrays],
        [torch.from_numpy(a).to(tdt) for a in arrays],
    )


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype]
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,R", SHAPES)
def test_xus_avt_match_pallas_interpret(M, K, N, R, dtype):
    (jx, jU, jS, jV), (tx, tU, tS, tV) = _both(_inputs(M, K, N, R), dtype)
    A = xus(tx, tU, tS)
    assert A.dtype == tx.dtype and A.shape == (M, R)
    _close(A, jax_xus(jx, jU, jS, interpret=True), dtype)
    jA = jnp.asarray(A.float().numpy(), dtype=DTYPES[dtype][0])
    y = avt(A, tV)
    assert y.dtype == tx.dtype and y.shape == (M, N)
    _close(y, jax_avt(jA, jV, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,R", SHAPES)
def test_lowrank_apply_matches_jax(M, K, N, R, dtype):
    arrays = _inputs(M, K, N, R, seed=1)
    (jx, jU, jS, jV), (tx, tU, tS, tV) = _both(arrays, dtype)
    y = lowrank_apply(tx, tU, tS, tV, use_kernels_for("auto"))
    _close(y, lowrank_apply_kernels(jx, jU, jS, jV, interpret=True), dtype)
    if dtype == "float32":
        _close(y, jref.lowrank_matmul_ref(*arrays), dtype)
        # the "off" chain is the JAX package's plain chain
        _close(lowrank_apply(tx, tU, tS, tV, False), jref.lowrank_matmul_ref(*arrays), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lowrank_apply_nd_batch_and_stacked_factors(dtype):
    rng = np.random.default_rng(2)
    G, B, T, K, N, R = 3, 2, 5, 48, 40, 16
    x = rng.standard_normal((G, B, T, K)).astype(np.float32)
    U = (rng.standard_normal((G, K, R)) / np.sqrt(K)).astype(np.float32)
    S = rng.standard_normal((G, R, R)).astype(np.float32)
    V = (rng.standard_normal((G, N, R)) / np.sqrt(N)).astype(np.float32)
    (jx, jU, jS, jV), (tx, tU, tS, tV) = _both([x, U, S, V], dtype)
    want = jax_lowrank_apply_nd(jx, jU, jS, jV, "interpret")
    y = lowrank_apply_nd(tx, tU, tS, tV, True)
    assert y.shape == (G, B, T, N)
    _close(y, want, dtype)
    # leading activation dims with an unstacked factor
    y2 = lowrank_apply_nd(tx[0], tU[0], tS[0], tV[0], True)
    _close(y2, jax_lowrank_apply_nd(jx[0], jU[0], jS[0], jV[0], "interpret"), dtype)


def test_plain_versions_follow_kernel_numerics():
    """The plain xus rounds once, after S: it is the f32 chain cast to bf16,
    not the bf16 chain that rounds x·U first."""
    x, U, S, _ = _inputs(16, 64, 8, 32, seed=3)
    tx, tU, tS = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, U, S))
    got = ref.xus_ref(tx, tU, tS)
    want = ((tx.float() @ tU.float()) @ tS.float()).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_kernel_policies():
    assert use_kernels_for("auto") is True
    assert use_kernels_for("off") is False
    with pytest.raises(ValueError, match="no counterpart"):
        use_kernels_for("interpret")
    with pytest.raises(ValueError, match="must be one of"):
        use_kernels_for("fast")


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on a CUDA card raises; the
    wrapper has no silent fallback."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        xus(x, torch.empty(8, 2, device="meta"), torch.empty(2, 2, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        avt(torch.empty(4, 2, device="meta"), x)


def test_stacked_factors_need_matching_activation_dims():
    with pytest.raises(ValueError, match="stack dims"):
        lowrank_apply_nd(torch.zeros(2, 5, 8), torch.zeros(3, 8, 4),
                         torch.zeros(3, 4, 4), torch.zeros(3, 6, 4), True)


@pytest.mark.cuda
def test_hopper_kernels_match_plain_versions_on_card():
    """Runs on an H100 (``pytest -m cuda``): each kernel against its plain
    version at Qwen2-7B decode shapes, in both working types."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("float32", "bfloat16"):
        tdt = DTYPES[dtype][1]
        for M, K, N, R in [(4, 3584, 18944, 256), (4, 3584, 512, 64), (7, 300, 77, 24)]:
            x, U, S, V = (torch.from_numpy(a).to("cuda", tdt) for a in _inputs(M, K, N, R))
            A = xus(x, U, S)
            torch.testing.assert_close(A, ref.xus_ref(x, U, S), **TOL[dtype])
            torch.testing.assert_close(avt(A, V), ref.avt_ref(A, V), **TOL[dtype])
