"""The port's low-rank kernels against the JAX package's Pallas kernels.

On the CPU the port's ``xus``/``avt``/``atb`` wrappers take their plain
PyTorch versions (the Hopper kernels run only on a CUDA tensor); the JAX
kernels run in Pallas interpret mode, as ``tests/test_kernels.py`` runs
them. The same numpy inputs feed both. The backward of the port's
``lowrank_apply`` (an autograd Function on the kernels) is held to the JAX
package's custom VJP through the interpreted kernels.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lowrank_apply_kernels
from repro.kernels import ref as jref
from repro.kernels.coeff_grad import atb as jax_atb
from repro.kernels.lowrank_matmul import avt as jax_avt
from repro.kernels.lowrank_matmul import xus as jax_xus
from repro.kernels.ops import _atb as jax_atb_padded
from repro.kernels.ops import coeff_grad_kernels as jax_coeff_grad_kernels
from repro.kernels.ops import lowrank_apply as jax_lowrank_apply
from repro.kernels.ops import lowrank_apply_nd as jax_lowrank_apply_nd
from repro_torch.kernels import (
    atb,
    coeff_grad_kernels,
    lowrank_apply,
    lowrank_apply_nd,
    ref,
    use_kernels_for,
)
from repro_torch.kernels.lowrank_matmul import (
    COUNTER_INTS,
    GRID_X_MAX,
    GRID_YZ_MAX,
    STREAM_KC,
    TILED_BLOCKS,
    avt,
    avt_plan,
    xus,
    xus_plan,
)
from repro_torch.kernels.coeff_grad import (
    ATB_BLOCKS,
    ATB_PARTIALS,
    ATB_STEP,
    ATB_TILE,
    atb_plan,
)
from torch_threads import one_intra_op_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# atb and the backward of lowrank_apply
# ---------------------------------------------------------------------------

ATB_SHAPES = [
    (64, 128, 96),   # tests/test_kernels.py: aligned
    (37, 70, 33),    # ragged M, Ka and Kb
    (1, 5, 3),       # a single row
    (200, 160, 160), # the llm-100m basis-pass dS at a short M
    (96, 320, 40),   # wide Ka, narrow Kb (dU / dV)
]


def _ab(M, Ka, Kb, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, Ka)).astype(np.float32),
            rng.standard_normal((M, Kb)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,Ka,Kb", ATB_SHAPES)
def test_atb_matches_pallas_interpret(M, Ka, Kb, dtype):
    (jA, jB), (tA, tB) = _both(_ab(M, Ka, Kb), dtype)
    C = atb(tA, tB)
    assert C.dtype == tA.dtype and C.shape == (Ka, Kb)
    want = (jax_atb(jA, jB, bm=min(64, M), bka=min(64, Ka), interpret=True)
            if (M, Ka, Kb) == ATB_SHAPES[0] else jax_atb_padded(jA, jB, interpret=True))
    # f32 sums of up to 200 products in another order; bf16 as for xus/avt
    _close(C, want, dtype)


def test_atb_accumulates_in_f32_and_rounds_once():
    A, B = _ab(300, 24, 16, seed=4)
    tA, tB = torch.from_numpy(A).to(torch.bfloat16), torch.from_numpy(B).to(torch.bfloat16)
    want = (tA.float().T @ tB.float()).to(torch.bfloat16)
    assert torch.equal(atb(tA, tB), want)
    assert torch.equal(ref.atb_ref(tA, tB), want)
    # one leading batch dim: G independent products
    G = torch.from_numpy(np.stack([A, 2 * A])), torch.from_numpy(np.stack([B, B]))
    C = atb(*G)
    assert C.shape == (2, 24, 16)
    torch.testing.assert_close(C[1], 2 * C[0])


def test_xus_without_s_is_xu_with_one_rounding():
    """``xus(x, U)`` (the backward's S = I products) is JAX's xus with the
    identity, which rounds x·U once."""
    x, U, _, _ = _inputs(24, 64, 8, 16, seed=5)
    for dtype in ("float32", "bfloat16"):
        (jx, jU), (tx, tU) = _both([x, U], dtype)
        got = xus(tx, tU)
        want = jax_xus(jx, jU, jnp.eye(16, dtype=jnp.float32), interpret=True)
        _close(got, want, dtype)
        assert torch.equal(got, ref.xus_ref(tx, tU, torch.eye(16)))


def test_coeff_grad_kernels_matches_jax():
    rng = np.random.default_rng(6)
    M, K, N, R = 40, 48, 36, 12
    x, dy = rng.standard_normal((M, K)), rng.standard_normal((M, N))
    U, V = rng.standard_normal((K, R)) / 7, rng.standard_normal((N, R)) / 6
    arrays = [a.astype(np.float32) for a in (x, dy, U, V)]
    want = jax_coeff_grad_kernels(*map(jnp.asarray, arrays), interpret=True)
    got = coeff_grad_kernels(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


#: which of (x, U, S, V) need a gradient: the training path's combinations
#: (basis pass: all four; client loop: x and S̃; the embedding, whose S sits
#: in the U slot: x, U, V in the basis pass, U alone in the client loop)
NEEDS = [(1, 1, 1, 1), (1, 0, 1, 0), (1, 1, 0, 1), (0, 1, 0, 0), (0, 0, 0, 1)]


def _vjp_jax(arrays, dy, use_kernels):
    _, vjp = jax.vjp(lambda *a: jax_lowrank_apply(*a, use_kernels), *map(jnp.asarray, arrays))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _grads_torch(arrays, dy, need, use_kernels):
    ins = [torch.from_numpy(a).requires_grad_(bool(n)) for a, n in zip(arrays, need)]
    y = lowrank_apply(*ins, use_kernels)
    return torch.autograd.grad(y, [t for t in ins if t.requires_grad], torch.from_numpy(dy))


@pytest.mark.parametrize("need", NEEDS)
@pytest.mark.parametrize("M,K,N,R", [(24, 40, 32, 8), (7, 33, 19, 5)])
def test_lowrank_apply_vjp_matches_jax(M, K, N, R, need):
    """The kernel-backed backward (plain versions on the CPU) against the
    JAX custom VJP through the interpreted Pallas kernels, f32, 1e-5."""
    arrays = list(_inputs(M, K, N, R, seed=7))
    dy = np.random.default_rng(8).standard_normal((M, N)).astype(np.float32)
    want = [w for w, n in zip(_vjp_jax(arrays, dy, "interpret"), need) if n]
    got = _grads_torch(arrays, dy, need, True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    # the plain chain ("off") differentiates to the same cotangents
    for g, w in zip(_grads_torch(arrays, dy, need, False), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def test_lowrank_apply_vjp_bf16_casts_to_primal_dtypes():
    arrays = [a for a in _inputs(16, 32, 24, 8, seed=9)]
    ins = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in arrays]
    ins[2] = torch.from_numpy(arrays[2]).requires_grad_(True)  # S kept in f32
    y = lowrank_apply(ins[0], ins[1], ins[2].to(torch.bfloat16), ins[3], True)
    grads = torch.autograd.grad(y.float().sum(), ins)
    assert [g.dtype for g in grads] == [t.dtype for t in ins]
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


def test_backward_skips_terms_nobody_asked_for():
    """Kernel calls per backward, by ``needs_input_grad`` (counted on the
    plain versions): the client loop's (x, S̃) takes 3 xus, 1 avt, 1 atb."""
    calls = {"xus": 0, "avt": 0, "atb": 0}
    saved = ref.xus_ref, ref.avt_ref, ref.atb_ref

    def counting(name, fn):
        def f(*a):
            calls[name] += 1
            return fn(*a)
        return f

    ref.xus_ref, ref.avt_ref, ref.atb_ref = (
        counting("xus", saved[0]), counting("avt", saved[1]), counting("atb", saved[2])
    )
    try:
        arrays = list(_inputs(8, 16, 12, 4, seed=10))
        dy = np.ones((8, 12), np.float32)
        want = {(1, 1, 1, 1): (1 + 4, 1 + 1, 3), (1, 0, 1, 0): (1 + 3, 1 + 1, 1),
                (0, 1, 0, 0): (1 + 1, 1, 1), (1, 1, 0, 1): (1 + 2, 1 + 1, 2)}
        for need, (n_xus, n_avt, n_atb) in want.items():
            calls.update(xus=0, avt=0, atb=0)
            _grads_torch(arrays, dy, need, True)
            assert (calls["xus"], calls["avt"], calls["atb"]) == (n_xus, n_avt, n_atb), need
    finally:
        ref.xus_ref, ref.avt_ref, ref.atb_ref = saved


def test_lowrank_apply_nd_stacked_vjp_accumulates_into_the_stack():
    """Stacked factors (a layer stack): the per-member views' gradients land
    in the stacked leaf, as JAX's vmapped VJP gives them."""
    rng = np.random.default_rng(11)
    G, B, T, K, N, R = 3, 2, 5, 24, 20, 6
    x = rng.standard_normal((G, B, T, K)).astype(np.float32)
    U = (rng.standard_normal((G, K, R)) / 5).astype(np.float32)
    S = rng.standard_normal((G, R, R)).astype(np.float32)
    V = (rng.standard_normal((G, N, R)) / 4).astype(np.float32)
    dy = rng.standard_normal((G, B, T, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_lowrank_apply_nd(*a, "interpret"),
                     *map(jnp.asarray, (x, U, S, V)))
    want = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, U, S, V)]
    y = lowrank_apply_nd(*ts, True)
    got = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    # member by member through views of the stack, as the model's layer loop runs
    ts2 = [torch.from_numpy(a).requires_grad_(True) for a in (x, U, S, V)]
    out = torch.stack([lowrank_apply_nd(*(t[i] for t in ts2), True) for i in range(G)])
    for g, w in zip(torch.autograd.grad(out, ts2, torch.from_numpy(dy)), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_atb_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError, match="cuda or cpu"):
        atb(torch.empty(4, 3, device="meta"), torch.empty(4, 2, device="meta"))


def _atb_close(C, W, dtype):
    if dtype == "float32":  # error relative to the sum's magnitude
        assert (C - W).abs().max() <= 1e-4 * W.abs().max()
    else:
        torch.testing.assert_close(C, W, **TOL[dtype])


@pytest.mark.cuda
def test_atb_matches_plain_version_on_card():
    """Runs on an H100 (``pytest -m cuda``): atb against atb_ref at the
    training path's shapes (split and unsplit M, M = 8192), ragged ones,
    stacked factors (G = 3) and views offset by a row or an element (the
    element-load variant), both working types; a second call gives the
    first one's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("float32", "bfloat16"):
        tdt = DTYPES[dtype][1]
        for M, Ka, Kb in [(512, 320, 320), (512, 640, 160), (512, 160, 160), (512, 2560, 160),
                          (512, 8192, 160), (8192, 2560, 160), (8192, 160, 160), (37, 70, 33),
                          (1, 5, 3), (600, 100, 36)]:
            A, B = (torch.from_numpy(a).to("cuda", tdt) for a in _ab(M, Ka, Kb))
            C, W = atb(A, B), ref.atb_ref(A, B)
            _atb_close(C, W, dtype)
            assert torch.equal(C, atb(A, B))  # the same bits again
        # stacked factors: the leading axis is a grid axis (split and unsplit M)
        for M, Ka, Kb in [(512, 320, 160), (512, 2560, 160), (130, 33, 70)]:
            A, B = (torch.from_numpy(np.stack([a, -2 * a, a[::-1].copy()])).to("cuda", tdt)
                    for a in _ab(M, Ka, Kb, seed=M))
            C = atb(A, B)
            assert C.shape == (3, Ka, Kb)
            _atb_close(C, ref.atb_ref(A, B), dtype)
            assert torch.equal(C, atb(A, B))
        # contiguous views at an offset: A one row on, B one element on
        for M, Ka, Kb in [(512, 320, 320), (512, 2560, 160)]:
            a, b = (torch.from_numpy(t).to("cuda", tdt) for t in _ab(M, Ka, Kb, seed=3))
            bufa = torch.zeros((M + 1, Ka), device="cuda", dtype=tdt)
            bufa[1:] = a
            A = bufa[1:]
            flat = torch.zeros(M * Kb + 1, device="cuda", dtype=tdt)
            flat[1:] = b.reshape(-1)
            B = flat[1:].view(M, Kb)
            assert A.is_contiguous() and B.is_contiguous() and B.data_ptr() % 16
            C = atb(A, B)
            _atb_close(C, ref.atb_ref(A, B), dtype)
            assert torch.equal(C, atb(a, b))  # the vector variant's bits


@pytest.mark.cuda
def test_atb_tickets_on_card():
    """Runs on an H100 (``pytest -m cuda``): the split-M calls leave their
    ticket counters at 0, so calls replayed from a CUDA graph, and calls on
    two streams at once, give the eager call's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    cases = [tuple(torch.from_numpy(a).to("cuda") for a in _ab(M, Ka, Kb, seed=Ka))
             for M, Ka, Kb in [(512, 320, 320), (512, 160, 160), (8192, 640, 160),
                               (512, 2560, 160)]]
    assert all(atb_plan(1, A.shape[0], A.shape[1], B.shape[1]).splits > 1 for A, B in cases[:3])
    want = [atb(A, B) for A, B in cases]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        atb(*cases[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [atb(A, B) for A, B in cases]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = [[] for _ in streams]
    for _ in range(20):
        for st, g in zip(streams, got):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                g.append([atb(A, B) for A, B in cases])
    torch.cuda.synchronize()
    for g in got:
        for outs in g:
            assert all(torch.equal(o, w) for o, w in zip(outs, want))


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


# ---------------------------------------------------------------------------
# xus_plan: the route, K splits, launches and workspace of an xus call
# ---------------------------------------------------------------------------

#: (K, R) of every xus call of a Qwen2-7B decode step (d 3584, d_ff 18944,
#: r 256, k/v rank 64; the f32 embedding's 256 × 256) and of an llm-100m
#: FeDLRT round (n_in / n_out 640, 2560, 8192; r 160, augmented 320;
#: the embedding's K = r or 2r)
DECODE_XUS = [(3584, 256), (3584, 64), (18944, 256), (256, 256)]
TRAIN_XUS = [(K, R) for K in (160, 320, 640, 2560, 8192) for R in (160, 320)]


def _cdiv(a, b):
    return -(-a // b)


def _check_plan(plan, G, M, K, R, has_s):
    """What ``lr_xus`` checks before it launches, and the grids it makes."""
    assert plan.splits >= 1 and plan.kc >= 1
    # the splits cover K exactly: every split but the last is kc long
    assert (plan.splits - 1) * plan.kc < K <= plan.splits * plan.kc
    per_g = M * R
    if plan.route == "stream":
        ctiles = _cdiv(R, 64)
        assert M <= 16 and plan.launches == 1
        assert STREAM_KC[0] <= plan.kc or plan.splits == 1
        assert (4 if M <= 4 else 16) * plan.kc <= 8192  # the staged x rows
        assert plan.counters == G * (ctiles + 1) <= COUNTER_INTS
        need = 2 * (G * plan.splits * per_g + (G * ctiles * per_g if has_s and ctiles > 1 else 0))
        grids = [(ctiles, plan.splits, G)]
    else:
        assert plan.route == "tiled" and plan.launches == (2 if has_s else 1)
        tiles = G * _cdiv(R, 32) * _cdiv(M, 64)
        splits_s = _cdiv(R, plan.kc_s)
        assert (splits_s - 1) * plan.kc_s < R <= splits_s * plan.kc_s
        assert has_s or splits_s == 1
        for n, kc in ((plan.splits, plan.kc), (splits_s, plan.kc_s)):
            assert n == 1 or (kc % 32 == 0 and tiles < TILED_BLOCKS)  # splits under ~1.5 waves
        # a ticket a tile for each pass
        assert plan.counters == (2 * tiles if max(plan.splits, splits_s) > 1 else 0) <= COUNTER_INTS
        need = (G * per_g if has_s else 0) + sum(G * n * per_g for n in (plan.splits, splits_s)
                                                 if n > 1)
        grids = [(_cdiv(R, 32), _cdiv(M, 64), G * n) for n in (plan.splits, splits_s)]
    assert plan.workspace >= need
    for gx, gy, gz in grids:
        assert 1 <= gx < 2**31 and 1 <= gy <= GRID_YZ_MAX and 1 <= gz <= GRID_YZ_MAX


@pytest.mark.parametrize("has_s", [True, False])
@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("K,R", DECODE_XUS)
def test_xus_plan_decode_shapes_are_one_launch(K, R, M, has_s):
    plan = xus_plan(1, M, K, R, has_s)
    assert plan.route == "stream" and plan.launches == 1
    _check_plan(plan, 1, M, K, R, has_s)
    # about one block per SM: never more than two waves of the card's 132 SMs
    assert _cdiv(R, 64) * plan.splits <= 2 * 132


@pytest.mark.parametrize("has_s", [True, False])
@pytest.mark.parametrize("K,R", TRAIN_XUS)
def test_xus_plan_training_shapes_take_the_tiled_route(K, R, has_s):
    plan = xus_plan(1, 512, K, R, has_s)
    assert plan.route == "tiled" and plan.launches == (2 if has_s else 1)
    _check_plan(plan, 1, 512, K, R, has_s)
    # K is split only while the 64 x 32 tiles are under ~1.5 waves
    tiles = _cdiv(512, 64) * _cdiv(R, 32)
    assert tiles * plan.splits <= 2 * TILED_BLOCKS or plan.kc == 64


@pytest.mark.parametrize("seed", range(4))
def test_xus_plan_ragged_and_stacked_shapes(seed):
    """Random ragged shapes, stacked factors included: the plan is one
    ``lr_xus`` accepts, its splits cover K and its workspace is enough."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        G = int(rng.choice([1, 3, 12, 1000]))
        M = int(rng.choice([1, 3, 16, 17, 130, 512, int(rng.integers(1, 5000))]))
        K = int(rng.integers(1, 40000))
        R = int(rng.integers(1, 600))
        has_s = bool(rng.integers(2))
        _check_plan(xus_plan(G, M, K, R, has_s), G, M, K, R, has_s)


def test_xus_plan_depends_on_shapes_only(monkeypatch):
    """The plan reads nothing of the card: it is the same with CUDA
    unavailable, and the cached plan equals a fresh one."""
    shapes = [(1, 4, 18944, 256, True), (3, 17, 1003, 5, False), (1, 512, 2560, 320, True)]
    cached = [xus_plan(*s) for s in shapes]
    for name in ("is_available", "device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: pytest.fail("plan read the card"))
    assert [xus_plan.__wrapped__(*s) for s in shapes] == cached
    assert [xus_plan(*s) for s in shapes] == cached
    with pytest.raises(ValueError, match="positive"):
        xus_plan.__wrapped__(1, 0, 8, 8, True)


# ---------------------------------------------------------------------------
# avt_plan: the route, its sizes and the launches of an avt call
# ---------------------------------------------------------------------------

#: (N, R) of every avt call of a Qwen2-7B decode step (k / v, q / o / down,
#: gate / up, the LM head) and of an llm-100m FeDLRT round (n_out / n_in
#: 640, 2560, 8192 at r 160 and augmented 320; the embedding's dx 160²)
DECODE_AVT = [(512, 64), (3584, 256), (18944, 256), (152064, 256)]
ROUND_AVT = [(640, 320), (640, 160), (2560, 320), (2560, 160), (8192, 320), (8192, 160),
             (160, 160)]


def _check_avt_plan(plan, G, M, N, R):
    """What ``lr_avt`` checks before it launches, and the grid it makes."""
    assert plan.launches == 1 and plan.workspace == 0 and plan.counters == 0
    if plan.route == "stream":
        assert M <= 16 and plan.tile is None
        lanes = 1
        while lanes < min(32, _cdiv(R, 8)):  # lanes of a row: 8 elements each a pass
            lanes *= 2
        assert plan.rows == 4 * (32 // lanes)  # 4 rows a group of lanes
        assert 1 <= plan.warps <= 8
        grid = (_cdiv(N, plan.rows * plan.warps) * _cdiv(M, 1 if M == 1 else 4), G)
    else:
        assert plan.route == "tiled" and M > 16
        assert plan.tile == (64, 32) and plan.rows == plan.warps == 0
        grid = (_cdiv(N, 32), _cdiv(M, 64), G)
    assert 1 <= grid[0] <= GRID_X_MAX and all(1 <= d <= GRID_YZ_MAX for d in grid[1:])
    return grid


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("N,R", DECODE_AVT)
def test_avt_plan_decode_shapes_take_the_stream_route(N, R, M):
    plan = avt_plan(1, M, N, R)
    assert plan.route == "stream"
    grid = _check_avt_plan(plan, 1, M, N, R)
    if N >= 3584:  # about a wave of blocks or more: one per SM of the card's 132
        assert grid[0] >= 132


@pytest.mark.parametrize("M,N,R", [(512, n, r) for n, r in ROUND_AVT]
                         + [(m, n, r) for m in (17, 64) for n, r in DECODE_AVT])
def test_avt_plan_training_and_prefill_shapes_take_the_tiled_route(M, N, R):
    plan = avt_plan(1, M, N, R)
    assert plan.route == "tiled"
    _check_avt_plan(plan, 1, M, N, R)


@pytest.mark.parametrize("seed", range(4))
def test_avt_plan_ragged_and_stacked_shapes(seed):
    """Random ragged shapes, stacked factors included: the plan is one
    ``lr_avt`` accepts, one launch with no workspace and no counters."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        G = int(rng.choice([1, 3, 12, 1000]))
        M = int(rng.choice([1, 2, 3, 4, 5, 16, 17, 130, 512, int(rng.integers(1, 5000))]))
        N = int(rng.integers(1, 200000))
        R = int(rng.integers(1, 600))
        _check_avt_plan(avt_plan(G, M, N, R), G, M, N, R)


#: (K of xus / N of avt, R) of the MoE experts' stacked calls, G = 64:
#: OLMoE-1B-7B's up / gate (2048 → 1024, r 128) and down (1024 → 2048);
#: DeepSeekMoE-16B's (2048 → 1408, r 176, the first rank not a multiple
#: of 64) and down (1408 → 2048)
EXPERT_SHAPES = [(2048, 128), (1024, 128), (2048, 176), (1408, 176)]
EXPERTS = 64


@pytest.mark.parametrize("M", [1, 4, 10])
@pytest.mark.parametrize("dim,R", EXPERT_SHAPES)
def test_expert_stack_plans_take_the_stream_route(dim, R, M):
    """Decode (one row an expert) and prefill (up to the 10 rows of the
    capacity at 64 tokens): one launch of the stream route for all 64
    experts, within the ticket counters of a slot (192 at R 128, 256 at
    R 176)."""
    for has_s in (True, False):
        plan = xus_plan(EXPERTS, M, dim, R, has_s)
        assert plan.route == "stream" and plan.launches == 1
        assert plan.counters == EXPERTS * (_cdiv(R, 64) + 1) <= COUNTER_INTS
        _check_plan(plan, EXPERTS, M, dim, R, has_s)
    plan = avt_plan(EXPERTS, M, dim, R)
    assert plan.route == "stream"
    _check_avt_plan(plan, EXPERTS, M, dim, R)


def test_avt_plan_depends_on_shapes_only(monkeypatch):
    """The plan reads nothing of the card: it is the same with CUDA
    unavailable, and the cached plan equals a fresh one."""
    shapes = [(1, 4, 152064, 256), (3, 17, 1003, 5), (1, 512, 2560, 320), (2, 1, 77, 24)]
    cached = [avt_plan(*s) for s in shapes]
    for name in ("is_available", "device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: pytest.fail("plan read the card"))
    assert [avt_plan.__wrapped__(*s) for s in shapes] == cached
    assert [avt_plan(*s) for s in shapes] == cached
    with pytest.raises(ValueError, match="positive"):
        avt_plan.__wrapped__(1, 4, 0, 8)


@pytest.mark.parametrize("G,M,N,R", [(GRID_YZ_MAX + 1, 4, 3584, 256),
                                     (GRID_YZ_MAX + 1, 512, 640, 320),
                                     (1, 64 * GRID_YZ_MAX + 1, 640, 320),
                                     (1, 512, 32 * GRID_X_MAX + 1, 320),
                                     (1, 1, 64 * GRID_X_MAX + 1, 256)])
def test_avt_plan_refuses_a_grid_too_large(G, M, N, R):
    with pytest.raises(ValueError, match=f"grid too large for G={G} M={M} N={N} R={R}"):
        avt_plan.__wrapped__(G, M, N, R)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_calls", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_avt_calls_sum_to_the_round_launches():
    """``chip_smoke.round_calls`` (a FeDLRT round's calls by shape, one per
    launch, which the card's round sums weigh) counts the calls an f32
    llm-tiny round makes here, avt among them, shape by shape."""
    from repro_torch.api import ExperimentSpec, ModelSpec, build

    smoke = _chip_smoke()
    spec = ExperimentSpec(name="avt-calls", model=ModelSpec(preset="llm-tiny"))
    exp = build(spec, device="cpu")
    want = smoke.round_calls(exp.params, exp.engine.cfg, spec.data.batch * spec.data.seq)
    calls = {}
    with smoke.kernel_calls(calls):
        exp.run(1)
    assert calls == want
    assert smoke.launches_of(calls)["avt"] == sum(smoke.of_kernel(want, "avt").values()) > 0


def test_train_avt_calls_llm_100m_round():
    """llm-100m's factors (no data, no engine) with the spec defaults: the
    seven (N, R) shapes of a round and their calls, 3,768 in all."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.api.tasks import PRESETS
    from repro_torch.models.model import build_params

    smoke = _chip_smoke()
    params, _ = build_params(PRESETS["llm-100m"], torch.Generator().manual_seed(0))
    cfg = ExperimentSpec().fed.to_fed_config()
    calls = {(k[2], k[3]): n for k, n in smoke.of_kernel(smoke.round_calls(params, cfg, 512),
                                                         "avt").items()}
    assert calls == {(640, 320): 2144, (640, 160): 780, (2560, 320): 576, (2560, 160): 240,
                     (8192, 320): 16, (8192, 160): 8, (160, 160): 4}
    assert sum(calls.values()) == smoke.launches_of(smoke.llm100m_round_calls())["avt"] == 3768
    assert sorted(calls) == sorted(ROUND_AVT)


@pytest.mark.parametrize("arch", ["qwen2-7b", "codeqwen1.5-7b", "qwen1.5-32b", "qwen3-32b",
                                  "olmoe-1b-7b", "deepseek-moe-16b", "rwkv6-7b",
                                  "jamba-1.5-large-398b", "whisper-large-v3",
                                  "llava-next-mistral-7b"])
def test_decode_step_calls_are_the_calls_a_decode_step_makes(arch, monkeypatch):
    """``chip_smoke.decode_step_calls`` (which the card run holds every
    served model's launches to) counts the xus / avt calls one 4-slot
    decode step of the reduced architecture makes, by (dtype, K or N, R,
    stack G): the experts' stacks at G = E, the shared experts and the
    router (a dense product, no call) of a MoE layer, Qwen3's d × H·hd q
    and o, RWKV's five projections, Mamba's five (its dt_proj dense at
    this size, under the policy's ``min_dim``), Whisper's cross block (its
    step on a shared-position cache, and its prefill with the encoder's
    projections: ``encoder=True``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import lowrank_matmul
    from repro_torch.models import build_model, reduced

    smoke = _chip_smoke()
    seen = {}

    def counting(kernel, fn):
        def call(a, w, *rest):
            key = (kernel, str(a.dtype).split(".")[1], w.shape[-2], w.shape[-1],
                   w.shape[0] if w.dim() == 3 else 1)
            seen[key] = seen.get(key, 0) + 1
            return fn(a, w, *rest)
        return call

    monkeypatch.setattr(lowrank_matmul.ref, "xus_ref", counting("xus", ref.xus_ref))
    monkeypatch.setattr(lowrank_matmul.ref, "avt_ref", counting("avt", ref.avt_ref))
    cfg = reduced(get_config(arch))
    if arch == "qwen3-32b":
        cfg = dataclasses.replace(cfg, num_kv_heads=2, head_dim=96)  # H·hd ≠ d, as published
    model = build_model(cfg)
    with torch.no_grad():
        params, _ = model.init(torch.Generator().manual_seed(0))
        cache = model.init_cache(params, 4, max(12, cfg.sliding_window),
                                 per_slot=not cfg.is_encdec)
        model.serve_step(params, cache, torch.ones((4, 1), dtype=torch.int64))
    assert seen == smoke.decode_step_calls(cfg)
    assert smoke.per_forward(cfg) == sum(n for k, n in seen.items() if k[0] == "xus")
    if cfg.is_encdec:
        seen.clear()
        frames = torch.zeros((4, cfg.encoder.num_frames, cfg.d_model))
        with torch.no_grad():
            model.serve_prefill(params, {"tokens": torch.ones((4, 3), dtype=torch.int64),
                                         "frames": frames}, cache_len=12)
        assert seen == smoke.decode_step_calls(cfg, encoder=True)
    if cfg.moe is not None:
        assert any(G == cfg.moe.num_experts for *_, G in seen)


# ---------------------------------------------------------------------------
# atb_plan: the tile, M splits, launches, workspace and counters of an atb call
# ---------------------------------------------------------------------------

#: (Ka, Kb) of every atb call of an llm-100m FeDLRT round (dS̃ 320², dU / dV
#: of the 640-wide layers, dS 160², dU / dV of the MLP, the embedding's
#: vocab-wide dV and gather backward) and of Qwen2-7B's training path
ATB_ROUND = [(320, 320), (640, 160), (160, 160), (2560, 160), (8192, 160)]
ATB_QWEN = [(256, 256), (64, 64), (512, 512), (128, 128), (3584, 256), (3584, 64),
            (18944, 256), (512, 64), (152064, 256)]


def _check_atb_plan(plan, G, M, Ka, Kb):
    """What ``lr_atb`` checks before it launches, and the grid it makes."""
    assert plan.tile == ATB_TILE and plan.launches == 1
    assert plan.splits >= 1 and plan.mc >= 1
    # the splits cover M exactly: every split but the last is mc long
    assert (plan.splits - 1) * plan.mc < M <= plan.splits * plan.mc
    tiles = G * _cdiv(Ka, ATB_TILE[0]) * _cdiv(Kb, ATB_TILE[1])
    if plan.splits == 1:
        assert plan.workspace == 0 and plan.counters == 0
    else:
        assert plan.mc % ATB_STEP == 0 and plan.mc >= 64
        assert tiles < ATB_BLOCKS  # M is split only under ~1.5 waves of tiles
        assert plan.workspace == plan.splits * G * Ka * Kb
        # the partials stay in proportion to the operands' elements
        assert plan.workspace <= ATB_PARTIALS * G * M * (Ka + Kb)
        assert plan.counters == tiles <= COUNTER_INTS  # a ticket a tile
    gx, gy, gz = _cdiv(Ka, ATB_TILE[0]), _cdiv(Kb, ATB_TILE[1]), G * plan.splits
    assert 1 <= gx < 2**31 and 1 <= gy <= GRID_YZ_MAX and 1 <= gz <= GRID_YZ_MAX


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("M", [512, 8192])
@pytest.mark.parametrize("Ka,Kb", ATB_ROUND + ATB_QWEN)
def test_atb_plan_training_shapes_are_one_launch(Ka, Kb, M, G):
    plan = atb_plan(G, M, Ka, Kb)
    _check_atb_plan(plan, G, M, Ka, Kb)
    tiles = G * _cdiv(Ka, 64) * _cdiv(Kb, 32)
    # enough blocks: at least a wave of the card's 132 SMs, or the splits go
    # as far as the partials' bytes or the 64-row floor allow
    assert (tiles * plan.splits >= 132 or plan.mc == 64
            or (plan.splits + 1) * Ka * Kb > ATB_PARTIALS * M * (Ka + Kb))


def test_atb_plan_llm_100m_round():
    """The five shapes of an llm-100m round at M = 512: the small ones split
    M (4-8 splits, 4 x C at 320², not 8 x), the large ones fill the card."""
    plans = {s: atb_plan(1, 512, *s) for s in ATB_ROUND}
    assert [plans[s].splits for s in ATB_ROUND] == [4, 4, 8, 1, 1]
    assert plans[(320, 320)].workspace == 4 * 320 * 320
    assert all(p.launches == 1 for p in plans.values())


@pytest.mark.parametrize("seed", range(4))
def test_atb_plan_ragged_and_stacked_shapes(seed):
    """Random ragged shapes, stacked factors included: the plan is one
    ``lr_atb`` accepts, its splits cover M and its workspace is exact."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        G = int(rng.choice([1, 3, 12, 1000]))
        M = int(rng.choice([1, 31, 64, 65, 512, 8192, int(rng.integers(1, 20000))]))
        Ka = int(rng.integers(1, 20000))
        Kb = int(rng.integers(1, 600))
        _check_atb_plan(atb_plan(G, M, Ka, Kb), G, M, Ka, Kb)


def test_atb_plan_depends_on_shapes_only(monkeypatch):
    """The plan reads nothing of the card: it is the same with CUDA
    unavailable, and the cached plan equals a fresh one."""
    shapes = [(1, 512, 320, 320), (3, 8192, 160, 160), (1, 512, 152064, 256), (2, 37, 70, 33)]
    cached = [atb_plan(*s) for s in shapes]
    for name in ("is_available", "device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: pytest.fail("plan read the card"))
    assert [atb_plan.__wrapped__(*s) for s in shapes] == cached
    assert [atb_plan(*s) for s in shapes] == cached


@pytest.mark.parametrize("G,M,Ka,Kb", [(GRID_YZ_MAX + 1, 512, 8192, 160),
                                       (1, 512, 64, 32 * GRID_YZ_MAX + 1),
                                       (1, 512, 64 * (2**31 - 1) + 1, 32)])
def test_atb_plan_refuses_a_grid_too_large(G, M, Ka, Kb):
    with pytest.raises(ValueError, match=f"grid too large for G={G} M={M} Ka={Ka} Kb={Kb}"):
        atb_plan.__wrapped__(G, M, Ka, Kb)


def test_atb_plan_refuses_empty_sizes():
    with pytest.raises(ValueError, match="positive"):
        atb_plan.__wrapped__(1, 0, 8, 8)


# ---------------------------------------------------------------------------
# the build: one library named by every source and header under csrc
# ---------------------------------------------------------------------------


def test_library_path_covers_headers(tmp_path, monkeypatch):
    """Editing a shared header renames the library (a rebuild), and only the
    ``.cu`` sources are compiled."""
    import shutil

    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc holds no shared header"
    before = build.library_path()
    assert build.library_path() == before  # the same tree, the same name
    assert [p.name for p in build.sources()] == sorted(
        p.name for p in csrc.iterdir() if p.suffix == ".cu")
    assert not any(p.suffix == ".cuh" for p in build.sources())
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    edited = build.library_path()
    assert edited != before
    (csrc / "extra.cuh").write_text("#pragma once\n")  # a new header counts too
    assert build.library_path() not in (before, edited)


# ---------------------------------------------------------------------------
# xus on the card: both routes, ragged, misaligned, stacked, repeatable
# ---------------------------------------------------------------------------

XUS_CARD_M = [1, 3, 4, 16, 17, 130, 512]
XUS_CARD_KR = [(300, 5), (1003, 64), (517, 160), (3584, 256), (640, 320)]


def _xus_case(G, M, K, R, seed, dtype, s_dtype, misaligned=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    U = (rng.standard_normal((G, K, R)) / np.sqrt(K)).astype(np.float32)
    S = (rng.standard_normal((G, R, R)) / np.sqrt(R)).astype(np.float32)
    tdt = DTYPES[dtype][1]
    tx, tU = (torch.from_numpy(a).to("cuda", tdt) for a in (x, U))
    tS = torch.from_numpy(S).to("cuda", DTYPES[s_dtype][1])
    if misaligned:
        # contiguous views at an offset: x one row on (K odd), U one element on
        bx = torch.zeros((G, M + 1, K), device="cuda", dtype=tdt)
        bx[:, 1:] = tx
        tx = bx[0, 1:] if G == 1 else None
        flat = torch.zeros(K * R + 1, device="cuda", dtype=tdt)
        flat[1:] = tU[0].reshape(-1)
        tU = flat[1:].view(K, R)
        tS = tS[0]
        assert tx.is_contiguous() and tU.is_contiguous()
        assert tx.data_ptr() % 16 and tU.data_ptr() % 16
    return tx, tU, tS


def _xus_close(got, want, dtype):
    if dtype == "float32":  # f32 sums of up to 3584 terms in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                           ("bfloat16", "float32")])
def test_xus_routes_match_plain_version_on_card(dtype, s_dtype):
    """Runs on an H100 (``pytest -m cuda``): xus against ``ref.xus_ref`` on
    both routes (M ≤ 16 stream, M > 16 tiled), ragged K (not a multiple of
    8) and R, with and without S, stacked factors (G = 3), misaligned
    operand views; and two calls at equal inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for M in XUS_CARD_M:
        for K, R in XUS_CARD_KR:
            x, U, S = _xus_case(1, M, K, R, M + K, dtype, s_dtype)
            for s in (S, None):
                got = xus(x[0], U[0], None if s is None else s[0])
                _xus_close(got, ref.xus_ref(x[0], U[0], None if s is None else s[0]), dtype)
        # stacked factors: the leading axis is a grid axis
        x, U, S = _xus_case(3, M, 1003, 160, M, dtype, s_dtype)
        for s in (S, None):
            got = xus(x, U, s)
            assert got.shape == (3, M, 160)
            _xus_close(got, ref.xus_ref(x, U, s), dtype)
            assert torch.equal(got, xus(x, U, s))  # the same bits again
        # misaligned views take the element-load variants
        x, U, S = _xus_case(1, M, 1003, 64, 7 * M, dtype, s_dtype, misaligned=True)
        for s in (S, None):
            _xus_close(xus(x, U, s), ref.xus_ref(x, U, s), dtype)
    x, U, S = _xus_case(1, 4, 18944, 256, 11, dtype, s_dtype)
    first = xus(x[0], U[0], S[0])
    assert all(torch.equal(first, xus(x[0], U[0], S[0])) for _ in range(3))


@pytest.mark.cuda
def test_xus_stream_route_tickets_on_card():
    """Runs on an H100 (``pytest -m cuda``): the stream route's ticket
    counters are left at 0 by every call, so calls replayed from a CUDA
    graph, and calls on two streams at once, give the eager call's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    cases = [_xus_case(1, M, K, R, K + R, "bfloat16", "bfloat16")
             for M, K, R in [(4, 3584, 256), (1, 18944, 256), (16, 3584, 64)]]
    want = [xus(x[0], U[0], S[0]) for x, U, S in cases]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xus(*(t[0] for t in cases[0]))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [xus(x[0], U[0], S[0]) for x, U, S in cases]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = [[] for _ in streams]
    for _ in range(20):
        for st, g in zip(streams, got):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                g.append([xus(x[0], U[0], S[0]) for x, U, S in cases])
    torch.cuda.synchronize()
    for g in got:
        for outs in g:
            assert all(torch.equal(o, w) for o, w in zip(outs, want))


# ---------------------------------------------------------------------------
# avt on the card: both routes, ragged, misaligned, stacked, repeatable
# ---------------------------------------------------------------------------

AVT_CARD_M = [1, 4, 16, 17, 64, 512]
AVT_CARD_NR = [(3584, 256), (512, 64), (640, 320), (1000, 160), (77, 24), (513, 77)]


def _avt_case(G, M, N, R, seed, dtype, misaligned=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((G, M, R)).astype(np.float32)
    V = (rng.standard_normal((G, N, R)) / np.sqrt(R)).astype(np.float32)
    tA, tV = (torch.from_numpy(a).to("cuda", DTYPES[dtype][1]) for a in (A, V))
    if misaligned:
        # contiguous views one element on: 16-byte loads would be misaligned
        views = []
        for t in (tA, tV):
            flat = torch.zeros(t.numel() + 1, device="cuda", dtype=t.dtype)
            flat[1:] = t.reshape(-1)
            views.append(flat[1:].view(t.shape))
        tA, tV = views
        assert tA.data_ptr() % 16 and tV.data_ptr() % 16
    return tA, tV


def _avt_close(got, want, dtype):
    if dtype == "float32":  # f32 sums of up to 320 products in another order
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    else:
        torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avt_routes_match_plain_version_on_card(dtype):
    """Runs on an H100 (``pytest -m cuda``): avt against ``ref.avt_ref`` on
    both routes (M ≤ 16 stream, M > 16 tiled), ragged N and R, stacked
    factors (G = 3), views offset by one element (the element-load
    variant), the LM head at M = 4 and 64; a second call and a CUDA graph's
    replay give the eager call's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for M in AVT_CARD_M:
        for N, R in AVT_CARD_NR:
            A, V = _avt_case(1, M, N, R, M + N + R, dtype)
            got = avt(A[0], V[0])
            assert got.shape == (M, N) and got.dtype == A.dtype
            _avt_close(got, ref.avt_ref(A[0], V[0]), dtype)
        # stacked factors: the leading axis is a grid axis
        A, V = _avt_case(3, M, 1000, 160, M, dtype)
        got = avt(A, V)
        assert got.shape == (3, M, 1000)
        _avt_close(got, ref.avt_ref(A, V), dtype)
        assert torch.equal(got, avt(A, V))  # the same bits again
        # misaligned views take the element-load variant, to the same bits
        a, v = _avt_case(1, M, 640, 320, 7 * M, dtype)
        A, V = _avt_case(1, M, 640, 320, 7 * M, dtype, misaligned=True)
        got = avt(A[0], V[0])
        _avt_close(got, ref.avt_ref(A[0], V[0]), dtype)
        assert torch.equal(got, avt(a[0], v[0]))
    # the LM head, at decode and at a prefill bucket
    for M in (4, 64):
        A, V = _avt_case(1, M, 152064, 256, M, dtype)
        _avt_close(avt(A[0], V[0]), ref.avt_ref(A[0], V[0]), dtype)
        del A, V
    # repeat bits, and a CUDA graph replaying the calls
    cases = [_avt_case(1, M, N, R, M * N, dtype) for M, N, R in
             [(4, 18944, 256), (1, 512, 64), (16, 3584, 256), (512, 640, 320), (64, 2560, 160)]]
    want = [avt(A[0], V[0]) for A, V in cases]
    assert all(torch.equal(w, avt(A[0], V[0])) for w, (A, V) in zip(want, cases))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        avt(cases[0][0][0], cases[0][1][0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [avt(A[0], V[0]) for A, V in cases]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_stacks_match_plain_version_on_card(dtype):
    """Runs on an H100 (``pytest -m cuda``): xus and avt on the MoE
    experts' G = 64 stacks at R 128 and 176 (the last column tile ragged),
    on the stream route (M 1, a decode step; M 10, a prefill's capacity)
    and the tiled one (M 64), one counted launch a call, the same bits
    again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for M in (1, 10, 64):
        for dim, R in EXPERT_SHAPES:
            x, U, S = _xus_case(EXPERTS, M, dim, R, M + dim + R, dtype, dtype)
            before = xus.launches
            got = xus(x, U, S)
            assert xus.launches == before + 1 and got.shape == (EXPERTS, M, R)
            _xus_close(got, ref.xus_ref(x, U, S), dtype)
            assert torch.equal(got, xus(x, U, S))
            A, V = _avt_case(EXPERTS, M, dim, R, M * R, dtype)
            before = avt.launches
            got = avt(A, V)
            assert avt.launches == before + 1 and got.shape == (EXPERTS, M, dim)
            _avt_close(got, ref.avt_ref(A, V), dtype)
            assert torch.equal(got, avt(A, V))
