"""The port's at-rest serving transforms against the JAX package's
``serve/quantize.py``, and its serving of the transformed trees.

On the same numpy factors: int8 ``lo`` and ``scale`` are bit-equal to the
JAX package's as its ``serve()`` computes them (eagerly), codes
are equal except ±1 at a rounding tie, the dequantized values lie within
``scale/2`` of the source and inactive columns decode to exactly 0;
``quantization_error_bound``, ``_sliced_width``, ``resident_bytes`` and
``decode_matmul_flops`` are equal; rank slicing keeps ``U S Vᵀ`` within f32
rounding (not bit for bit: the sum over the rank runs over fewer zero
terms) and drops only exactly-zero columns.

On shared llm-tiny parameters (built by the JAX package, carried through
numpy): int8, bf16, rank-sliced and materialized serving give the JAX
package's greedy tokens, with prefill logits within 1e-4 (f32). Within the
port: a trained checkpoint served factor-resident gives the materialized
path's tokens, and ``examples/configs/serve_lowrank.toml`` trains and serves.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.factorization as jfac
import repro.serve.engine as jengine
import repro.serve.quantize as jq
from repro.api import ExperimentSpec as JaxExperimentSpec
from repro.api import ModelSpec as JaxModelSpec
from repro.api import ServeSpec as JaxServeSpec
from repro.api import serve as jax_serve
from repro.checkpoint.io import _flatten
from repro_torch import api
from repro_torch.api import ExperimentSpec, ModelSpec, ServeSpec, serve
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import factorization as fac
from repro_torch.serve import engine as tengine
from repro_torch.serve import quantize as tq
from repro_torch.utils.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SERVE_KW = dict(max_batch=3, max_prompt=16, prompt_bucket=8, max_new_tokens=6)


def _np_factor(rng, n, m, w, rank, lead=()):
    """Zero-inactive-columns factor as numpy arrays (``rank`` per member)."""
    rank = np.broadcast_to(np.asarray(rank, np.float32), lead)
    mask = (np.arange(w) < rank[..., None]).astype(np.float32)
    u = rng.standard_normal(lead + (n, w)).astype(np.float32) * mask[..., None, :]
    v = rng.standard_normal(lead + (m, w)).astype(np.float32) * mask[..., None, :]
    s = (rng.standard_normal(lead + (w, w)).astype(np.float32)
         * mask[..., :, None] * mask[..., None, :])
    return dict(U=u, S=s, V=v, rank=np.array(rank, np.float32))


def _both(d):
    return (jfac.LowRankFactor(**{k: jnp.asarray(v) for k, v in d.items()}),
            fac.LowRankFactor(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()}))


CASES = [(48, 40, 16, 11, ()), (64, 24, 32, 9, ()), (96, 33, 24, 24, ()),
         (40, 56, 16, [3, 16, 7], (3,))]


@pytest.mark.parametrize("n,m,w,rank,lead", CASES, ids=lambda c: str(c))
def test_int8_codes_and_affine_parameters_match(n, m, w, rank, lead):
    d = _np_factor(np.random.default_rng(n + w), n, m, w, rank, lead)
    jf, tf = _both(d)
    # eager, as the JAX package's serve() runs quantize_params: under jit,
    # XLA rewrites (hi - lo) / 255 into (hi - lo) * (1/255), one ulp off
    jqf = jq.quantize_factor(jf)
    tqf = tq.quantize_factor(tf)
    for side in ("u", "v"):
        x = d["U" if side == "u" else "V"]
        lo, scale = getattr(tqf, f"{side}_lo").numpy(), getattr(tqf, f"{side}_scale").numpy()
        np.testing.assert_array_equal(lo, np.asarray(getattr(jqf, f"{side}_lo")))
        np.testing.assert_array_equal(scale, np.asarray(getattr(jqf, f"{side}_scale")))
        qt = getattr(tqf, f"{side}_q").numpy().astype(np.int32)
        qj = np.asarray(getattr(jqf, f"{side}_q")).astype(np.int32)
        assert getattr(tqf, f"{side}_q").dtype == torch.int8
        diff = np.abs(qt - qj)
        assert diff.max() <= 1
        # a code differs only where (x - lo) / scale sits on a rounding tie
        frac = ((x - lo) / scale) % 1.0
        assert np.all(np.abs(frac[diff == 1] - 0.5) < 1e-3)
    np.testing.assert_array_equal(tqf.S.numpy(), d["S"])
    assert tq.quantization_error_bound(tqf) == jq.quantization_error_bound(jqf)


@pytest.mark.parametrize("n,m,w,rank,lead", CASES, ids=lambda c: str(c))
def test_int8_dequantizes_within_half_a_step_with_zero_inactive_columns(n, m, w, rank, lead):
    d = _np_factor(np.random.default_rng(7 * n + w), n, m, w, rank, lead)
    _, tf = _both(d)
    qf = tq.quantize_factor(tf)
    back = tq.dequantize_factor(qf)
    active = np.arange(w) < np.asarray(d["rank"])[..., None]
    for name, scale in (("U", qf.u_scale), ("V", qf.v_scale)):
        got, src = getattr(back, name).numpy(), d[name]
        assert np.all(np.abs(got - src) <= scale.numpy() / 2 + 1e-7)
        assert np.all(got[np.broadcast_to(~active[..., None, :], got.shape)] == 0.0)
    assert tq.quantization_error_bound(qf) == float(
        max(qf.u_scale.max(), qf.v_scale.max())) / 2
    np.testing.assert_array_equal(back.S.numpy(), d["S"])


@pytest.mark.parametrize("rank,r_max", [(0, 32), (1, 32), (7, 32), (8, 32), (9, 32),
                                        (31, 32), (32, 32), (5, 4), (130, 256),
                                        ([3, 17, 9], 64)])
def test_sliced_width_matches(rank, r_max):
    r = np.asarray(rank, np.float32)
    assert tq._sliced_width(torch.from_numpy(r), r_max) == jq._sliced_width(jnp.asarray(r), r_max)


@pytest.mark.parametrize("n,m,w,rank,lead", CASES, ids=lambda c: str(c))
def test_rank_slice_keeps_the_product_and_drops_only_zero_columns(n, m, w, rank, lead):
    d = _np_factor(np.random.default_rng(3 * n + m), n, m, w, rank, lead)
    jf, tf = _both(d)
    sliced = tq.rank_slice_params({"w": tf})["w"]
    want_w = jq._sliced_width(jnp.asarray(d["rank"]), w)
    assert sliced.r_max == jq.rank_slice_params({"w": jf})["w"].r_max == want_w
    for name in ("U", "S", "V"):
        assert getattr(sliced, name).is_contiguous()
    # what was dropped was exactly zero
    assert np.all(d["U"][..., want_w:] == 0) and np.all(d["V"][..., want_w:] == 0)
    assert np.all(d["S"][..., want_w:, :] == 0) and np.all(d["S"][..., :, want_w:] == 0)
    np.testing.assert_allclose(fac.materialize(sliced).numpy(), fac.materialize(tf).numpy(),
                               rtol=1e-5, atol=1e-5)
    q = tq.quantize_params({"w": sliced}, "int8")
    assert q["w"].r_max == want_w


# ---------------------------------------------------------------------------
# whole trees: llm-tiny parameters built by the JAX package
# ---------------------------------------------------------------------------


def jax_tiny_spec(**serve_kw):
    return JaxExperimentSpec(
        name="serve-test", model=JaxModelSpec(kind="lm", preset="llm-tiny", smoke=True),
        serve=JaxServeSpec(**{**SERVE_KW, **serve_kw}),
    )


def tiny_spec(**serve_kw):
    return ExperimentSpec(
        name="serve-test", model=ModelSpec(kind="lm", preset="llm-tiny", smoke=True),
        serve=ServeSpec(**{**SERVE_KW, **serve_kw}),
    )


def prompts_for(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=int(rng.integers(3, 16))).astype(np.int32)
            for _ in range(n)]


def _with_lower_ranks(jparams):
    """The JAX package's fresh params with every factor's active rank cut to
    about 3/8 of r_max (inactive columns and S blocks zeroed), so rank
    slicing has columns to drop."""

    def one(f):
        if not jfac.is_factor(f):
            return f
        r = max(3 * f.r_max // 8, 1)
        m = jfac.rank_mask(jnp.full(f.rank.shape, float(r), jnp.float32), f.r_max)
        return jfac.LowRankFactor(U=f.U * m[..., None, :].astype(f.U.dtype),
                                  S=jfac.mask_coeff(f.S, m.astype(f.S.dtype)),
                                  V=f.V * m[..., None, :].astype(f.V.dtype),
                                  rank=jnp.full(f.rank.shape, float(r), jnp.float32))

    return jax.tree.map(one, jparams, is_leaf=jfac.is_factor)


@pytest.fixture(scope="module")
def shared():
    """(JAX params, the same params carried into the port)."""
    params = _with_lower_ranks(jax_serve(jax_tiny_spec()).engine.params)
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return params, flat


def _port(flat):
    return params_from_numpy(flat, "cpu")


@pytest.mark.parametrize("mode", ["none", "bf16", "int8", "sliced", "sliced+int8"])
def test_resident_bytes_match(shared, mode):
    jparams, flat = shared
    tparams = _port(flat)
    if mode.startswith("sliced"):
        jparams, tparams = jq.rank_slice_params(jparams), tq.rank_slice_params(tparams)
    quant = mode.split("+")[-1] if mode != "sliced" else "none"
    jparams, tparams = jq.quantize_params(jparams, quant), tq.quantize_params(tparams, quant)
    assert tq.resident_bytes(tparams) == jq.resident_bytes(jparams)


@pytest.mark.parametrize("factor_resident", [True, False])
@pytest.mark.parametrize("mode", ["none", "int8", "sliced"])
def test_decode_matmul_flops_match(shared, mode, factor_resident):
    jparams, flat = shared
    tparams = _port(flat)
    if mode == "sliced":
        jparams, tparams = jq.rank_slice_params(jparams), tq.rank_slice_params(tparams)
    elif mode == "int8":
        jparams, tparams = jq.quantize_params(jparams, "int8"), tq.quantize_params(tparams, "int8")
    got = tengine.decode_matmul_flops(tparams, factor_resident=factor_resident)
    assert got == jengine.decode_matmul_flops(jparams, factor_resident=factor_resident) > 0


SERVE_MODES = {"int8": dict(quantize="int8"), "bf16": dict(quantize="bf16"),
               "rank_slice": dict(rank_slice=True), "materialize": dict(materialize=True),
               "rank_slice+int8": dict(rank_slice=True, quantize="int8")}


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_transformed_serving_matches_jax(shared, mode):
    jparams, flat = shared
    kw = SERVE_MODES[mode]
    jsess = jax_serve(jax_tiny_spec(**kw), params=jparams)
    tsess = serve(tiny_spec(**kw), params=_port(flat), device="cpu")
    for p in prompts_for(n=2, seed=11):
        jl, _ = jsess.engine.prefill(p)
        tl, _ = tsess.engine.prefill(p)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    prompts = prompts_for(n=4, seed=12)
    want, _ = jsess.generate(prompts, arrival_steps=[0, 0, 1, 3])
    got, _ = tsess.generate(prompts, arrival_steps=[0, 0, 1, 3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    if mode == "materialize":
        assert tsess.engine.decode_flops_per_token() is None
    else:
        assert tsess.engine.decode_flops_per_token() == jsess.engine.decode_flops_per_token()
    assert "quantize=" in tsess.describe()


def test_int8_leaves_stay_int8_and_bf16_leaves_bf16(shared):
    _, flat = shared
    q = serve(tiny_spec(quantize="int8"), params=_port(flat), device="cpu").engine.params
    qleaves = [x for x in tree_leaves(q, is_leaf=tq.is_quantized) if tq.is_quantized(x)]
    assert qleaves and all(x.u_q.dtype == torch.int8 and x.S.dtype == torch.float32
                           for x in qleaves)
    b = serve(tiny_spec(quantize="bf16"), params=_port(flat), device="cpu").engine.params
    bleaves = [x for x in tree_leaves(b, is_leaf=fac.is_factor) if fac.is_factor(x)]
    assert bleaves and all(x.U.dtype == torch.bfloat16 and x.S.dtype == torch.float32
                           for x in bleaves)


# ---------------------------------------------------------------------------
# train → serve within the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_spec(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("serve_ckpt"))
    spec = ExperimentSpec.from_dict({
        "name": "serve-roundtrip", "rounds": 2,
        "model": {"kind": "lm", "preset": "llm-tiny", "smoke": True},
        "data": {"kind": "token_stream", "tokens_per_client": 2048, "batch": 4, "seq": 32},
        "fed": {"method": "fedlrt", "clients": 2, "local_steps": 2},
        "checkpoint": {"dir": ckpt, "every": 1},
        "serve": {"checkpoint": ckpt, "max_batch": 2, "max_prompt": 16, "prompt_bucket": 8,
                  "max_new_tokens": 5},
    })
    api.build(spec, device="cpu").run(log_every=0)
    return spec


def test_trained_checkpoint_factor_resident_equals_dense(trained_spec):
    prompts = prompts_for(n=3, seed=2)
    factor_sess = serve(trained_spec, device="cpu")
    dense_sess = serve(dataclasses.replace(
        trained_spec, serve=dataclasses.replace(trained_spec.serve, materialize=True)),
        device="cpu")
    f_outs, _ = factor_sess.generate(prompts)
    d_outs, _ = dense_sess.generate(prompts)
    for a, b in zip(f_outs, d_outs):
        np.testing.assert_array_equal(a, b)
    params = factor_sess.engine.params
    assert tengine.decode_matmul_flops(params, factor_resident=True) < \
        tengine.decode_matmul_flops(params, factor_resident=False)
    assert factor_sess.engine.decode_flops_per_token() is not None
    assert dense_sess.engine.decode_flops_per_token() is None


def test_experiment_serve_inprocess(trained_spec):
    exp = api.build(trained_spec, device="cpu")
    exp.resume()
    assert exp.is_simulated is False
    prompts = prompts_for(n=2, seed=4)
    live, _ = exp.serve().generate(prompts)
    ckpt, _ = serve(trained_spec, device="cpu").generate(prompts)
    for a, b in zip(live, ckpt):
        np.testing.assert_array_equal(a, b)


def test_serve_lowrank_example_trains_and_serves_on_cpu(tmp_path, capsys):
    from repro_torch.api.__main__ import main as api_main

    path = REPO / "examples" / "configs" / "serve_lowrank.toml"
    sets = ["--set", f"checkpoint.dir={tmp_path}", "--set", f"serve.checkpoint={tmp_path}"]
    assert api_main(["run", str(path), "--device", "cpu", *sets]) == 0
    assert sorted(p.name for p in tmp_path.glob("round_*.npz")) == [
        "round_000001.npz", "round_000002.npz"]
    assert api_main(["serve", str(path), "--device", "cpu", "--requests", "3", *sets]) == 0
    out = capsys.readouterr().out
    assert "rank_slice" in out and "3 requests" in out


@pytest.mark.parametrize("R", [8, 128, 160])
@pytest.mark.parametrize("M", [1, 4, 16, 64])
def test_kernel_plans_at_sliced_widths(M, R):
    """Rank slicing leaves R a multiple of 8 (the 16-byte-load condition of
    both wrappers, in bf16 and f32), and ``xus_plan`` / ``avt_plan`` plan
    the sliced widths like the full ones: the stream route at M <= 16, one
    launch (xus with S tiled: two), every element of K covered once."""
    from repro_torch.kernels.lowrank_matmul import avt_plan, xus_plan

    assert R % 8 == 0 and tq._sliced_width(torch.tensor(float(R - 3)), 256) == R
    for K in (R, 3584, 18944):
        for has_s in (True, False):
            p = xus_plan(1, M, K, R, has_s)
            assert p.route == ("stream" if M <= 16 else "tiled")
            assert p.launches == (2 if p.route == "tiled" and has_s else 1)
            assert (p.splits - 1) * p.kc < K <= p.splits * p.kc
    for N in (512, 3584, 18944, 152064):
        p = avt_plan(1, M, N, R)
        assert p.route == ("stream" if M <= 16 else "tiled") and p.launches == 1
        assert p.workspace == p.counters == 0
