"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py``, on shared numpy inputs, in f32 on the CPU.

Parameters are the JAX package's reduced OLMoE-1B-7B and DeepSeekMoE-16B
(4 experts, top-2; DeepSeekMoE with its shared experts), carried through
``params_from_numpy``; the JAX side runs under ``jit`` with its plain
chain (``kernels="off"``), the port with ``"auto"`` (the kernels' plain
versions on CPU tensors) unless a test says otherwise.

DeepSeekMoE's shared experts (three dense factors a layer beside the
routed experts, ``moe._shared_ffn``) are held in the block's output, in the
gradients of their U, S and V, and in a FeDLRT round's ranks and ``U S
Vᵀ``; the card's check of them (``chip_smoke.shared_against_off``) runs
here on the plain versions.

Tolerances: the block's output within 1e-5 of its largest entry (f32 sums
in another order; the random experts' outputs reach ~20), its auxiliary
loss 1e-6 relative; expert choices and the dispatched token sets
identical. Routing is held away from top-k ties: each test asserts its
smallest top-k margin, so that a reseed cannot hide a flip behind a tie.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.factorization as jfac
import repro.models.moe as jmoe
import repro.serve.engine as jengine
import repro.serve.quantize as jq
from repro.checkpoint.io import _flatten
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.config import reduced as jax_reduced
from repro.models.transformer import stack_apply as jax_stack_apply
from repro_torch import api
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import factorization as fac
from repro_torch.models import build_model, moe, reduced
from repro_torch.models.transformer import _layer, stack_apply
from repro_torch.serve import ContinuousScheduler, Request, ServeEngine
from repro_torch.serve import engine as tengine
from repro_torch.serve import quantize as tq
from repro_torch.utils.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: F401
from torch_train_common import chip_smoke

ARCHS = ["olmoe-1b-7b", "deepseek-moe-16b"]
#: the shared experts' leaves of a MoE block (DeepSeekMoE only)
SHARED = ("shared_up", "shared_gate", "shared_down")
Y_RTOL = 1e-5
AUX_RTOL = 1e-6
#: the smallest gap between the k-th and the (k+1)-th router probability
#: the inputs must keep: far above the ~1e-7 the two packages' f32 sums
#: differ by, so no choice can flip between them
MIN_MARGIN = 1e-5


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module", params=ARCHS)
def built(request):
    """(JAX config, port config, JAX params, flat numpy params, port params)
    of the reduced architecture."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(request.param)), kernels="off")
    tcfg = reduced(get_config(request.param))
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    return jcfg, tcfg, jparams, flat, params_from_numpy(flat, "cpu")


def _block0(jparams, tparams):
    """Layer 0's MoE parameters in both packages."""
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["moe"])
    return jp, _layer(tparams["blocks"]["pos0"]["moe"], 0)


def _jax_routing(p, x, cfg):
    """The JAX package's routing, line for line from ``moe_block`` (which
    does not return it): router probabilities, top-k experts, dispatch."""
    m = cfg.moe
    B, T, d = x.shape
    N = B * T
    xf = x.reshape(N, d)
    E, k = m.num_experts, m.top_k
    cap = min(max(int(m.capacity_factor * k * N / E), 1), N)
    logits = (xf @ p["router"].astype(xf.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    topv, topi = jax.lax.top_k(probs, k)
    gates = topv / (jnp.sum(topv, axis=-1, keepdims=True) + 1e-9)
    chose = jnp.zeros((N, E), jnp.float32).at[jnp.arange(N)[:, None], topi].set(gates)
    prio = jnp.where(chose > 0, jnp.arange(N, dtype=jnp.int32)[:, None], N)
    take = jnp.argsort(prio, axis=0)[:cap]
    return probs, topi, take, jnp.take_along_axis(chose, take, axis=0)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=Y_RTOL * np.abs(want).max())


def _min_margin(probs, k):
    ranked = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    return float(np.min(ranked[:, k - 1] - ranked[:, k]))


def _record_routing(monkeypatch):
    """Collect the :class:`~repro_torch.models.moe.Routing` of every
    ``moe_block`` call, in call order."""
    log, route = [], moe.route

    def recording(*args):
        log.append(route(*args))
        return log[-1]

    monkeypatch.setattr(moe, "route", recording)
    return log


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_block_matches(built, cf, monkeypatch):
    """At a capacity that never binds (8.0) and at one that drops
    assignments (0.5): the output, the auxiliary loss, the expert choices
    and the token set dispatched to every expert."""
    jcfg, tcfg, jparams, _, tparams = built
    jcfg, tcfg = _with_cf(jcfg, cf), _with_cf(tcfg, cf)
    jp, tp = _block0(jparams, tparams)
    x = np.random.default_rng(1).standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_block(p, x, jcfg))(jp, jnp.asarray(x))
    probs, topi, take, w_taken = jax.jit(lambda p, x: _jax_routing(p, x, jcfg))(
        jp, jnp.asarray(x))
    log = _record_routing(monkeypatch)
    ty, taux = moe.moe_block(tp, torch.from_numpy(x), tcfg)
    [r] = log
    assert _min_margin(probs, tcfg.moe.top_k) > MIN_MARGIN
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(topi))
    assert r.cap == take.shape[0]
    for e in range(tcfg.moe.num_experts):
        assert set(r.take[:, e].tolist()) == set(np.asarray(take)[:, e].tolist())
    np.testing.assert_array_equal(r.take.numpy(), np.asarray(take))
    # the gates: f32 softmaxes of logits that differ in their last bits
    np.testing.assert_allclose(r.w_taken.numpy(), np.asarray(w_taken), rtol=1e-6, atol=0)
    n_assigned = x.shape[0] * x.shape[1] * tcfg.moe.top_k
    kept = int((r.w_taken > 0).sum())
    assert (kept < n_assigned) if cf < 1 else (kept == n_assigned)


@pytest.mark.parametrize("kernels", ["auto", "off"])
def test_stacked_linear_matches(built, kernels):
    """An expert projection through ``_stacked_linear`` (``lr_matmul`` on
    the stacked factor, the experts as the chain's grid axis) and a dense
    stacked weight."""
    jcfg, tcfg, jparams, _, tparams = built
    jp, tp = _block0(jparams, tparams)
    E, d = tcfg.moe.num_experts, tcfg.d_model
    xe = np.random.default_rng(2).standard_normal((E, 5, d)).astype(np.float32)
    for name in ("up", "gate"):
        assert fac.is_factor(tp[name]) and tp[name].U.shape[0] == E
        want = jax.jit(lambda w, x: jmoe._stacked_linear(w, x, "off"))(jp[name], jnp.asarray(xe))
        got = moe._stacked_linear(tp[name], torch.from_numpy(xe), kernels)
        _close(got, want)
    w = np.random.default_rng(3).standard_normal((E, d, 7)).astype(np.float32)
    want = jmoe._stacked_linear(jnp.asarray(w), jnp.asarray(xe), "off")
    _close(moe._stacked_linear(torch.from_numpy(w), torch.from_numpy(xe), kernels), want)


def test_loss_with_aux_matches(built):
    """The model's loss with its auxiliary term, and the stack's aux alone:
    the f32 sum over the layers of each MoE block's."""
    jcfg, tcfg, jparams, _, tparams = built
    tokens = np.random.default_rng(4).integers(1, tcfg.vocab_size, size=(2, 13))
    jl = jax.jit(jax_build_model(jcfg).loss_fn)(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tl = build_model(tcfg).loss_fn(tparams, {"tokens": torch.from_numpy(tokens)})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    h = np.random.default_rng(6).standard_normal((2, 13, tcfg.d_model)).astype(np.float32)
    pos = np.arange(13)
    jh, _, jaux = jax.jit(lambda b, h: jax_stack_apply(b, h, jcfg, positions=jnp.asarray(pos)))(
        jparams["blocks"], jnp.asarray(h))
    with torch.no_grad():
        th, _, taux = stack_apply(tparams["blocks"], torch.from_numpy(h), tcfg,
                                  positions=torch.from_numpy(pos), with_aux=True)
        _, _, no_aux = stack_apply(tparams["blocks"], torch.from_numpy(h), tcfg,
                                   positions=torch.from_numpy(pos))
    _close(th, jh)
    assert float(jaux) > 0.01 * tcfg.num_layers  # 0.01 · E · Σ frac · p ≥ 0.01 a layer
    assert taux.dtype == torch.float32
    assert abs(float(taux) - float(jaux)) <= AUX_RTOL * float(jaux)
    assert no_aux == 0  # serving's forward computes no aux


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_block_gradient_matches(built, cf):
    """The gradient of the block's output and aux loss with respect to its
    input, its router and its expert factors: the dispatch and the combine
    take each other's gathers as their backward, where the JAX package
    differentiates a gather and a scatter-add. Within 1e-5 of each
    gradient's largest entry."""
    jcfg, tcfg, jparams, _, tparams = built
    jcfg, tcfg = _with_cf(jcfg, cf), _with_cf(tcfg, cf)
    jp, tp = _block0(jparams, tparams)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    c = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_block(p, x, jcfg)
        return jnp.sum(y * c) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = {"router": tp["router"]} | {n: tp[n].U for n in ("up", "gate", "down")}
    # the shared experts (DeepSeekMoE): dense factors beside the routed
    # experts, every factor tensor differentiated
    shared = [n for n in SHARED if n in tp]
    assert len(shared) == (3 if tcfg.moe.num_shared_experts else 0)
    leaves |= {(n, part): getattr(tp[n], part) for n in shared for part in ("U", "S", "V")}
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        y, aux = moe.moe_block(tp, tx, tcfg)
        torch.autograd.backward(torch.sum(y * torch.from_numpy(c)) + aux)
        _close(tx.grad, jgx)
        _close(leaves["router"].grad, jgp["router"])
        for n in ("up", "gate", "down"):
            _close(leaves[n].grad, jgp[n].U)
        for n in shared:
            for part in ("U", "S", "V"):
                _close(leaves[n, part].grad, getattr(jgp[n], part))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
            t.grad = None


@pytest.mark.parametrize("arch", ARCHS)
def test_fedlrt_round_of_moe_matches(arch):
    """One FeDLRT round of the reduced architecture through both packages'
    ``build(spec)``: every expert factor (a (layers, experts) stack)
    augmented and truncated per member, the router trained as a dense
    leaf, the aux loss in the client loss; DeepSeekMoE's shared experts
    (three (layers,) stacks of dense factors) held like every other
    factor: their ranks and ``U S Vᵀ``."""
    kw = dict(rounds=1, log_every=0)
    sections = dict(
        model=("ModelSpec", dict(arch=arch, smoke=True)),
        data=("DataSpec", dict(tokens_per_client=1200, seq=24)),
        fed=("FedSpec", dict(local_steps=2, tau=0.05)),
    )
    jspec, tspec = (pkg.ExperimentSpec(**kw, **{k: getattr(pkg, s)(**f)
                                                for k, (s, f) in sections.items()})
                    for pkg in (japi, api))
    jexp = japi.build(jspec)
    flat = {k: np.asarray(v) for k, v in _flatten(jexp.engine.params).items()}
    texp = api.build(tspec, params=params_from_numpy(flat, "cpu"), device="cpu")
    [jr], [tr] = jexp.run(1), texp.run(1)
    assert abs(tr.loss_before - jr.loss_before) <= 1e-5 * abs(jr.loss_before)
    assert abs(tr.loss_after - jr.loss_after) <= 1e-4 * abs(jr.loss_after)
    assert tr.comm_bytes_per_client == jr.comm_bytes_per_client
    assert jr.ranks.keys() == tr.ranks.keys()
    assert any("moe" in k for k in tr.ranks)
    shared = [k for k in tr.ranks if any(f"['{n}']" in k for n in SHARED)]
    assert len(shared) == (3 if arch == "deepseek-moe-16b" else 0)
    for k in jr.ranks:
        np.testing.assert_array_equal(tr.ranks[k], jr.ranks[k])
    jfs = [f for f in jax.tree.leaves(jexp.engine.params, is_leaf=jfac.is_factor)
           if jfac.is_factor(f)]
    tfs = [f for f in tree_leaves(texp.engine.params, is_leaf=fac.is_factor) if fac.is_factor(f)]
    assert len(jfs) == len(tfs)
    for jf, tf in zip(jfs, tfs):
        want = np.asarray(jfac.materialize(jf))
        err = np.abs(fac.materialize(tf).numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4


@pytest.mark.parametrize("kernels", ["auto", "off"])
def test_shared_ffn_is_the_inline_chain(built, kernels, monkeypatch):
    """``moe_block`` adds ``_shared_ffn`` of the flattened tokens to the
    routed experts' output, bit for bit the gated chain it factors out
    (``silu(x gate) * (x up)`` through ``down``), once a block; a block
    without shared experts (OLMoE) never calls it."""
    _, tcfg, _, _, tparams = built
    tcfg = dataclasses.replace(tcfg, kernels=kernels)
    tp = _layer(tparams["blocks"]["pos0"]["moe"], 0)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 8, tcfg.d_model))
                         .astype(np.float32))
    seen, shared_ffn = [], moe._shared_ffn

    def counted(p, xf, cfg):
        seen.append(tuple(xf.shape))
        return shared_ffn(p, xf, cfg)

    monkeypatch.setattr(moe, "_shared_ffn", counted)
    y, _ = moe.moe_block(tp, x, tcfg)
    if not tcfg.moe.num_shared_experts:
        assert not seen and not any(n in tp for n in SHARED)
        return
    assert seen == [(16, tcfg.d_model)]
    routed, _ = moe.moe_block({k: v for k, v in tp.items() if k not in SHARED}, x, tcfg)
    xf = x.reshape(16, tcfg.d_model)
    lin = moe._dense_linear
    hs = torch.nn.functional.silu(lin(tp["shared_gate"], xf, kernels)) * lin(
        tp["shared_up"], xf, kernels)
    inline = routed.reshape(16, -1) + lin(tp["shared_down"], hs, kernels)
    assert torch.equal(y, inline.reshape(y.shape))
    assert not torch.equal(y, routed)


def test_chip_shared_check_holds_and_tells_a_wrong_chain(monkeypatch):
    """``chip_smoke.shared_against_off`` (``[train-deepseek shared]``) on
    the CPU at reduced DeepSeekMoE: the kernels' plain versions meet its
    limit; a kernel path 1e-3 off (every shared projection with kernels
    scaled) fails it, so the card's check can tell a wrong chain."""
    smoke = chip_smoke()
    cfg = reduced(get_config("deepseek-moe-16b"))
    with torch.no_grad():
        params, _ = build_model(cfg).init(torch.Generator().manual_seed(0))
    p = _layer(params["blocks"]["pos0"]["moe"], 0)
    out = smoke.shared_against_off(torch, cfg, p, 64, 11, device="cpu")
    assert len(out["errs"]) == 11 and max(out["errs"].values()) <= smoke.SHARED_RTOL
    lin = moe._dense_linear
    monkeypatch.setattr(moe, "_dense_linear",
                        lambda w, x, k: lin(w, x, k) * (1.001 if k != "off" else 1.0))
    with pytest.raises(AssertionError, match="miss the plain chain"):
        smoke.shared_against_off(torch, cfg, p, 64, 11, device="cpu")


def test_chip_pair_gate_tells_an_unexplained_flip(monkeypatch):
    """``chip_smoke._kernels_against_off`` with near-ties (the MoE phases'
    f32 pair) on the CPU: after the basis pass, a choice that differs where
    its call's router probabilities drifted past half its margin passes;
    one that differs where the probabilities agree fails. The factors'
    ``U S Vᵀ`` readings, taken on the card, are stubbed as equal."""
    smoke = chip_smoke()
    monkeypatch.setattr(smoke, "_factors", lambda p: [("['up']", fac.LowRankFactor(
        U=torch.zeros(1, 2, 4, 2), S=torch.zeros(1, 2, 2, 2), V=torch.zeros(1, 2, 4, 2),
        rank=torch.ones(1, 2)))])
    monkeypatch.setattr(smoke, "_usvt_gaps", lambda torch, f, g, f0: (0.0, 1.0, 1.0))
    m = reduced(get_config("deepseek-moe-16b")).moe
    gen = torch.Generator().manual_seed(0)
    x, router = torch.randn(32, 8, generator=gen), torch.randn(8, m.num_experts, generator=gen)
    start = moe.route(router, x, m)
    res = types.SimpleNamespace(loss_before=1.0, loss_after=1.0, ranks={})

    def pair(later_on, later_off):
        return smoke._kernels_against_off(torch, "[t]", None, (None, res, [start, later_on]),
                                          (None, res, [start, later_off]), m, near_ties=True,
                                          same_start=1)

    # the kernel run's router moved: every changed choice within its drift
    moved = moe.route(router + 0.3 * torch.randn(router.shape, generator=gen), x, m)
    out = pair(moved, start)
    assert out["flips"] > 0 and 0 < out["worst_margin_of_drift"] <= 1
    # the same probabilities, one token's choices swapped for others
    topi = start.topi.clone()
    topi[0] = torch.argsort(start.probs[0])[:m.top_k]
    with pytest.raises(AssertionError, match="over twice its call's largest probability gap"):
        pair(start._replace(topi=topi), start)


def test_stacked_expert_factor_at_rest(built):
    """A (layers, experts) stack of expert factors, with member ranks that
    differ: int8 ``lo`` / ``scale`` bit-equal to the JAX package's (eager,
    as its ``serve()`` runs), codes within ±1; bf16 bases bit-equal; rank
    slicing to the largest member's rank; ``decode_matmul_flops`` pricing
    every member."""
    _, _, jparams, flat, _ = built
    key = "blocks|pos0|moe|up"
    d = {f: np.array(flat[f"{key}@{f}"]) for f in ("U", "S", "V", "rank")}
    NB, E, _, w = d["U"].shape
    rank = np.arange(NB * E, dtype=np.float32).reshape(NB, E) % (w - 4) + 3
    m = (np.arange(w) < rank[..., None]).astype(np.float32)
    d = dict(U=d["U"] * m[..., None, :], S=d["S"] * m[..., :, None] * m[..., None, :],
             V=d["V"] * m[..., None, :], rank=rank)
    jf = jfac.LowRankFactor(**{k: jnp.asarray(v) for k, v in d.items()})
    tf = fac.LowRankFactor(**{k: torch.from_numpy(v) for k, v in d.items()})
    jqf, tqf = jq.quantize_factor(jf), tq.quantize_factor(tf)
    for side in ("u", "v"):
        for part in ("lo", "scale"):
            np.testing.assert_array_equal(getattr(tqf, f"{side}_{part}").numpy(),
                                          np.asarray(getattr(jqf, f"{side}_{part}")))
        diff = np.abs(getattr(tqf, f"{side}_q").numpy().astype(np.int32)
                      - np.asarray(getattr(jqf, f"{side}_q")).astype(np.int32))
        assert diff.max() <= 1
    jb, tb = jq.quantize_params({"w": jf}, "bf16")["w"], tq.quantize_params({"w": tf}, "bf16")["w"]
    for name in ("U", "V"):
        assert getattr(tb, name).dtype == torch.bfloat16
        np.testing.assert_array_equal(getattr(tb, name).float().numpy(),
                                      np.asarray(getattr(jb, name), np.float32))
    sliced = tq.rank_slice_params({"w": tf})["w"]
    width = -(-int(rank.max()) // 8) * 8  # the largest member's rank, to a multiple of 8
    assert sliced.r_max == jq.rank_slice_params({"w": jf})["w"].r_max == width < w
    np.testing.assert_allclose(fac.materialize(sliced).numpy(), fac.materialize(tf).numpy(),
                               rtol=1e-5, atol=1e-5)
    tparams = params_from_numpy(flat, "cpu")
    for fr in (True, False):
        assert tengine.decode_matmul_flops(tparams, factor_resident=fr) == \
            jengine.decode_matmul_flops(jparams, factor_resident=fr)


def test_continuous_serving_matches_single_sequences_when_capacity_never_binds():
    """The port's continuous ≡ single-sequence pin, for reduced OLMoE at
    capacity factor 8.0: every expert can take every token of a decode
    batch and of a prefill bucket, so no token's output depends on its
    neighbours (at 1.25 the capacity binds and it does, in both packages)."""
    cfg = _with_cf(reduced(get_config("olmoe-1b-7b")), 8.0)
    model = build_model(cfg)
    with torch.no_grad():
        params, _ = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, max_batch=3, max_prompt=16, prompt_bucket=8,
                      max_new_tokens=5)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (3, 9, 5, 14)]
    comps = ContinuousScheduler(eng).run([
        Request(rid=i, tokens=p.astype(np.int32), arrival_step=step)
        for i, (p, step) in enumerate(zip(prompts, [0, 0, 1, 3]))
    ])
    assert any(c.admit_step > 0 for c in comps)
    for c in comps:
        p = prompts[c.rid]
        with torch.inference_mode():
            logits, cache = model.serve_prefill(params, {"tokens": torch.from_numpy(p)[None]},
                                                cache_len=len(p) + 5)
            want = [int(torch.argmax(logits, -1)[0])]
            for _ in range(4):
                logits, cache = model.serve_step(params, cache, torch.tensor([[want[-1]]]))
                want.append(int(torch.argmax(logits, -1)[0]))
        assert c.tokens.tolist() == want
