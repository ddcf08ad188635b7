"""The port's Mamba and RWKV6 mixers (``repro_torch.models.ssm``) and the
two architectures built on them, against the JAX package, on shared numpy
inputs in f32 on the CPU.

Parameters are reduced RWKV6-7B's and Jamba-1.5-Large's (Jamba's MoE at
capacity factor 8.0, as ``tests/test_archs.py`` sets it, so no assignment
is ever dropped), drawn once, with every dense vector perturbed from a
numpy seed so that each one matters, and read by both packages from one
npz in the JAX package's layout. The JAX side runs under ``jit`` on its plain chain
(``kernels="off"``); the port runs ``"auto"``, the kernels' plain versions
on CPU tensors.

Tolerances: the recurrence and the mixers within 1e-5 of each output's
largest entry (f32 sums in another order: the doubling scan against
``associative_scan``, the wkv's einsums); the loss 1e-5 relative; logits
1e-4 absolute with greedy tokens identical; a FeDLRT round's losses 1e-5 /
1e-4 relative and every factor's ``U S Vᵀ`` 1e-4 of its largest entry,
ranks equal.
"""
import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.factorization as jfac
import repro.models.ssm as jssm
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint.io import _flatten
from repro.configs import get_config as jax_get_config
from repro.core import FedConfig as JFedConfig
from repro.core.fedlrt import fedlrt_round as jfedlrt_round
from repro.models import build_model as jax_build_model
from repro.models.config import reduced as jax_reduced
from repro.serve import ContinuousScheduler as JContinuousScheduler
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.engine import _insert_cache as jax_insert_cache
from repro_torch.checkpoint import params_from_numpy
from repro_torch.checkpoint.io import _flatten as torch_flatten
from repro_torch.configs import get_config
from repro_torch.core import factorization as fac
from repro_torch.core.fedlrt import fedlrt_round
from repro_torch.core.round import FedConfig, value_and_grad
from repro_torch.models import build_model, reduced, ssm
from repro_torch.models.transformer import _layer
from repro_torch.serve import ContinuousScheduler, Request, ServeEngine
from repro_torch.serve.engine import _insert_cache
from repro_torch.utils.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: F401

ARCHS = ["rwkv6-7b", "jamba-1.5-large-398b"]
MIX_RTOL = 1e-5
LOSS_RTOL = 1e-5
LOGIT_ATOL = 1e-4
#: the dense leaves given noise, so that a swapped or ignored one shows
PERTURB = {"ln1", "ln2", "final_norm", "ln_x", "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0",
           "u", "D", "dt_bias", "A_log", "conv_w"}
SERVE = dict(max_batch=2, max_prompt=16, prompt_bucket=8, max_new_tokens=4)


def _configs(arch):
    jcfg, tcfg = (red(get(arch)) for red, get in
                  ((jax_reduced, jax_get_config), (reduced, get_config)))
    if tcfg.moe is not None:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=8.0))
                      for c in (jcfg, tcfg))
    jcfg = dataclasses.replace(jcfg, kernels="off")
    assert {**dataclasses.asdict(tcfg), "kernels": "off"} == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _carry(jparams):
    return params_from_numpy({k: np.asarray(v) for k, v in _flatten(jparams).items()}, "cpu")


@functools.lru_cache(maxsize=None)
def _built(arch):
    """Parameters drawn by the port (the JAX package's eager ``init`` of
    reduced Jamba takes ~13 s on the CPU), every dense vector in
    ``PERTURB`` given noise from a numpy seed, and the same npz read by
    both packages."""
    jcfg, tcfg = _configs(arch)
    model = build_model(tcfg)
    with torch.no_grad():
        params, _ = model.init(torch.Generator().manual_seed(0))
    flat = {k: v.numpy() for k, v in torch_flatten(params).items()}
    rng = np.random.default_rng(0)
    for k in sorted(flat):
        if k.rsplit("|", 1)[-1] in PERTURB:
            flat[k] = flat[k] + 0.1 * rng.standard_normal(flat[k].shape).astype(flat[k].dtype)
    with tempfile.TemporaryDirectory(prefix="ssm_params_") as d:
        path = os.path.join(d, "round_000000.npz")
        np.savez(path, __meta__=np.frombuffer(b"{}", np.uint8), **flat)
        jparams, _ = jax_load_checkpoint(path)
    return jax_build_model(jcfg), jparams, model, params_from_numpy(flat, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def built(request):
    """(JAX model, JAX params, port model, port params) of the reduced
    architecture."""
    return _built(request.param)


def _rel_close(got, want, rtol=MIX_RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _logits_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(t.argmax(-1).numpy(), np.asarray(j).argmax(-1))


# ---------------------------------------------------------------------------
# the recurrence and the mixers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 24])
def test_linear_recurrence_and_its_gradient_match(T):
    rng = np.random.default_rng(1)
    a = rng.uniform(0.5, 1.0, (2, T, 6, 4)).astype(np.float32)
    b, ct = (rng.standard_normal((2, T, 6, 4)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    def fwd_bwd(a, b, h0, ct):
        h, vjp = jax.vjp(jssm.linear_recurrence, a, b, h0)
        return h, vjp(ct)

    jh, jgrads = jax.jit(fwd_bwd)(*map(jnp.asarray, (a, b, h0, ct)))
    ta, tb, th0 = (torch.from_numpy(v).requires_grad_(True) for v in (a, b, h0))
    th = ssm.linear_recurrence(ta, tb, th0)
    _rel_close(th, jh)
    for got, want in zip(torch.autograd.grad(th, (ta, tb, th0), torch.from_numpy(ct)), jgrads):
        _rel_close(got, want)


@functools.lru_cache(maxsize=None)
def _mixer_params(kind):
    """Layer 0's mixer in both packages, Mamba's scan in chunks of 8 and
    RWKV's wkv in chunks of 16."""
    arch = "jamba-1.5-large-398b" if kind == "mamba" else "rwkv6-7b"
    jcfg, tcfg = _configs(arch)
    if kind == "mamba":
        jcfg, tcfg = (dataclasses.replace(c, mamba=dataclasses.replace(c.mamba, scan_chunk=8))
                      for c in (jcfg, tcfg))
    assert tcfg.block_pattern[0] == kind and (kind == "mamba" or tcfg.rwkv.chunk_len == 16)
    _, jparams, _, tparams = _built(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"][kind])
    return jcfg, tcfg, jp, _layer(tparams["blocks"]["pos0"][kind], 0)


def _mixer_case(kind, T, with_state):
    """The mixer's parameters, an input and a random state: at T = 24 and
    21 both scans carry across chunks, and 21 leaves each a ragged last
    chunk."""
    jcfg, tcfg, jp, tp = _mixer_params(kind)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, T, tcfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        init = ssm.mamba_init_state if kind == "mamba" else ssm.rwkv_init_state
        state = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in init(tcfg, 2, torch.float32, "cpu").items()}
    return jcfg, tcfg, jp, tp, x, state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [24, 21])
@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_mixer_matches(kind, T, with_state):
    jcfg, tcfg, jp, tp, x, state = _mixer_case(kind, T, with_state)
    jmix, tmix = (jssm.mamba_mix, ssm.mamba_mix) if kind == "mamba" else (jssm.rwkv_mix,
                                                                           ssm.rwkv_mix)
    jy, jstate = jax.jit(lambda p, x, s: jmix(p, x, jcfg, state=s))(
        jp, jnp.asarray(x), None if state is None else jax.tree.map(jnp.asarray, state))
    with torch.no_grad():
        ty, tstate = tmix(tp, torch.from_numpy(x), tcfg,
                          state=None if state is None else
                          {k: torch.from_numpy(v) for k, v in state.items()})
    _rel_close(ty, jy)
    assert (tstate is None) == (jstate is None) == (state is None)
    for k in state or ():
        assert tstate[k].dtype == torch.float32
        _rel_close(tstate[k], jstate[k])


@pytest.mark.parametrize("T", [37, 16])
def test_mamba_state_scan_matches_the_reference_and_the_step_loop(T, monkeypatch):
    """The state branch at T > 1 is the chunked scan from ``state["h"]``
    (chunks of 8: T 37 ends on a chunk of 5 padded with 3 zero steps, T 16
    on two whole chunks). Output and new state within 1e-5 of their
    largest entry of the reference's sequential ``lax.scan`` and of the
    port's token-by-token loop (``ssm._stepped_recurrence`` in the scan's
    place); the new ``h`` is the true last step's, not one past the
    padding."""
    jcfg, tcfg, jp, tp, x, state = _mixer_case("mamba", T, True)
    jy, jstate = jax.jit(lambda p, x, s: jssm.mamba_mix(p, x, jcfg, state=s))(
        jp, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    with torch.no_grad():
        ty, new = ssm.mamba_mix(tp, torch.from_numpy(x), tcfg, state=tstate)
        monkeypatch.setattr(ssm, "linear_recurrence", ssm._stepped_recurrence)
        sy, snew = ssm.mamba_mix(tp, torch.from_numpy(x), tcfg, state=tstate)
    _rel_close(ty, jy)
    _rel_close(ty, sy.numpy())
    for k in ("h", "conv"):
        assert new[k].dtype == torch.float32
        _rel_close(new[k], jstate[k])
        _rel_close(new[k], snew[k].numpy())


def test_mamba_state_scan_takes_no_step_per_token(monkeypatch):
    """A 37-token prefill from a state runs the doubling scan a chunk at a
    time (5 chunks of 8), never the token-by-token loop."""
    _, tcfg, _, tp, x, state = _mixer_case("mamba", 37, True)
    calls = []
    monkeypatch.setattr(ssm, "_stepped_recurrence", lambda *a: calls.append("step"))
    real = ssm.linear_recurrence
    monkeypatch.setattr(ssm, "linear_recurrence",
                        lambda a, b, h: calls.append(a.shape[1]) or real(a, b, h))
    with torch.no_grad():
        ssm.mamba_mix(tp, torch.from_numpy(x), tcfg,
                      state={k: torch.from_numpy(v) for k, v in state.items()})
    assert calls == [8] * 5


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_mixer_gradient_matches(kind):
    """The gradient of a random projection of the stateless mixer's output
    (T = 21: both scans carry across chunks and end on a ragged one) with
    respect to its input and every parameter leaf, within 1e-5 of each
    gradient's largest entry: Mamba's reverse recurrence and the wkv's
    backward through the ±30 clamps, against ``jax.grad``."""
    jcfg, tcfg, jp, tp = _mixer_params(kind)
    jmix, tmix = (jssm.mamba_mix, ssm.mamba_mix) if kind == "mamba" else (jssm.rwkv_mix,
                                                                           ssm.rwkv_mix)
    rng = np.random.default_rng(11)
    x, c = (rng.standard_normal((2, 21, tcfg.d_model)).astype(np.float32) for _ in range(2))
    jg = jax.jit(jax.grad(lambda t: jnp.sum(jmix(t["p"], t["x"], jcfg)[0] * c)))(
        {"p": jp, "x": jnp.asarray(x)})
    tc = torch.from_numpy(c)
    _, tg = value_and_grad(lambda t: torch.sum(tmix(t["p"], t["x"], tcfg)[0] * tc),
                           {"p": tp, "x": torch.from_numpy(x)})
    want, got = _flatten(jg), torch_flatten(tg)
    assert got.keys() == want.keys()
    for key, g in want.items():
        if not key.endswith("@rank") and not key.endswith("dt_proj_b"):
            _rel_close(got[key], g)


# ---------------------------------------------------------------------------
# the reduced architectures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_the_reference(arch, param_dtype):
    """Key for key and shape for shape (``dt_proj_b`` included), with the
    JAX package's dtypes in f32. Under bf16 parameters every leaf is bf16
    but ``A_log``, f32 in both packages; the JAX package's factor bases
    come out f32 there (``init_factor`` multiplies them by an f32 mask),
    where the port keeps them bf16. The dense leaves' initial values."""
    jcfg, tcfg = (dataclasses.replace(c, param_dtype=param_dtype) for c in _configs(arch))
    jtree = jax.eval_shape(lambda key: jax_build_model(jcfg).init(key)[0], jax.random.PRNGKey(0))
    with torch.no_grad():
        flat = torch_flatten(build_model(tcfg).init(torch.Generator().manual_seed(0))[0])
    want = _flatten(jtree)
    assert {k: tuple(v.shape) for k, v in flat.items()} == {k: v.shape for k, v in want.items()}
    for key, v in flat.items():
        name = key.rsplit("|", 1)[-1]
        if param_dtype == "float32" or name == "A_log" or name.endswith("@rank"):
            assert str(v.dtype) == f"torch.{want[key].dtype}", key
        else:
            assert v.dtype == torch.bfloat16, key
        if name == "A_log":
            np.testing.assert_allclose(v[0, 0].numpy(),
                                       np.log(np.arange(1, v.shape[-1] + 1, dtype=np.float32)),
                                       rtol=1e-6, atol=0)
        elif name in ("dt_bias", "D", "w0", "u", "dt_proj_b"):
            init = {"dt_bias": -4.6, "D": 1.0, "w0": -1.0, "u": 0.5, "dt_proj_b": 0.0}[name]
            assert torch.all(v == torch.tensor(init, dtype=v.dtype))


def test_loss_matches(built):
    """The loss, with Jamba's MoE aux, within 1e-5."""
    jmodel, jparams, model, params = built
    tokens = np.random.default_rng(3).integers(1, model.cfg.vocab_size, size=(2, 25))
    jl = jax.jit(jmodel.loss_fn)(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tl = model.loss_fn(params, {"tokens": torch.from_numpy(tokens)})
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))


def test_prefill_and_decode_match(built):
    jmodel, jparams, model, params = built
    V = model.cfg.vocab_size
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, V, size=(2, 7))
    step = jax.jit(jmodel.serve_step)
    jl, jc = jax.jit(lambda p, t: jmodel.serve_prefill(p, {"tokens": t}, cache_len=12))(
        jparams, jnp.asarray(tokens))
    with torch.inference_mode():
        tl, tc = model.serve_prefill(params, {"tokens": torch.from_numpy(tokens)}, cache_len=12)
    _logits_close(tl, jl)
    for t in rng.integers(1, V, size=(4, 2, 1)):
        jl, jc = step(jparams, jc, jnp.asarray(t))
        with torch.inference_mode():
            tl, tc = model.serve_step(params, tc, torch.from_numpy(t))
        _logits_close(tl, jl)
    # the recurrent states after 11 tokens, leaf for leaf
    for key, c in tc["stack"].items():
        for name, leaf in c.items():
            if name not in ("k", "v", "idx"):
                _rel_close(leaf.float(), jc["stack"][key][name], 1e-4)


def test_prefill_of_a_prefix_then_steps_equals_the_whole_prefill(built):
    """Inside the port: prefill(T) against prefill(T − 2) and two decode
    steps, within 1e-4 of the largest |logit| (the stateful path through
    two routes)."""
    _, _, model, params = built
    tokens = torch.from_numpy(np.random.default_rng(5).integers(1, model.cfg.vocab_size,
                                                                size=(2, 11)))
    with torch.inference_mode():
        whole, _ = model.serve_prefill(params, {"tokens": tokens}, cache_len=11)
        logits, cache = model.serve_prefill(params, {"tokens": tokens[:, :-2]}, cache_len=11)
        for t in (9, 10):
            logits, cache = model.serve_step(params, cache, tokens[:, t:t + 1])
    _rel_close(logits, whole.numpy(), 1e-4)
    assert torch.equal(logits.argmax(-1), whole.argmax(-1))


ROUND = dict(num_clients=2, s_star=2, lr=5e-3, correction="simplified", tau=0.05)


def _round_tokens(model):
    """(clients, batch, T + 1) tokens: 192 inputs a round, so that the
    embedding's gradient has full rank. With fewer distinct tokens than the
    embedding's r_max (64 at this size) its rows span less than r_max
    directions, the basis augmentation ``[U | G]`` is rank-deficient and
    CholeskyQR2 fills the missing directions from rounding noise: at 2 × 2
    × 16 inputs a 1e-7 change of the parameters moved the round's
    embedding factor by ~2e-3 in the port, and the JAX package's own
    ``loss_after`` by ~7e-3 between ``remat`` on and off."""
    return np.random.default_rng(6).integers(1, model.cfg.vocab_size, size=(2, 4, 25))


def test_fedlrt_round_of_rwkv6_matches():
    """One FeDLRT round of reduced RWKV6-7B (simplified correction, 2
    clients, 2 local steps): ranks equal, losses within 1e-5 / 1e-4, every
    factor's ``U S Vᵀ`` within 1e-4 of its largest entry."""
    jmodel, jparams, model, _ = _built("rwkv6-7b")
    tokens = _round_tokens(model)
    jnew, jm = jax.jit(lambda p, b: jfedlrt_round(jmodel.loss_fn, p, b, JFedConfig(**ROUND)))(
        jparams, {"tokens": jnp.asarray(tokens)})
    tnew, tm = fedlrt_round(model.loss_fn, _carry(jparams), {"tokens": torch.from_numpy(tokens)},
                            FedConfig(**ROUND))
    assert abs(float(tm["loss_before"]) - float(jm["loss_before"])) <= \
        1e-5 * abs(float(jm["loss_before"]))
    assert abs(float(tm["loss_after"]) - float(jm["loss_after"])) <= \
        1e-4 * abs(float(jm["loss_after"]))
    assert tm["rank"].keys() == jm["rank"].keys()
    for k in jm["rank"]:
        np.testing.assert_array_equal(np.asarray(tm["rank"][k]), np.asarray(jm["rank"][k]))
    jfs = [f for f in jax.tree.leaves(jnew, is_leaf=jfac.is_factor) if jfac.is_factor(f)]
    tfs = [f for f in tree_leaves(tnew, is_leaf=fac.is_factor) if fac.is_factor(f)]
    assert len(jfs) == len(tfs) > 0
    for jf, tf in zip(jfs, tfs):
        _rel_close(fac.materialize(tf), jfac.materialize(jf), 1e-4)


def test_fedlrt_round_of_jamba_keeps_the_invariants():
    """One FeDLRT round of reduced Jamba-1.5-Large in the port alone: every
    factor (Mamba's, attention's, the MLPs' and the (layers, experts)
    stacks) back at a rank ≤ r_max with exactly zero inactive columns, the
    dense SSM leaves trained, the loss finite and lower. The JAX package's
    jitted round of this model takes ~47 s to compile on the CPU, beyond
    this file's time, so it is not run here; what the round is built from
    is held to it: the loss (:func:`test_loss_matches`), the mixers'
    gradients (:func:`test_mixer_gradient_matches`) and the MoE block's
    (``tests/test_torch_moe.py``)."""
    _, jparams, model, _ = _built("jamba-1.5-large-398b")
    params = _carry(jparams)
    tokens = _round_tokens(model)
    new, m = fedlrt_round(model.loss_fn, params, {"tokens": torch.from_numpy(tokens)},
                          FedConfig(**ROUND))
    assert np.isfinite(float(m["loss_after"])) and float(m["loss_after"]) < float(m["loss_before"])
    factors = [f for f in tree_leaves(new, is_leaf=fac.is_factor) if fac.is_factor(f)]
    assert any(f.U.dim() == 4 for f in factors)  # the expert stacks
    for f in factors:
        assert torch.all((f.rank >= 1) & (f.rank <= f.r_max))
        mask = fac.rank_mask(f.rank, f.r_max)
        assert torch.all(f.U * (1 - mask[..., None, :]) == 0)
        assert torch.all(f.V * (1 - mask[..., None, :]) == 0)
    for name in ("A_log", "conv_w", "dt_bias", "D"):
        assert not torch.equal(new["blocks"]["pos0"]["mamba"][name],
                               params["blocks"]["pos0"]["mamba"][name])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_per_slot_state_and_insert_match(built):
    """The per-slot state stacks (Mamba's ``h`` / ``conv``, RWKV's ``S`` /
    ``shift``, with leading NB and batch on axis 1) as the JAX package's,
    and a B = 1 cache of random values grafted into slot 1 by both
    packages' ``_insert_cache``: the same state, the other slot untouched."""
    jmodel, jparams, model, params = built
    L = 12
    jstate = jmodel.init_cache(jparams, 2, L, per_slot=True)
    with torch.inference_mode():
        tstate = model.init_cache(params, 2, L, per_slot=True)
    rng = np.random.default_rng(7)
    one = jax.tree.map(lambda a: rng.standard_normal((a.shape[0], 1) + a.shape[2:]).astype(
        a.dtype) if a.ndim > 1 else np.array(a), jstate)
    jstate = jax_insert_cache(jstate, jax.tree.map(jnp.asarray, one), jnp.int32(1), jnp.int32(5))
    with torch.inference_mode():
        tstate = _insert_cache(tstate, jax.tree.map(torch.from_numpy, one), 1, 5)
    names = set()
    for key, c in tstate["stack"].items():
        assert c.keys() == jstate["stack"][key].keys()
        names |= c.keys()
        for name, leaf in c.items():
            want = np.asarray(jstate["stack"][key][name])
            assert str(leaf.dtype) == f"torch.{want.dtype}"
            np.testing.assert_array_equal(leaf.numpy(), want)
            assert torch.all(leaf[:, 0] == 0)
    assert names & ({"h", "conv"} if model.cfg.mamba else {"S", "shift"})
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))


def _engine(model, params):
    return ServeEngine(model, params, **SERVE)


def _requests(cls, prompts, arrivals=None):
    return [cls(rid=i, tokens=p.astype(np.int32), arrival_step=(arrivals or [0] * 9)[i])
            for i, p in enumerate(prompts)]


def _prompts(model, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, model.cfg.vocab_size, size=n) for n in lengths]


def test_engine_prefill_is_exact_at_any_prompt_length(built):
    """At lengths that are not a multiple of ``prompt_bucket`` the port's
    engine runs the prompt unpadded, so its greedy tokens are those of an
    unpadded ``serve_prefill`` and ``serve_step`` (held to the JAX
    package's by :func:`test_prefill_and_decode_match`)."""
    _, _, model, params = built
    eng = _engine(model, params)
    prompts = _prompts(model, (5, 11), 8)
    assert [eng.bucket_len(len(p)) for p in prompts] == [5, 11]
    comps = ContinuousScheduler(eng).run(_requests(Request, prompts))
    for c in comps:
        p = torch.from_numpy(prompts[c.rid])[None]
        with torch.inference_mode():
            logits, cache = model.serve_prefill(params, {"tokens": p},
                                                cache_len=len(prompts[c.rid]) + 4)
            want = [int(logits.argmax(-1)[0])]
            while len(want) < SERVE["max_new_tokens"]:
                logits, cache = model.serve_step(params, cache, torch.tensor([[want[-1]]]))
                want.append(int(logits.argmax(-1)[0]))
        assert c.tokens.tolist() == want


def test_engine_matches_the_reference_engine_at_bucket_multiples(built):
    """Where the JAX package's engine is exact (lengths that fill their
    bucket, so it pads nothing), the two engines give the same tokens."""
    jmodel, jparams, model, params = built
    prompts = _prompts(model, (8, 16), 9)
    comps = ContinuousScheduler(_engine(model, params)).run(_requests(Request, prompts))
    jcomps = JContinuousScheduler(JServeEngine(jmodel, jparams, **SERVE)).run(
        _requests(JRequest, prompts))
    got = {c.rid: c.tokens.tolist() for c in comps}
    assert got == {c.rid: np.asarray(c.tokens).tolist() for c in jcomps}


def test_continuous_matches_static_batching(built):
    _, _, model, params = built
    prompts = _prompts(model, (3, 9, 5, 14), 10)
    runs = {}
    for mode in ("continuous", "static"):
        comps = ContinuousScheduler(_engine(model, params), mode=mode).run(
            _requests(Request, prompts, [0, 0, 1, 3]))
        runs[mode] = {c.rid: c.tokens.tolist() for c in comps}
    assert runs["continuous"] == runs["static"]
    assert len(runs["static"]) == len(prompts)
