"""The port's encoder-decoder (audio) and VLM families against the JAX
package, on shared numpy inputs in f32 on the CPU: ``sinusoidal_positions``,
query-chunked ``attention``, and reduced Whisper-large-v3 and
LLaVA-NeXT-Mistral-7B.

Parameters are drawn by the JAX package (``reduced()``: 2 decoder layers,
an encoder of 2 layers over 32 frames; 16 vision tokens and a window of 16,
so the window binds across the prefix), every dense vector given noise from
a numpy seed so that each one matters, and read by both packages from one
npz in the JAX package's layout (``params_from_numpy`` on the port's side).
The JAX side runs under ``jit`` on its plain chain (``kernels="off"``); the
port runs ``"auto"``, the kernels' plain versions on CPU tensors.

Tolerances: attention within 1e-6 of its largest entry; the loss 1e-5
relative; logits 1e-4 absolute with greedy tokens identical; a FeDLRT
round's losses 1e-5 / 1e-4 relative and every factor's ``U S Vᵀ`` 1e-4 of
its largest entry, ranks equal.
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
import repro.models.layers as jlayers
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.checkpoint.io import _flatten
from repro.configs import get_config as jax_get_config
from repro.core import FedConfig as JFedConfig
from repro.core.fedlrt import fedlrt_round as jfedlrt_round
from repro.models import build_model as jax_build_model
from repro.models.config import reduced as jax_reduced
from repro.serve import ContinuousScheduler as JContinuousScheduler
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.api import ExperimentSpec, ModelSpec, serve
from repro_torch.checkpoint import load_checkpoint, params_from_numpy, save_checkpoint
from repro_torch.checkpoint.io import _flatten as torch_flatten
from repro_torch.configs import get_config
from repro_torch.core import factorization as fac
from repro_torch.core.fedlrt import fedlrt_round
from repro_torch.core.round import FedConfig
from repro_torch.models import build_model, reduced
from repro_torch.models.layers import attention, sinusoidal_positions
from repro_torch.serve import ContinuousScheduler, Request, ServeEngine
from repro_torch.utils.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: F401

WHISPER, LLAVA = "whisper-large-v3", "llava-next-mistral-7b"
ARCHS = [WHISPER, LLAVA]
ATTN_RTOL = 1e-6
LOSS_RTOL = 1e-5
LOGIT_ATOL = 1e-4
#: the dense leaves given noise, so that a swapped or ignored one shows
PERTURB = {"ln1", "ln2", "ln_x", "final_norm", "enc_norm"}
SERVE = dict(max_batch=2, max_prompt=16, prompt_bucket=8, max_new_tokens=4)


def _configs(arch):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), kernels="off")
    tcfg = reduced(get_config(arch))
    assert {**dataclasses.asdict(tcfg), "kernels": "off"} == dataclasses.asdict(jcfg)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _built(arch):
    """(JAX model, JAX params, port model, port params): drawn by the JAX
    package, every dense vector in ``PERTURB`` given noise from a numpy
    seed, the same npz read by both packages."""
    jcfg, tcfg = _configs(arch)
    jmodel = jax_build_model(jcfg)
    flat = {k: np.array(v) for k, v in _flatten(jmodel.init(jax.random.PRNGKey(0))[0]).items()}
    rng = np.random.default_rng(0)
    for k in sorted(flat):
        if k.rsplit("|", 1)[-1] in PERTURB:
            flat[k] = flat[k] + 0.1 * rng.standard_normal(flat[k].shape).astype(flat[k].dtype)
    with tempfile.TemporaryDirectory(prefix="encdec_params_") as d:
        path = os.path.join(d, "round_000000.npz")
        np.savez(path, __meta__=np.frombuffer(b"{}", np.uint8), **flat)
        jparams, _ = jax_load_checkpoint(path)
    return jmodel, jparams, build_model(tcfg), params_from_numpy(flat, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def built(request):
    return _built(request.param)


def _inputs(cfg, lead, seed):
    """The stub frontend's output for ``lead`` rows (leading dims): frames
    for the enc-dec family, vision embeddings for the VLM."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": rng.standard_normal(lead + (cfg.encoder.num_frames, cfg.d_model))
                .astype(np.float32)}
    return {"vision_embeds": rng.standard_normal(lead + (cfg.vision_tokens, cfg.d_model))
            .astype(np.float32)}


def _batch(tokens, extra):
    return ({"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in extra.items()}},
            {"tokens": torch.from_numpy(tokens), **{k: torch.from_numpy(v)
                                                     for k, v in extra.items()}})


def _rel_close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _logits_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(t.argmax(-1).numpy(), np.asarray(j).argmax(-1))


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,d", [(40, 256), (1500, 1280)])
def test_sinusoidal_positions_match(T, d):
    """Within 1e-6 plus each row's position times 2⁻²³: XLA's and torch's
    f32 ``exp`` differ by an ulp on a few frequencies (≤ 1, so an ulp is
    at most 2⁻²³; the JAX package's own eager and jitted tables differ by
    1.86e-6 at T 40), and ``pos · div`` carries that ulp into the
    argument. Whisper's 1500 frames at d 1280 too; bf16 is the f32 table
    cast."""
    want = np.asarray(jax.jit(lambda: jlayers.sinusoidal_positions(T, d))())
    got = sinusoidal_positions(T, d)
    assert got.dtype == torch.float32 and got.shape == (T, d)
    atol = 1e-6 + np.arange(T, dtype=np.float64)[:, None] * 2.0**-23
    assert np.all(np.abs(got.numpy() - want) <= atol)
    assert torch.equal(sinusoidal_positions(T, d, torch.bfloat16), got.to(torch.bfloat16))


ATTN_CASES = {"causal": dict(causal=True), "causal-window": dict(causal=True, sliding_window=8),
              "bidirectional": dict(causal=False)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_matches(case):
    """Tq = 40 in chunks of 16, so the last chunk is padded (8 rows of
    position -1): within 1e-6 of the JAX package's chunked attention, and
    bit-equal to the port's own single block (the rows' sums are the same
    sums)."""
    kw = ATTN_CASES[case]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, 16)).astype(np.float32) for _ in range(2))
    pos = np.arange(40)
    want = jax.jit(lambda q, k, v: jlayers.attention(
        q, k, v, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos), q_chunk=16,
        **kw))(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tpos = torch.from_numpy(pos)
    got = attention(tq, tk, tv, q_positions=tpos, kv_positions=tpos, q_chunk=16, **kw)
    _rel_close(got, want, ATTN_RTOL)
    assert torch.equal(got, attention(tq, tk, tv, q_positions=tpos, kv_positions=tpos, **kw))


def test_attention_with_per_slot_positions_takes_one_block():
    """Per-slot (B, Tq) positions with ``q_chunk`` set: one block, as in
    the JAX package, a decode row at each slot's own depth over a cache
    with never-written (negative) slots."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32) for _ in range(2))
    qpos = np.array([[5], [19]])
    kvpos = np.where(np.arange(24)[None] <= qpos, np.arange(24)[None], -10**9)
    want = jax.jit(lambda q, k, v: jlayers.attention(
        q, k, v, q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos),
        sliding_window=8, q_chunk=16))(q, k, v)
    got = attention(*map(torch.from_numpy, (q, k, v)), q_positions=torch.from_numpy(qpos),
                    kv_positions=torch.from_numpy(kvpos), sliding_window=8, q_chunk=16)
    _rel_close(got, want, ATTN_RTOL)


# ---------------------------------------------------------------------------
# the reduced architectures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_the_reference(arch):
    """Key for key, shape for shape and dtype for dtype: the decoder's
    cross-attention factors ``xq``/``xk``/``xv``/``xo`` and ``ln_x``, the
    encoder's ``enc_blocks`` and ``enc_norm`` (Whisper); LLaVA's tree is
    its Mistral backbone's."""
    jcfg, tcfg = _configs(arch)
    jtree = jax.eval_shape(lambda key: jax_build_model(jcfg).init(key)[0], jax.random.PRNGKey(0))
    with torch.no_grad():
        flat = torch_flatten(build_model(tcfg).init(torch.Generator().manual_seed(0))[0])
    want = _flatten(jtree)
    assert {k: tuple(v.shape) for k, v in flat.items()} == {k: v.shape for k, v in want.items()}
    for key, v in flat.items():
        assert str(v.dtype) == f"torch.{want[key].dtype}", key
    if tcfg.is_encdec:
        assert "enc_norm" in flat and "enc_blocks|pos0|attn|q@U" in flat
        assert {f"blocks|pos0|attn|{n}" for n in ("xq@U", "xk@U", "xv@U", "xo@U", "ln_x")} <= \
            set(flat)


def test_loss_matches(built):
    jmodel, jparams, model, params = built
    tokens = np.random.default_rng(3).integers(1, model.cfg.vocab_size, size=(2, 25))
    jb, tb = _batch(tokens, _inputs(model.cfg, (2,), 4))
    jl = jax.jit(jmodel.loss_fn)(jparams, jb)
    with torch.no_grad():
        tl = model.loss_fn(params, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))


def test_prefill_and_decode_match(built):
    """A 7-token prompt (after LLaVA's 16-token prefix) and 4 greedy-shaped
    decode steps, logits within 1e-4 with the same greedy tokens; LLaVA's
    window of 16 binds across its prefix."""
    jmodel, jparams, model, params = built
    V = model.cfg.vocab_size
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, V, size=(2, 7))
    extra = _inputs(model.cfg, (2,), 6)
    cache_len = 32 if model.cfg.vision_tokens else 12
    jb, tb = _batch(tokens, extra)
    jl, jc = jax.jit(lambda p, b: jmodel.serve_prefill(p, b, cache_len=cache_len))(jparams, jb)
    with torch.inference_mode():
        tl, tc = model.serve_prefill(params, tb, cache_len=cache_len)
    _logits_close(tl, jl)
    if model.cfg.is_encdec:
        _rel_close(tc["enc_h"], jc["enc_h"], 1e-5)
    assert int(tc["pos"]) == int(jc["pos"])
    step = jax.jit(jmodel.serve_step)
    for t in rng.integers(1, V, size=(4, 2, 1)):
        jl, jc = step(jparams, jc, jnp.asarray(t))
        with torch.inference_mode():
            tl, tc = model.serve_step(params, tc, torch.from_numpy(t))
        _logits_close(tl, jl)


def test_prefill_of_a_prefix_then_steps_equals_the_whole_prefill(built):
    """Inside the port: prefill(T) against prefill(T − 2) and two decode
    steps, within 1e-4 of the largest |logit| (Whisper: the sinusoidal rows
    read at the cached position; LLaVA: positions past the prefix)."""
    _, _, model, params = built
    tokens = torch.from_numpy(np.random.default_rng(7).integers(1, model.cfg.vocab_size,
                                                                size=(2, 11)))
    extra = {k: torch.from_numpy(v) for k, v in _inputs(model.cfg, (2,), 8).items()}
    cache_len = 32 if model.cfg.vision_tokens else 11
    with torch.inference_mode():
        whole, _ = model.serve_prefill(params, {"tokens": tokens, **extra}, cache_len=cache_len)
        logits, cache = model.serve_prefill(params, {"tokens": tokens[:, :-2], **extra},
                                            cache_len=cache_len)
        for t in (9, 10):
            logits, cache = model.serve_step(params, cache, tokens[:, t:t + 1])
    _rel_close(logits, whole.numpy(), 1e-4)
    assert torch.equal(logits.argmax(-1), whole.argmax(-1))


ROUND = dict(num_clients=2, s_star=2, lr=5e-3, correction="simplified", tau=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_fedlrt_round_matches(arch):
    """One FeDLRT round (simplified correction, 2 clients, 2 local steps):
    ranks equal, losses within 1e-5 / 1e-4, every factor's ``U S Vᵀ``
    within 1e-4 of its largest entry. 192 inputs a round (2 clients × 4 ×
    24), more distinct tokens than the embedding's r_max (64), so the
    round is well posed (ROADMAP.md, queue 3)."""
    jmodel, jparams, model, params = _built(arch)
    tokens = np.random.default_rng(9).integers(1, model.cfg.vocab_size, size=(2, 4, 25))
    jb, tb = _batch(tokens, _inputs(model.cfg, (2, 4), 10))
    jnew, jm = jax.jit(lambda p, b: jfedlrt_round(jmodel.loss_fn, p, b, JFedConfig(**ROUND)))(
        jparams, jb)
    tnew, tm = fedlrt_round(model.loss_fn, params, tb, FedConfig(**ROUND))
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


# ---------------------------------------------------------------------------
# serving and checkpoints
# ---------------------------------------------------------------------------


def test_per_slot_cache_is_refused_for_encdec():
    _, _, model, params = _built(WHISPER)
    with pytest.raises(ValueError, match="enc-dec"):
        model.init_cache(params, 2, 12, per_slot=True)
    cache = model.init_cache(params, 2, 12)
    assert cache["enc_h"].shape == (2, model.cfg.encoder.num_frames, model.cfg.d_model)


def test_engine_and_serve_refuse_encdec():
    """The engine refuses an enc-dec model with the JAX package's
    ``ValueError``, and so does ``serve`` on ``whisper-large-v3``, as
    ``tests/test_serve.py::test_serve_rejects_encdec`` holds the JAX
    package's."""
    _, _, model, params = _built(WHISPER)
    with pytest.raises(ValueError, match="enc-dec"):
        ServeEngine(model, params, **SERVE)
    spec = ExperimentSpec(model=ModelSpec(kind="lm", arch=WHISPER, smoke=True))
    with pytest.raises(ValueError, match="enc-dec"):
        serve(spec, device="cpu")


def test_vlm_engine_matches_the_reference_engine():
    """Reduced LLaVA through both engines, text-only (neither engine passes
    a vision prefix): the same greedy tokens."""
    jmodel, jparams, model, params = _built(LLAVA)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, model.cfg.vocab_size, size=n) for n in (8, 16, 5)]

    def requests(cls):
        return [cls(rid=i, tokens=p.astype(np.int32), arrival_step=0)
                for i, p in enumerate(prompts)]

    comps = ContinuousScheduler(ServeEngine(model, params, **SERVE)).run(requests(Request))
    jcomps = JContinuousScheduler(JServeEngine(jmodel, jparams, **SERVE)).run(
        requests(JRequest))
    got = {c.rid: c.tokens.tolist() for c in comps}
    assert got == {c.rid: np.asarray(c.tokens).tolist() for c in jcomps}
    assert len(got) == len(prompts)


def test_encdec_checkpoint_round_trip(tmp_path):
    """Reduced Whisper from the JAX package's checkpoint into the port and
    back: every leaf (the encoder's and the cross-attention's included) the
    same bits, and the JAX package's loss unchanged on the returned tree."""
    jmodel, jparams, model, _ = _built(WHISPER)
    jax_save_checkpoint(str(tmp_path / "j.npz"), jparams, meta={"round": 1})
    tparams, meta = load_checkpoint(str(tmp_path / "j.npz"), device="cpu")
    assert meta == {"round": 1}
    save_checkpoint(str(tmp_path / "t.npz"), tparams, meta=meta)
    back, _ = jax_load_checkpoint(str(tmp_path / "t.npz"))
    want, got = _flatten(jparams), _flatten(back)
    assert got.keys() == want.keys()
    assert any(k.startswith("enc_blocks|") for k in want) and "enc_norm" in want
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
    tokens = np.random.default_rng(12).integers(1, model.cfg.vocab_size, size=(2, 9))
    jb, _ = _batch(tokens, _inputs(model.cfg, (2,), 13))
    loss = jax.jit(jmodel.loss_fn)
    assert float(loss(back, jb)) == float(loss(jparams, jb))
