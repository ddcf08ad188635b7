"""The port's model against the JAX package's on the same parameters.

Parameters come from the JAX ``build_model(cfg).init(PRNGKey(0))``, with
biases and norm scales perturbed from a numpy seed so every parameter
matters. They are written once in the JAX package's npz layout and read
back by both packages' ``load_checkpoint``. The JAX side runs with
``kernels="off"`` (interpret mode is too slow at model level); the port
runs its default ``"auto"``, which on CPU tensors takes the kernels' plain
versions. All in f32.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.tasks import PRESETS as JAX_PRESETS
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint.io import _flatten
from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.core.factorization import LowRankFactor as JaxLowRankFactor
from repro.core.factorization import init_factor as jax_init_factor
from repro.core.factorization import lr_matmul as jax_lr_matmul
from repro.core.factorization import materialize as jax_materialize
from repro.models import build_model as jax_build_model
from repro.models.config import reduced as jax_reduced
from repro.serve.engine import _insert_cache as jax_insert_cache
from repro_torch.api.tasks import PRESETS
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.core.factorization import (
    LowRankFactor,
    init_factor,
    lr_matmul,
    materialize,
    rank_mask,
)
from repro_torch.models import build_model, reduced
from repro_torch.serve.engine import _insert_cache
from torch_threads import one_intra_op_thread  # noqa: F401

# f32 on both sides; the two differ in summation order and in the libm
# behind pow/sin/cos of RoPE, which moves the logits by ~1e-6
ATOL = 1e-4

CASES = {
    "llm-tiny-smoke": (
        lambda: jax_reduced(JAX_PRESETS["llm-tiny"]),
        lambda: reduced(PRESETS["llm-tiny"]),
    ),
    "qwen2-7b-reduced-gqa": (
        lambda: jax_reduced(jax_get_config("qwen2-7b"), num_kv_heads=2),
        lambda: reduced(get_config("qwen2-7b"), num_kv_heads=2),
    ),
    # MHA with QKV bias
    "codeqwen1.5-7b-reduced": (
        lambda: jax_reduced(jax_get_config("codeqwen1.5-7b")),
        lambda: reduced(get_config("codeqwen1.5-7b")),
    ),
    "qwen1.5-32b-reduced": (
        lambda: jax_reduced(jax_get_config("qwen1.5-32b")),
        lambda: reduced(get_config("qwen1.5-32b")),
    ),
    # GQA, per-head qk-norm, no bias; H·hd ≠ d_model, as at full width
    "qwen3-32b-reduced-gqa": (
        lambda: jax_reduced(jax_get_config("qwen3-32b"), num_kv_heads=2, head_dim=96),
        lambda: reduced(get_config("qwen3-32b"), num_kv_heads=2, head_dim=96),
    ),
    # the MoE block: routed experts (OLMoE, with qk-norm), plus shared ones
    # (DeepSeekMoE), at the published capacity factor 1.25
    "olmoe-1b-7b-reduced": (
        lambda: jax_reduced(jax_get_config("olmoe-1b-7b")),
        lambda: reduced(get_config("olmoe-1b-7b")),
    ),
    "deepseek-moe-16b-reduced": (
        lambda: jax_reduced(jax_get_config("deepseek-moe-16b")),
        lambda: reduced(get_config("deepseek-moe-16b")),
    ),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, tmp_path_factory):
    jcfg_fn, tcfg_fn = CASES[request.param]
    jcfg = dataclasses.replace(jcfg_fn(), kernels="off")
    tcfg = tcfg_fn()
    # the port's copy of the config carries the same values
    assert {**dataclasses.asdict(tcfg), "kernels": "off"} == dataclasses.asdict(jcfg)
    jmodel = jax_build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    flat = {}
    for k, v in _flatten(jparams).items():
        a = np.asarray(v)
        if k.endswith("_b") or k.rsplit("|", 1)[-1] in ("ln1", "ln2", "final_norm"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        flat[k] = a
    path = str(tmp_path_factory.mktemp("params") / "round_000000.npz")
    flat["__meta__"] = np.frombuffer(json.dumps({"case": request.param}).encode(), np.uint8)
    np.savez(path, **flat)
    jparams, _ = jax_load_checkpoint(path)
    tparams, meta = load_checkpoint(path, device="cpu")
    assert meta == {"case": request.param}
    return jmodel, jparams, build_model(tcfg), tparams


def _close(t: torch.Tensor, j):
    """Logits within ATOL, and the greedy token of every row the same."""
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(t.argmax(-1).numpy(), np.asarray(j).argmax(-1))


def test_prefill_and_shared_cache_decode(pair):
    jmodel, jparams, model, params = pair
    V = model.cfg.vocab_size
    tokens = np.random.default_rng(1).integers(1, V, size=(2, 7))
    jl, jc = jmodel.serve_prefill(jparams, {"tokens": jnp.asarray(tokens)}, cache_len=12)
    with torch.inference_mode():
        tl, tc = model.serve_prefill(params, {"tokens": torch.from_numpy(tokens)}, cache_len=12)
    _close(tl, jl)
    step_tokens = np.random.default_rng(2).integers(1, V, size=(4, 2, 1))
    for t in step_tokens:
        jl, jc = jmodel.serve_step(jparams, jc, jnp.asarray(t))
        with torch.inference_mode():
            tl, tc = model.serve_step(params, tc, torch.from_numpy(t))
        _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == 11


def test_prefill_last_index_reads_the_true_last_token(pair):
    jmodel, jparams, model, params = pair
    tokens = np.zeros((1, 8), np.int64)
    tokens[0, :5] = np.arange(3, 8)
    jl, jc = jmodel.serve_prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  cache_len=10, last_index=jnp.int32(4))
    with torch.inference_mode():
        tl, tc = model.serve_prefill(params, {"tokens": torch.from_numpy(tokens)},
                                     cache_len=10, last_index=4)
    _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == 5


def test_per_slot_cache_decode(pair):
    """Two prompts of different lengths inserted into a per-slot state, so
    the rows decode at different depths."""
    jmodel, jparams, model, params = pair
    V, L = model.cfg.vocab_size, 16
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, V, size=n) for n in (3, 6)]
    jstate = jmodel.init_cache(jparams, 2, L, per_slot=True)
    with torch.inference_mode():
        tstate = model.init_cache(params, 2, L, per_slot=True)
    for slot, p in enumerate(prompts):
        padded = np.zeros((1, 8), np.int64)
        padded[0, :p.size] = p
        _, jc = jmodel.serve_prefill(jparams, {"tokens": jnp.asarray(padded)}, cache_len=L,
                                     last_index=jnp.int32(p.size - 1))
        jstate = jax_insert_cache(jstate, jc, jnp.int32(slot), jnp.int32(p.size))
        with torch.inference_mode():
            _, tc = model.serve_prefill(params, {"tokens": torch.from_numpy(padded)},
                                        cache_len=L, last_index=p.size - 1)
            tstate = _insert_cache(tstate, tc, slot, p.size)
    for t in rng.integers(1, V, size=(4, 2, 1)):
        jl, jstate = jmodel.serve_step(jparams, jstate, jnp.asarray(t))
        with torch.inference_mode():
            tl, tstate = model.serve_step(params, tstate, torch.from_numpy(t))
        _close(tl, jl)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))


@pytest.mark.parametrize("batch_shape", [(), (3,)])
def test_init_factor_invariants(batch_shape):
    """The port draws other values than JAX, so it is held to the
    invariants: orthonormal active columns, exactly zero inactive ones, and
    the JAX package's (deterministic) spectrum."""
    gen = torch.Generator().manual_seed(0)
    f = init_factor(gen, 40, 24, 10, init_rank=6, batch_shape=batch_shape)
    assert f.U.shape == batch_shape + (40, 10) and f.V.shape == batch_shape + (24, 10)
    m = rank_mask(f.rank, 10)
    assert torch.all(f.rank == 6.0)
    for B in (f.U, f.V):
        gram = B.transpose(-1, -2) @ B
        eye = torch.eye(6).expand(batch_shape + (6, 6))
        torch.testing.assert_close(gram[..., :6, :6], eye, rtol=0, atol=1e-5)
        assert torch.all(B[..., 6:] == 0)
    assert torch.all(f.S * (1 - m[..., :, None] * m[..., None, :]) == 0)
    # the JAX S is the same diagonal for every stack member
    jf = jax_init_factor(jax.random.PRNGKey(0), 40, 24, 10, init_rank=6)
    want = np.broadcast_to(np.asarray(jf.S), batch_shape + (10, 10))
    np.testing.assert_allclose(f.S.numpy(), want, rtol=1e-6, atol=0)


def test_lr_matmul_and_materialize_match_jax():
    """Stacked factors (one leading dim) through both kernel policies."""
    rng = np.random.default_rng(4)
    U, S, V = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((2, 24, 8), (2, 8, 8), (2, 20, 8)))
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    jf = JaxLowRankFactor(U=jnp.asarray(U), S=jnp.asarray(S), V=jnp.asarray(V),
                          rank=jnp.full((2,), 8.0))
    tf = LowRankFactor(U=torch.from_numpy(U), S=torch.from_numpy(S), V=torch.from_numpy(V),
                       rank=torch.full((2,), 8.0))
    # the JAX lr_matmul takes one (unstacked) factor: hold each member to it
    want = np.stack([
        jax_lr_matmul(jnp.asarray(x[g]), JaxLowRankFactor(
            U=jf.U[g], S=jf.S[g], V=jf.V[g], rank=jf.rank[g]))
        for g in range(2)
    ])
    for kernels in ("auto", "off"):
        _close(lr_matmul(torch.from_numpy(x), tf, kernels=kernels), want)
    _close(materialize(tf), jax_materialize(jf))
    assert tf[1].r_max == 8 and tf[1].n_in == 24 and tf[1].n_out == 20


def test_unported_architectures_name_the_roadmap():
    """Every architecture of the registry builds (no family is left to
    port); an unknown name is refused."""
    assert {arch for arch in ARCH_IDS if build_model(get_config(arch))} == BUILDS
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("gpt-5")


#: the architectures whose model the port builds: all ten
BUILDS = {"qwen2_7b", "codeqwen15_7b", "qwen15_32b", "qwen3_32b", "olmoe_1b_7b",
          "deepseek_moe_16b", "rwkv6_7b", "jamba_15_large", "whisper_large_v3",
          "llava_next_mistral_7b"}


def test_all_configs_match_the_jax_package():
    """The registry holds the JAX package's architectures with its exact
    values, and the port builds each of them."""
    ours, theirs = all_configs(), jax_all_configs()
    assert list(ours) == list(theirs) == list(ARCH_IDS)
    assert set(ARCH_IDS) == BUILDS
    for arch, cfg in theirs.items():
        assert dataclasses.asdict(ours[arch]) == dataclasses.asdict(cfg), arch
        assert get_config(cfg.name) == ours[arch]
        build_model(ours[arch])
