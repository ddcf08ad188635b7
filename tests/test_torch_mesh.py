"""The port on a 2 × 2 ``("data", "model")`` mesh of four gloo ranks on the
CPU (``tests/torch_mesh_worker.py``, spawned in a subprocess) against the
JAX package unsharded, on the same parameters (drawn by the JAX package,
carried through ``params_from_numpy``) and inputs.

Reduced Qwen2-7B (2 KV heads) and OLMoE-1B-7B (4 experts, top-2), f32. The
sharded path takes the kernels' plain versions on the local shards
(``kernels="auto"`` on CPU tensors); the JAX side its plain chain.

Tolerances: the loss within 1e-5; the prefill and each greedy decode
step's logits within 1e-4 and the greedy tokens identical, for 4 rows and
for one (its cache split on the sequence over the data axis); a FeDLRT round
(4 clients over ``data`` = 2, ``spec_tree`` / ``client_axes``) against the
JAX package's unsharded round: every factor's rank equal, ``loss_before``
within 1e-5 and ``loss_after`` within 1e-4 relative, each factor's
``U S Vᵀ`` within 1e-4 of its largest entry. The round's batches (4 × 32
tokens a client) give every basis-gradient block its full rank: the
complement of a rank-deficient block is any basis of the missing
directions (the JAX package's ``_ortho_complement_cholqr2``), so two
summation orders may pick different ones.

The wire under the mesh (Qwen2-7B only, in the same spawn): the round under
the identity codec bit-identical to the round without a wire; under
identity and ``int8_affine`` the measured ``wire_bytes_{down,up}_per_client``
equal, exactly, to the port's unsharded round's and to the JAX package's
unsharded ``fedlrt_round(..., wire=...)``; the int8 round against the
port's unsharded int8 round with the round's tolerances above, and against
the JAX package's int8 round with the same ranks and losses and each
``U S Vᵀ`` within one int8 step of a client's payload averaged over the
cohort (:data:`INT8_STEP_RTOL`): the two frameworks round an int8 code
differently at a tie (``tests/test_torch_wire.py``), which the port's
unsharded int8 round shows against the JAX package's as well.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.io import _flatten
from repro.configs import get_config as jax_get_config
from repro.core import FedConfig as JaxFedConfig
from repro.core.factorization import is_factor as jax_is_factor
from repro.core.fedlrt import fedlrt_round as jax_fedlrt_round
from repro.fed import wire as jax_wire
from repro.models import build_model as jax_build_model
from repro.models.config import reduced as jax_reduced
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
CASES = {"qwen2-7b": {"num_kv_heads": 2}, "olmoe-1b-7b": {}}
STEPS = 3
#: the architecture whose round also runs under each wire codec
WIRE_ARCH, WIRE_CODECS = "qwen2-7b", ("identity", "int8_affine")
BYTES = ("wire_bytes_down_per_client", "wire_bytes_up_per_client")
#: an int8 code ±1 moves a decoded entry by (hi − lo)/255 of its tensor, up
#: to 2/255 of its largest entry, and the aggregate averages it over the 4
#: clients
INT8_STEP_RTOL = 2 / (255 * 4)


def _inputs(arch: str, overrides: dict, d):
    """The JAX package's parameters and the inputs, written for the worker."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch), **overrides), kernels="off")
    jm = jax_build_model(jcfg)
    jparams = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    V = jcfg.vocab_size
    data = dict(tokens=rng.integers(1, V, (4, 17)).astype(np.int32),
                prompt=rng.integers(1, V, (4, 12)).astype(np.int32),
                round=rng.integers(1, V, (4, 4, 33)).astype(np.int32))
    arrays = {"p:" + k: np.asarray(v) for k, v in _flatten(jparams).items()}
    meta = {"overrides": overrides, "cache_len": 16, "steps": STEPS,
            "wire_codecs": list(WIRE_CODECS) if arch == WIRE_ARCH else []}
    np.savez(os.path.join(d, "in.npz"), __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **data, **arrays)
    return jm, jparams, data, meta


def _round_factors(new):
    return {jax.tree_util.keystr(path): (np.asarray(f.U @ f.S @ jnp.swapaxes(f.V, -1, -2)),
                                         np.asarray(f.rank))
            for path, f in jax.tree_util.tree_flatten_with_path(new, is_leaf=jax_is_factor)[0]
            if jax_is_factor(f)}


def _reference(jm, jparams, data, meta):
    want = {"loss": float(jm.loss_fn(jparams, {"tokens": jnp.asarray(data["tokens"])}))}
    logits, cache = jax.jit(lambda p, b: jm.serve_prefill(p, b, cache_len=16))(
        jparams, {"tokens": jnp.asarray(data["prompt"])})
    steps = [np.asarray(logits)]
    step = jax.jit(jm.serve_step)
    for _ in range(STEPS):
        nxt = jnp.asarray(steps[-1].argmax(-1)[:, None].astype(np.int32))
        logits, cache = step(jparams, cache, nxt)
        steps.append(np.asarray(logits))
    want["logits"] = np.stack(steps)
    logits, cache = jax.jit(lambda p, b: jm.serve_prefill(p, b, cache_len=16))(
        jparams, {"tokens": jnp.asarray(data["prompt"][:1])})
    steps = [np.asarray(logits)]
    for _ in range(STEPS):
        nxt = jnp.asarray(steps[-1].argmax(-1)[:, None].astype(np.int32))
        logits, cache = step(jparams, cache, nxt)
        steps.append(np.asarray(logits))
    want["logits_row"] = np.stack(steps)
    fc = JaxFedConfig(num_clients=4, s_star=2, lr=1e-2, tau=0.01)
    new, metrics = jax.jit(lambda p, b: jax_fedlrt_round(jm.loss_fn, p, b, fc))(
        jparams, {"tokens": jnp.asarray(data["round"])})
    want["loss_before"] = float(metrics["loss_before"])
    want["loss_after"] = float(metrics["loss_after"])
    want["factors"] = _round_factors(new)
    for codec in meta["wire_codecs"]:
        new, metrics = jax.jit(lambda p, b, c=codec: jax_fedlrt_round(
            jm.loss_fn, p, b, fc, wire=jax_wire.Wire(c)))(
            jparams, {"tokens": jnp.asarray(data["round"])})
        want[codec] = {k: float(metrics[k]) for k in ("loss_before", "loss_after", *BYTES)}
        want[codec]["factors"] = _round_factors(new)
    return want


@pytest.fixture(scope="module", params=sorted(CASES))
def sharded(request, tmp_path_factory):
    arch = request.param
    d = str(tmp_path_factory.mktemp(arch))
    jm, jparams, data, meta = _inputs(arch, CASES[arch], d)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    # the port's four ranks run while the JAX package computes its side
    worker = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
                               d, arch], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
    try:
        want = _reference(jm, jparams, data, meta)
        _, err = worker.communicate(timeout=600)
    finally:
        if worker.poll() is None:
            worker.kill()
    assert worker.returncode == 0, err[-3000:]
    got = np.load(os.path.join(d, "out.npz"))
    return want, {k: got[k] for k in got.files}


def test_sharded_loss_matches(sharded):
    want, got = sharded
    assert abs(float(got["loss"]) - want["loss"]) <= 1e-5


def test_sharded_prefill_and_greedy_decode_match(sharded):
    want, got = sharded
    assert got["logits"].shape == want["logits"].shape
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["logits"].argmax(-1), want["logits"].argmax(-1))


def test_sharded_decode_over_a_sequence_split_cache(sharded):
    """One row, fewer than the data axis's 2 ranks: the cache lies split on
    its sequence, the prefill writes each slot on its rank, and attention
    reduces the softmax's max and sum across the ranks' keys."""
    want, got = sharded
    np.testing.assert_allclose(got["logits_row"], want["logits_row"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["logits_row"].argmax(-1), want["logits_row"].argmax(-1))


def test_sharded_fedlrt_round_matches(sharded):
    want, got = sharded
    assert abs(float(got["loss_before"]) - want["loss_before"]) <= 1e-5 * abs(want["loss_before"])
    assert abs(float(got["loss_after"]) - want["loss_after"]) <= 1e-4 * abs(want["loss_after"])
    assert len(want["factors"]) > 0
    for path, (usv, rank) in want["factors"].items():
        np.testing.assert_array_equal(got["rank" + path], rank)
        err = np.abs(got["usv" + path] - usv).max() / np.abs(usv).max()
        assert err <= 1e-4, (path, err)


def _wire_bytes_match(want, got, codec):
    for k in BYTES:
        assert float(got[f"{codec}:{k}"]) == float(got[f"{codec}:unsharded:{k}"]) == \
            want[codec][k], (codec, k)


@pytest.mark.parametrize("sharded", [WIRE_ARCH], indirect=True)
def test_sharded_round_under_the_identity_wire_is_the_round_without_one(sharded):
    want, got = sharded
    assert bool(got["identity:same_bits"])
    _wire_bytes_match(want, got, "identity")


def _round_close(got, want, usv_rtol):
    """The int8 round's ranks equal to ``want``'s, losses within 1e-5 / 1e-4
    relative and each factor's ``U S Vᵀ`` within ``usv_rtol`` of its
    largest entry."""
    for k, rtol in (("loss_before", 1e-5), ("loss_after", 1e-4)):
        assert abs(float(got["int8_affine:" + k]) - want[k]) <= rtol * abs(want[k]), k
    assert len(want["factors"]) > 0
    for path, (usv, rank) in want["factors"].items():
        np.testing.assert_array_equal(got["int8_affine:rank" + path], rank)
        err = np.abs(got["int8_affine:usv" + path] - usv).max() / np.abs(usv).max()
        assert err <= usv_rtol, (path, err)


@pytest.mark.parametrize("sharded", [WIRE_ARCH], indirect=True)
def test_sharded_round_under_int8_matches_the_unsharded_round(sharded):
    """int8 on the wire under the mesh: each tensor's range taken over all
    its shards, so the payloads decode as the port's unsharded round's do."""
    _, got = sharded
    pre = "int8_affine:unsharded:"
    want = {k: float(got[pre + k]) for k in ("loss_before", "loss_after")}
    want["factors"] = {k[len(pre) + 3:]: (got[k], got[pre + "rank" + k[len(pre) + 3:]])
                       for k in got if k.startswith(pre + "usv")}
    _round_close(got, want, 1e-4)


@pytest.mark.parametrize("sharded", [WIRE_ARCH], indirect=True)
def test_sharded_round_under_int8_matches_the_reference(sharded):
    want, got = sharded
    _wire_bytes_match(want, got, "int8_affine")
    _round_close(got, want["int8_affine"], INT8_STEP_RTOL)
