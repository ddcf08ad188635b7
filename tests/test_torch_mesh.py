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
from repro.models import build_model as jax_build_model
from repro.models.config import reduced as jax_reduced
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
CASES = {"qwen2-7b": {"num_kv_heads": 2}, "olmoe-1b-7b": {}}
STEPS = 3


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
    meta = {"overrides": overrides, "cache_len": 16, "steps": STEPS}
    np.savez(os.path.join(d, "in.npz"), __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **data, **arrays)
    return jm, jparams, data


def _reference(jm, jparams, data):
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
    want["factors"] = {}
    for path, f in jax.tree_util.tree_flatten_with_path(new, is_leaf=jax_is_factor)[0]:
        if jax_is_factor(f):
            want["factors"][jax.tree_util.keystr(path)] = (
                np.asarray(f.U @ f.S @ jnp.swapaxes(f.V, -1, -2)), np.asarray(f.rank))
    return want


@pytest.fixture(scope="module", params=sorted(CASES))
def sharded(request, tmp_path_factory):
    arch = request.param
    d = str(tmp_path_factory.mktemp(arch))
    jm, jparams, data = _inputs(arch, CASES[arch], d)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    # the port's four ranks run while the JAX package computes its side
    worker = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
                               d, arch], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
    try:
        want = _reference(jm, jparams, data)
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
