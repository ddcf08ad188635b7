"""The port's serving stack: token-identical to the JAX package on carried
parameters, and its own scheduler pins (continuous ≡ single sequence,
batching invariance, determinism, eos, static waves, admission limits).

Runs on the CPU (``device="cpu"``), where the kernel wrappers take their
plain versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxExperimentSpec
from repro.api import ModelSpec as JaxModelSpec
from repro.api import ServeSpec as JaxServeSpec
from repro.api import serve as jax_serve
from repro.checkpoint import save_checkpoint
from repro.checkpoint.io import _flatten
from repro_torch.api import ExperimentSpec, ModelSpec, ServeSpec, serve
from repro_torch.checkpoint import params_from_numpy
from repro_torch.serve import Completion, Request
from repro_torch.telemetry import MemorySink, TelemetryHub

SERVE_KW = dict(max_batch=3, max_prompt=16, prompt_bucket=8, max_new_tokens=6)


def jax_tiny_spec(**serve_kw):
    """``tests/test_serve.py::tiny_spec``."""
    return JaxExperimentSpec(
        name="serve-test",
        model=JaxModelSpec(kind="lm", preset="llm-tiny", smoke=True),
        serve=JaxServeSpec(**{**SERVE_KW, **serve_kw}),
    )


def tiny_spec(**serve_kw):
    return ExperimentSpec(
        name="serve-test",
        model=ModelSpec(kind="lm", preset="llm-tiny", smoke=True),
        serve=ServeSpec(**{**SERVE_KW, **serve_kw}),
    )


def prompts_for(spec, n=4, seed=0):
    """``tests/test_serve.py::prompts_for``."""
    rng = np.random.default_rng(seed)
    return [
        rng.integers(1, 256, size=int(rng.integers(3, spec.serve.max_prompt))).astype(np.int32)
        for _ in range(n)
    ]


@pytest.fixture(scope="module")
def jax_session():
    return jax_serve(jax_tiny_spec())


@pytest.fixture(scope="module")
def carried(jax_session):
    """The JAX session's parameters, carried into the port."""
    flat = {k: np.asarray(v) for k, v in _flatten(jax_session.engine.params).items()}
    return params_from_numpy(flat, "cpu")


@pytest.fixture(scope="module")
def session():
    return serve(tiny_spec(), device="cpu")


# ---------------------------------------------------------------------------
# the port ≡ the JAX package
# ---------------------------------------------------------------------------


def test_greedy_tokens_identical_to_jax(jax_session, carried):
    spec = tiny_spec()
    prompts = prompts_for(spec)
    want, _ = jax_session.generate(prompts, arrival_steps=[0, 0, 1, 3])
    got, _ = serve(spec, params=carried, device="cpu").generate(
        prompts, arrival_steps=[0, 0, 1, 3]
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_jax_checkpoint_round_trip_identical_tokens(jax_session, tmp_path):
    save_checkpoint(str(tmp_path / "round_000002.npz"), jax_session.engine.params,
                    meta={"round": 2})
    spec = tiny_spec(checkpoint=str(tmp_path))
    prompts = prompts_for(spec, n=3, seed=5)
    want, _ = jax_session.generate(prompts)
    got, _ = serve(spec, device="cpu").generate(prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_bf16_parameters_carry_across():
    """bf16 arrays (ml_dtypes in JAX, raw 2-byte records in an npz) keep
    their bits."""
    import jax.numpy as jnp

    a = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4), jnp.bfloat16)
    flat = {"w": np.asarray(a), "f@U": np.asarray(a), "f@S": np.asarray(a[:, :3]),
            "f@V": np.asarray(a), "f@rank": np.float32(2.0)}
    tree = params_from_numpy(flat, "cpu")
    assert tree["w"].dtype == torch.bfloat16 and tree["f"].rank.dtype == torch.float32
    np.testing.assert_array_equal(tree["w"].float().numpy(), np.asarray(a, np.float32))
    raw = params_from_numpy({"w": np.asarray(a).view("V2")}, "cpu", torch.float32)
    np.testing.assert_array_equal(raw["w"].numpy(), np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# the port's own serving pins
# ---------------------------------------------------------------------------


def ref_greedy(session, prompt, n):
    """Unbatched, unpadded, unbucketed decode through the raw model."""
    model, params = session.engine.model, session.engine.params
    with torch.inference_mode():
        logits, cache = model.serve_prefill(
            params, {"tokens": torch.as_tensor(prompt, dtype=torch.int64)[None]},
            cache_len=len(prompt) + n,
        )
        out = [int(torch.argmax(logits, -1)[0])]
        for _ in range(n - 1):
            logits, cache = model.serve_step(params, cache, torch.tensor([[out[-1]]]))
            out.append(int(torch.argmax(logits, -1)[0]))
    return out


def test_continuous_matches_single_sequence_reference(session):
    prompts = prompts_for(session.spec)
    outs, comps = session.generate(prompts, arrival_steps=[0, 0, 1, 3])
    for out, p in zip(outs, prompts):
        assert out.tolist() == ref_greedy(session, p, 6)
    assert any(c.admit_step > 0 for c in comps)  # admitted into freed slots mid-run


def test_greedy_deterministic_and_batching_invariant(session):
    prompts = prompts_for(session.spec)
    together, _ = session.generate(prompts)
    again, _ = session.generate(prompts)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(together[i], again[i])
        alone, _ = session.generate([p])
        np.testing.assert_array_equal(together[i], alone[0])


def test_temperature_sampling_reproducible_and_batching_invariant():
    spec = tiny_spec(temperature=1.3)
    sess = serve(spec, device="cpu")
    prompts = prompts_for(spec, n=3, seed=1)
    outs1, _ = sess.generate(prompts)
    outs2, _ = sess.generate(prompts)
    for a, b in zip(outs1, outs2):
        np.testing.assert_array_equal(a, b)  # keyed on (seed, rid, index)
    comps = sess.run([Request(rid=1, tokens=prompts[1])])
    np.testing.assert_array_equal(outs1[1], comps[0].tokens)
    greedy, _ = serve(tiny_spec(), device="cpu").generate(prompts)
    assert any(o.tolist() != g.tolist() for o, g in zip(outs1, greedy))


def test_eos_early_stop(session):
    [out], _ = session.generate([np.arange(1, 5, dtype=np.int32)])
    eos = int(out[0])
    comps = session.run([Request(rid=0, tokens=np.arange(1, 5, dtype=np.int32), eos_id=eos)])
    assert comps[0].tokens.tolist() == [eos]


def test_static_mode_admits_in_waves():
    sess = serve(tiny_spec(mode="static", max_batch=2, max_new_tokens=4), device="cpu")
    p = np.arange(1, 6, dtype=np.int32)
    comps = sess.run([Request(rid=i, tokens=p) for i in range(4)])
    admits = sorted(c.admit_step for c in comps)
    assert admits[0] == admits[1] and admits[2] == admits[3]
    assert admits[2] > admits[0]


def test_continuous_backfills_freed_slots():
    sess = serve(tiny_spec(max_batch=2, max_new_tokens=8), device="cpu")
    p = np.arange(1, 6, dtype=np.int32)
    comps = sess.run([
        Request(rid=0, tokens=p, max_new_tokens=2),
        Request(rid=1, tokens=p, max_new_tokens=8),
        Request(rid=2, tokens=p, max_new_tokens=2),
    ])
    by = {c.rid: c for c in comps}
    assert by[2].admit_step > by[0].admit_step
    assert by[2].admit_step <= by[1].finish_step
    assert [len(by[i].tokens) for i in range(3)] == [2, 8, 2]


def test_queue_overflow_raises():
    sched = serve(tiny_spec(max_batch=2, max_queue=2), device="cpu").scheduler
    p = np.arange(1, 5, dtype=np.int32)
    sched.submit(Request(rid=0, tokens=p))
    sched.submit(Request(rid=1, tokens=p))
    with pytest.raises(RuntimeError, match="queue full"):
        sched.submit(Request(rid=2, tokens=p))


def test_prompt_too_long_rejected(session):
    with pytest.raises(ValueError, match="exceeds max_prompt"):
        session.engine.prefill(np.arange(99, dtype=np.int32))
    with pytest.raises(ValueError, match="empty prompt"):
        session.engine.prefill(np.zeros(0, dtype=np.int32))


def test_completion_stats_and_telemetry():
    sink = MemorySink()
    spec = tiny_spec()
    sess = serve(spec, device="cpu", telemetry=TelemetryHub([sink]))
    _, comps = sess.generate(prompts_for(spec, n=3, seed=7), arrival_steps=[0, 1, 2])
    c = comps[0]
    assert isinstance(c, Completion) and c.prefill_s > 0 and c.decode_s > 0
    assert c.finish_step >= c.admit_step >= c.submit_step
    kinds = {(e["kind"], e["name"]) for e in sink.events}
    for want in [("span", "serve.prefill"), ("span", "serve.queued"), ("span", "serve.decode"),
                 ("counter", "serve.tokens"), ("gauge", "serve.queue_depth")]:
        assert want in kinds
    assert len([e for e in sink.events if e["name"] == "serve.decode"]) == 3


def test_spec_validation():
    with pytest.raises(ValueError, match="not ported"):
        ServeSpec(quantize="int8")
    with pytest.raises(ValueError, match="exactly one"):
        ModelSpec(preset="llm-tiny", arch="qwen2-7b")
    with pytest.raises(ValueError, match="no counterpart"):
        ModelSpec(preset="llm-tiny", kernels="interpret")
    assert dataclasses.replace(tiny_spec().serve, max_new_tokens=4).cache_len == 20


def test_missing_checkpoint_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="round_"):
        serve(tiny_spec(checkpoint=str(tmp_path)), device="cpu")
