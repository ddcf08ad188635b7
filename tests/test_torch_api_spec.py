"""The port's spec files against the JAX package's: the same TOML parses,
validates and hashes the same in both packages.

- Every ``examples/configs/*.toml`` gives equal ``to_dict()`` and
  ``spec_hash()`` in both packages; the port's TOML and JSON round-trip,
  and what it writes the JAX package reads to the same hash.
- ``--set`` overrides, the train CLI's ``--config`` / flags / ``--set``
  resolution and the spec validation of the new sections match the JAX
  package's.
- Within the port, the flag form and the spec-file form of one experiment
  train to the same bits.
- ``python -m repro_torch.api validate|describe|run --device cpu`` works on
  ``sync_baseline.toml`` and ``vision_partial.toml``; the simulator configs
  (``async_straggler``, ``hier_int8_wire``, ``telemetry_trace``) build and
  run a round with the JAX package's history fields and virtual clock.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.fed.engine import RoundResult as JRoundResult
from repro.launch.train import spec_from_argv as jax_spec_from_argv
from repro_torch import api
from repro_torch.api.__main__ import main as api_main
from repro_torch.core.factorization import is_factor
from repro_torch.fed.engine import history_to_state
from repro_torch.launch import train as launch_train
from repro_torch.utils.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: F401

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "examples" / "configs").glob("*.toml"))
SYNC = next(p for p in CONFIGS if p.name == "sync_baseline.toml")
VISION = next(p for p in CONFIGS if p.name == "vision_partial.toml")
#: shrink the example specs for a CPU test (fields both packages share)
SMALL_LM = ["model.smoke=true", "data.tokens_per_client=2000", "data.seq=32",
            "fed.local_steps=2"]
SMALL_MLP = ["data.num_points=2048", "data.holdout=256", "fed.local_steps=2"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_example_configs_hash_the_same(path):
    j, t = japi.load_spec(path), api.load_spec(path)
    assert t.to_dict() == j.to_dict()
    assert t.spec_hash() == j.spec_hash()


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_toml_and_json_roundtrip(path, tmp_path):
    spec = api.load_spec(path)
    assert api.ExperimentSpec.from_toml(spec.to_toml()) == spec
    assert api.ExperimentSpec.from_json(spec.to_json()) == spec
    for name in ("s.toml", "s.json"):
        spec.save(tmp_path / name)
        assert api.load_spec(tmp_path / name) == spec
        # the JAX package reads what the port writes, to the same hash
        assert japi.load_spec(tmp_path / name).spec_hash() == spec.spec_hash()
    with pytest.raises(ValueError, match=".toml or .json"):
        spec.save(tmp_path / "s.yaml")


OVERRIDES = [
    ["wire.codec=int8_affine", "fed.clients=8"],
    ["checkpoint.dir=ck", "checkpoint.every=2", "fed.lr=0.1"],
    ["engine.kind=async", "engine.buffer_size=2", "sim.profile=straggler:0.25,10"],
    ["serve.quantize=int8", "serve.rank_slice=true", "serve.eos_id=none"],
    ["telemetry.enabled=true", "telemetry.sinks=console,memory", "model.preset=llm-100m"],
]


@pytest.mark.parametrize("sets", OVERRIDES, ids=lambda s: s[0])
def test_overrides_match(sets):
    j = japi.load_spec(SYNC).with_overrides(sets)
    t = api.load_spec(SYNC).with_overrides(sets)
    assert t.to_dict() == j.to_dict() and t.spec_hash() == j.spec_hash()


BAD = [
    ["engine.kind=fancy"], ["engine.buffer_size=2"], ["engine.kind=hier", "engine.edges=0"],
    ["engine.kind=async", "engine.staleness_power=-1"], ["wire.codec=gzip"],
    ["wire.edge_codec=int8_affine"], ["sim.profile=zipf"], ["sim.profile=straggler:2"],
    ["telemetry.sample_every=0"], ["telemetry.sinks=kafka"],
    ["telemetry.enabled=true", "telemetry.sinks=jsonl"], ["checkpoint.every=-1"],
    ["serve.quantize=int4"], ["serve.materialize=true", "serve.quantize=int8"],
    ["serve.materialize=true", "serve.rank_slice=true"],
    ["engine.kind=hier", "checkpoint.dir=ck"],
    ["engine.kind=async", "participation.mode=uniform", "participation.cohort_size=2"],
    ["engine.kind=async", "engine.buffer_size=9"], ["nosuch.field=1"], ["fed.clients=x"],
]


@pytest.mark.parametrize("sets", BAD, ids=lambda s: "+".join(s))
def test_invalid_overrides_rejected_by_both(sets):
    with pytest.raises(ValueError):
        japi.load_spec(SYNC).with_overrides(sets)
    with pytest.raises(ValueError):
        api.load_spec(SYNC).with_overrides(sets)


CLI_CASES = [
    ["--config", str(SYNC)],
    ["--config", str(SYNC), "--set", "wire.codec=int8_affine", "--clients", "8"],
    ["--config", str(VISION), "--wire-codec", "topk_rank", "--set", "fed.lr=0.2"],
    ["--preset", "llm-100m", "--checkpoint-dir", "ck", "--checkpoint-every", "5",
     "--set", "checkpoint.every=3", "--method", "fedavg"],
]


@pytest.mark.parametrize("argv", CLI_CASES, ids=range(len(CLI_CASES)))
def test_train_cli_resolves_like_jax(argv):
    j, t = jax_spec_from_argv(argv), launch_train.spec_from_argv(argv)
    assert t.to_dict() == j.to_dict()


def test_flag_form_equals_spec_file_form(tmp_path):
    """One experiment from flags and from a spec file: the same spec and the
    same bits after a round, within the port."""
    flags = ["--preset", "llm-tiny", "--smoke", "--clients", "2", "--local-steps", "1",
             "--seq", "32", "--batch", "2", "--wire-codec", "int8_affine", "--rounds", "1"]
    from_flags = launch_train.spec_from_argv(flags)
    path = tmp_path / "spec.toml"
    from_flags.save(path)
    from_file = launch_train.spec_from_argv(["--config", str(path)])
    assert from_file == from_flags
    small = ["data.tokens_per_client=2000"]
    a = api.build(from_flags.with_overrides(small), device="cpu")
    b = api.build(from_file.with_overrides(small), device="cpu")
    a.run(log_every=0)
    b.run(log_every=0)
    la, lb = tree_leaves(a.params), tree_leaves(b.params)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
    assert a.history[0].wire_bytes_up_per_client == b.history[0].wire_bytes_up_per_client


def test_cli_validate(capsys):
    assert api_main(["validate", *map(str, CONFIGS)]) == 0
    out = capsys.readouterr().out
    for path in CONFIGS:
        assert f"{path}: ok [spec {japi.load_spec(path).spec_hash()}]" in out


def test_cli_validate_reports_invalid(tmp_path, capsys):
    bad = tmp_path / "bad.toml"
    bad.write_text('[wire]\ncodec = "gzip"\n')
    assert api_main(["validate", str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().out


ASYNC = next(p for p in CONFIGS if p.name == "async_straggler.toml")


@pytest.mark.parametrize("path,small", [(SYNC, SMALL_LM), (VISION, SMALL_MLP), (ASYNC, SMALL_LM)],
                         ids=["sync_baseline", "vision_partial", "async_straggler"])
def test_cli_describe_and_run_on_cpu(path, small, capsys):
    sets = [a for s in small for a in ("--set", s)]
    assert api_main(["describe", str(path), "--device", "cpu", *sets]) == 0
    out = capsys.readouterr().out
    spec = api.load_spec(path).with_overrides(small)
    assert f"[spec {spec.spec_hash()}]" in out and f"wire           {spec.wire.codec}" in out
    assert f"sim            {spec.sim.profile or '(no virtual clock)'}" in out
    assert api_main(["run", str(path), "--device", "cpu", "--rounds", "1", "--log-every", "1",
                     *sets]) == 0
    out = capsys.readouterr().out
    assert f"MB measured [{spec.wire.codec}]" in out and "round    0" in out
    simulated = spec.engine.kind != "sync" or spec.sim.profile is not None
    assert ("; virtual time " in out and f"s [{spec.engine.kind}]" in out) == simulated


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("asserts the behaviour without a card")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        api_main(["run", str(SYNC), "--rounds", "1"])


@pytest.mark.parametrize("name", ["async_straggler.toml", "hier_int8_wire.toml",
                                  "telemetry_trace.toml"])
def test_unported_configs_raise_from_build(name, tmp_path):
    """These simulator configs were refused until ``fed/sim/`` was ported;
    now each builds at smoke size and runs a round on the virtual clock,
    with the reference's history fields (their values are held to the
    reference in tests/test_torch_sim.py)."""
    sets = SMALL_LM + [f"telemetry.dir={tmp_path}"]
    spec = api.load_spec(next(p for p in CONFIGS if p.name == name)).with_overrides(sets)
    exp = api.build(spec, device="cpu")
    assert exp.is_simulated and spec.engine.kind in exp.describe()
    [res] = exp.run(rounds=1, log_every=0)
    [row] = history_to_state([res])
    assert set(row) == {f.name for f in dataclasses.fields(JRoundResult)}
    json.dumps(row)
    assert res.t_virtual > 0 and res.virtual_seconds > 0 and np.isfinite(res.loss_before)
    assert res.wire_codec.startswith(spec.wire.edge_codec or spec.wire.codec)
    assert exp.comm_total_bytes() > 0
    exp.hub.close()


@pytest.mark.parametrize("sets", [["serve.rank_slice=true"], ["serve.quantize=bf16"],
                                  ["serve.materialize=true"]], ids=lambda s: s[0])
def test_unported_serve_values_raise_from_serve(sets):
    """These serve values were refused until serve/quantize.py was ported;
    now ``serve()`` applies them and serves."""
    spec = api.load_spec(SYNC).with_overrides(["model.smoke=true", "serve.max_new_tokens=3",
                                               *sets])
    session = api.serve(spec, device="cpu")
    sv = spec.serve
    factors = [x for x in tree_leaves(session.engine.params, is_leaf=is_factor) if is_factor(x)]
    if sv.materialize:
        assert factors == [] and "materialized-dense" in session.describe()
    elif sv.quantize == "bf16":
        assert factors and all(f.U.dtype == torch.bfloat16 for f in factors)
    else:
        assert factors and "rank_slice" in session.describe()
    outs, _ = session.generate([np.arange(1, 6)])
    assert len(outs[0]) == 3


def test_model_spec_has_the_reference_fields():
    """The spec tree is the JAX package's, section by section."""
    for section in ("ModelSpec", "DataSpec", "FedSpec", "ParticipationSpec", "EngineSpec",
                    "WireSpec", "SimSpec", "CheckpointSpec", "TelemetrySpec", "ServeSpec",
                    "ExperimentSpec"):
        got = [(f.name, f.default) for f in dataclasses.fields(getattr(api, section))]
        want = [(f.name, f.default) for f in dataclasses.fields(getattr(japi, section))]
        assert got == want, section
