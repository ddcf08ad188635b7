"""The port's telemetry against the JAX package's ``repro.telemetry``.

Within the port: a training round and a serving run are bit-for-bit the
same with telemetry on and off; the hub's mechanics (a disabled hub emits
nothing, ``sample_every`` drops only off-cadence gauges and hists, the
virtual clock stamps ``tv`` / ``durv``, the console sink renders progress
only, an enabled wire emits encode / decode spans and a bytes counter).

Across packages: the port's ``events.jsonl`` passes the JAX package's
validator as well as the port's; ``events_to_trace`` gives equal dicts on
one event list; a one-round sync run emits the same set of event (kind,
name) pairs in both; the ``validate`` / ``export`` CLI agrees.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.telemetry as jtel
from repro.checkpoint.io import _flatten
from repro_torch import api
from repro_torch import telemetry as tel
from repro_torch.checkpoint import params_from_numpy
from repro_torch.fed.sim import VirtualClock
from repro_torch.fed.wire import Wire
from repro_torch.telemetry.__main__ import main as tel_main
from repro_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True)
def _restore_global_hub():
    """build() / serve() install a process-global hub; put the old one back."""
    prev = tel.get_hub()
    yield
    tel.set_hub(prev)


def _sections(**telemetry):
    return dict(
        name="telemetry-parity", rounds=1, log_every=1,
        model=("ModelSpec", dict(preset="llm-tiny", smoke=True)),
        data=("DataSpec", dict(tokens_per_client=1024, seq=16, batch=2)),
        fed=("FedSpec", dict(clients=2, local_steps=1, tau=0.05)),
        serve=("ServeSpec", dict(max_batch=2, max_prompt=16, prompt_bucket=8,
                                 max_new_tokens=4)),
        telemetry=("TelemetrySpec", telemetry),
    )


def _spec(pkg, **telemetry):
    kw = {}
    for k, v in _sections(**telemetry).items():
        kw[k] = getattr(pkg, v[0])(**v[1]) if isinstance(v, tuple) else v
    return pkg.ExperimentSpec(**kw)


def _rows(history):
    out = []
    for r in history:
        row = {f.name: getattr(r, f.name) for f in dataclasses.fields(r) if f.name != "seconds"}
        row["ranks"] = {k: np.asarray(v).tolist() for k, v in row["ranks"].items()}
        row["cohort"] = np.asarray(row["cohort"]).tolist()
        out.append(row)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One port round with telemetry off and one with every file sink on,
    from the same seed; the second's files under ``out``."""
    out = tmp_path_factory.mktemp("telemetry")
    prev = tel.get_hub()
    off = api.build(_spec(api), device="cpu")
    off.run()
    on = api.build(_spec(api, enabled=True, sinks="memory,jsonl,perfetto", dir=str(out)),
                   device="cpu")
    on.run()
    on.hub.close()
    tel.set_hub(prev)
    return off, on, out


def test_round_bit_identical_with_telemetry_on(runs):
    off, on, _ = runs
    la, lb = tree_leaves(off.params), tree_leaves(on.params)
    assert len(la) == len(lb) and all(torch.equal(a, b) for a, b in zip(la, lb))
    assert _rows(off.history) == _rows(on.history)
    [mem] = [s for s in on.hub.sinks if isinstance(s, tel.MemorySink)]
    names = {(e["kind"], e["name"]) for e in mem.events}
    assert {("meta", "hub_start"), ("span", "round.step"), ("gauge", "rank.effective_mean"),
            ("counter", "wire.bytes_up"), ("counter", "kernels.dispatch")} <= names


def test_port_jsonl_passes_both_validators(runs):
    _, on, out = runs
    path = out / "events.jsonl"
    assert tel.validate_jsonl(path) == [] and jtel.validate_jsonl(path) == []
    [mem] = [s for s in on.hub.sinks if isinstance(s, tel.MemorySink)]
    with open(path) as fh:
        assert [json.loads(line) for line in fh] == mem.events
    for ev in mem.events:
        assert tel.validate_event(ev) == [] and jtel.validate_event(ev) == []
    trace = json.loads((out / "trace.json").read_text())
    assert trace == tel.events_to_trace(mem.events) == jtel.events_to_trace(mem.events)
    assert any(e["ph"] == "X" and e["name"] == "round.step" for e in trace["traceEvents"])


def test_events_to_trace_matches_on_clients_and_virtual_clock():
    mem = tel.MemorySink()
    clock = VirtualClock()
    hub = tel.TelemetryHub([mem], clock=clock)
    for c in range(3):
        clock.advance_to(0.5 * c)
        with hub.span("client_step", round=0, client=c):
            pass
        hub.span_at("client_round", 0.5 * c, 0.5 * c + 2.0, client=c)
        hub.gauge("staleness", float(c), client=c)
    hub.counter("bytes", 7.0)
    hub.progress("done")
    assert tel.events_to_trace(mem.events) == jtel.events_to_trace(mem.events)
    pids = {e["pid"] for e in tel.events_to_trace(mem.events)["traceEvents"]}
    assert pids == {1, 2}


def _async_sections(**telemetry):
    """The JAX package's telemetry pin: an async run under a straggler
    fleet on the mlp task (``tests/test_telemetry.py`` ``async_spec``)."""
    return dict(
        name="telemetry-pin", rounds=3, log_every=0,
        model=("ModelSpec", dict(kind="mlp", dim=16, classes=4, hidden=32, r_max=8,
                                 kernels="off")),
        data=("DataSpec", dict(kind="classification", batch=16, num_points=512, holdout=128)),
        fed=("FedSpec", dict(method="fedlrt", correction="simplified", clients=4,
                             local_steps=2, lr=5e-2, tau=0.03, eval_after=False)),
        engine=("EngineSpec", dict(kind="async", buffer_size=2)),
        sim=("SimSpec", dict(profile="straggler:0.25,10")),
        telemetry=("TelemetrySpec", telemetry),
    )


def _async_spec(pkg, **telemetry):
    return pkg.ExperimentSpec(**{
        k: getattr(pkg, v[0])(**v[1]) if isinstance(v, tuple) else v
        for k, v in _async_sections(**telemetry).items()
    })


def test_async_run_log_has_the_simulator_events(tmp_path):
    """An async run on the virtual clock: its JSONL passes both packages'
    validators and carries the simulator's events (events popped, the
    per-client ``client_round`` spans, the server's ``aggregate`` spans,
    the staleness gauge) with the JAX package's (kind, name) pairs; its
    trace has both clocks and one virtual track per client; and it is the
    telemetry-off run bit for bit."""
    out = tmp_path / "telemetry"
    on = api.build(_async_spec(api, enabled=True, sinks="memory,jsonl,perfetto", dir=str(out)),
                   device="cpu")
    on.run()
    on.hub.close()
    off = api.build(_async_spec(api), device="cpu")
    off.run()
    la, lb = tree_leaves(on.params), tree_leaves(off.params)
    assert len(la) == len(lb) and all(torch.equal(a, b) for a, b in zip(la, lb))
    assert on.engine.timeline.keys() == off.engine.timeline.keys()
    path = out / "events.jsonl"
    assert tel.validate_jsonl(path) == [] and jtel.validate_jsonl(path) == []
    [mem] = [s for s in on.hub.sinks if isinstance(s, tel.MemorySink)]
    names = {(e["kind"], e["name"]) for e in mem.events}
    assert {("meta", "hub_start"), ("span", "client_round"), ("span", "aggregate"),
            ("counter", "sim.events_popped"), ("gauge", "rank.effective_mean"),
            ("gauge", "staleness_mean")} <= names
    jexp = japi.build(_async_spec(japi, enabled=True, sinks="memory"))
    jexp.run()
    [jmem] = jexp.hub.sinks
    assert names == {(e["kind"], e["name"]) for e in jmem.events}
    trace = json.loads((out / "trace.json").read_text())
    assert trace == jtel.events_to_trace(mem.events)
    evs = trace["traceEvents"]
    meta = {e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "process_name"}
    assert meta == {"wall clock", "virtual clock"}
    virtual_pid, server_tid = 2, 0
    client_tids = {e["tid"] for e in evs if e["ph"] == "X" and e["pid"] == virtual_pid
                   and e["tid"] != server_tid}
    # the 10x straggler may still be in flight after 3 aggregates
    assert {1, 2, 3} <= client_tids <= {1, 2, 3, 4}
    assert any(e["ph"] == "X" and e["pid"] == virtual_pid and e["tid"] == server_tid
               for e in evs)


def test_sync_round_emits_the_reference_event_names():
    """The (kind, name) pairs of a one-round sync run, in both packages."""
    prev_port, prev_jax = tel.get_hub(), jtel.get_hub()
    jexp = japi.build(_spec(japi, enabled=True, sinks="memory"))
    flat = {k: np.asarray(v) for k, v in _flatten(jexp.engine.params).items()}
    texp = api.build(_spec(api, enabled=True, sinks="memory"),
                     params=params_from_numpy(flat, "cpu"), device="cpu")
    jexp.run()
    texp.run()
    jtel.set_hub(prev_jax)
    tel.set_hub(prev_port)

    def pairs(exp):
        [mem] = [s for s in exp.hub.sinks if s.name == "memory"]
        return {(e["kind"], e["name"]) for e in mem.events}

    assert pairs(texp) == pairs(jexp)


def test_serve_bit_identical_with_telemetry_on(tmp_path):
    prompts = [np.arange(1, 6), np.arange(3, 12), np.arange(2, 4)]
    off = api.serve(_spec(api), device="cpu")
    on = api.serve(_spec(api, enabled=True, sinks="memory,jsonl", dir=str(tmp_path)),
                   device="cpu")
    outs_off, _ = off.generate(prompts)
    outs_on, _ = on.generate(prompts)
    for a, b in zip(outs_off, outs_on):
        np.testing.assert_array_equal(a, b)
    for p in prompts:
        assert torch.equal(off.engine.prefill(p)[0], on.engine.prefill(p)[0])
    [mem] = [s for s in on.hub.sinks if isinstance(s, tel.MemorySink)]
    tokens = sum(e["value"] for e in mem.events if e["name"] == "serve.tokens")
    assert tokens == sum(len(o) for o in outs_on)
    on.hub.close()
    assert jtel.validate_jsonl(tmp_path / "events.jsonl") == []


def test_disabled_hub_is_noop():
    sink = tel.MemorySink()
    hub = tel.TelemetryHub([sink], enabled=False)
    with hub.span("x", round=0):
        pass
    hub.span_at("y", 0.0, 1.0)
    hub.span_wall_at("z", 0.0, 1.0)
    hub.counter("c")
    hub.gauge("g", 1.0)
    hub.hist("h", 1.0)
    hub.progress("hello")
    assert sink.events == []
    assert hub.span("a") is hub.span("b")
    assert tel.NULL_HUB.enabled is False


def test_sample_every_drops_offcadence_gauges():
    sink = tel.MemorySink()
    hub = tel.TelemetryHub([sink], sample_every=2)
    for r in range(4):
        hub.gauge("g", float(r), round=r)
        hub.hist("h", float(r), round=r)
        hub.counter("c", 1.0, round=r)
        hub.progress("p", round=r)
        with hub.span("s", round=r):
            pass
    by_kind = {}
    for e in sink.events:
        by_kind.setdefault(e["kind"], []).append(e["attrs"].get("round"))
    assert by_kind["gauge"] == [0, 2] and by_kind["hist"] == [0, 2]
    assert by_kind["counter"] == by_kind["span"] == by_kind["progress"] == [0, 1, 2, 3]


def test_virtual_clock_attaches():
    sink = tel.MemorySink()
    hub = tel.TelemetryHub([sink])
    assert hub.virtual_now() is None and sink.events[0]["tv"] is None
    clock = VirtualClock()
    hub.attach_clock(clock)
    clock.advance_to(2.5)
    hub.counter("c")
    assert sink.events[-1]["tv"] == 2.5
    hub.span_at("s", 1.0, 2.0)
    assert (sink.events[-1]["tv"], sink.events[-1]["durv"], sink.events[-1]["dur"]) == (
        1.0, 1.0, None)


def test_console_sink_renders_progress_only(capsys):
    hub = tel.TelemetryHub([tel.ConsoleSink()])
    hub.gauge("g", 1.0)
    hub.progress("round 3 done")
    out = capsys.readouterr().out
    assert out == "round 3 done\n"


def test_hub_from_spec_and_make_sinks(tmp_path):
    assert tel.hub_from_spec(api.TelemetrySpec()) is tel.default_hub()
    hub = tel.hub_from_spec(api.TelemetrySpec(enabled=True, sinks="console, perfetto",
                                              dir=str(tmp_path), sample_every=3),
                            meta={"spec_hash": "abc"})
    assert [s.name for s in hub.sinks] == ["console", "perfetto"] and hub.sample_every == 3
    hub.close()
    assert json.loads((tmp_path / "trace.json").read_text())["displayTimeUnit"] == "ms"
    with pytest.raises(ValueError, match="output directory"):
        tel.make_sinks("jsonl")
    with pytest.raises(ValueError, match="unknown telemetry sink"):
        tel.make_sinks("console,bogus")
    assert tel.SINK_NAMES == jtel.SINK_NAMES
    assert all(isinstance(s, tel.Sink) for s in tel.make_sinks("memory,console"))


def test_wire_spans_and_bytes_only_with_an_enabled_hub():
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    plain, nbytes = Wire("int8_affine").roundtrip(tree, name="up")
    sink = tel.MemorySink()
    got, got_bytes = Wire("int8_affine", telemetry=tel.TelemetryHub([sink])).roundtrip(
        tree, name="up")
    assert torch.equal(got["w"], plain["w"]) and got_bytes == nbytes
    names = [(e["kind"], e["name"], e["attrs"].get("payload")) for e in sink.events[1:]]
    assert names == [("span", "wire.int8_affine.encode", "up"),
                     ("span", "wire.int8_affine.decode", "up"),
                     ("counter", "wire.int8_affine.bytes", "up")]
    assert sink.events[-1]["value"] == float(nbytes)
    quiet = tel.MemorySink()
    Wire("identity", telemetry=tel.TelemetryHub([quiet], enabled=False)).roundtrip(tree)
    assert quiet.events == []


@pytest.mark.parametrize("policy,resolved", [("auto", "True"), ("off", "False")])
def test_kernel_dispatch_counter(policy, resolved):
    from repro_torch.kernels.ops import use_kernels_for

    sink = tel.MemorySink()
    prev = tel.set_hub(tel.TelemetryHub([sink]))
    try:
        assert use_kernels_for(policy) is (policy == "auto")
    finally:
        tel.set_hub(prev)
    ev = sink.events[-1]
    assert (ev["kind"], ev["name"], ev["attrs"]) == (
        "counter", "kernels.dispatch", {"policy": policy, "resolved": resolved})


def test_validate_and_export_cli(runs, tmp_path, capsys):
    _, _, out = runs
    events = out / "events.jsonl"
    assert tel_main(["validate", str(events)]) == 0
    assert "ok (" in capsys.readouterr().out
    trace = tmp_path / "t.json"
    assert tel_main(["export", str(events), str(trace)]) == 0
    with open(events) as fh:
        evs = [json.loads(line) for line in fh]
    assert json.loads(trace.read_text()) == jtel.events_to_trace(evs)
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "nope", "name": "x"}) + "\n")
    assert tel_main(["validate", str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().out
