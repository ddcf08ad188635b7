"""Structured telemetry: spans, metric streams, trace export (the JAX
package's ``repro.telemetry``, the same events and files).

    from repro_torch.telemetry import MemorySink, TelemetryHub

    hub = TelemetryHub([MemorySink()])
    with hub.span("serve.prefill", rid=3):
        ...
    hub.gauge("rank.effective_mean", 12.0, round=3)

Wall time through the one clock shim (:mod:`repro_torch.telemetry.clock`),
virtual time from an attached clock, and pluggable sinks: JSONL event log,
in-memory, console progress, Chrome/Perfetto ``trace_event`` export. The
hub reads run state and never writes it, so telemetry on ≡ off bit for bit.

Validate or export an event log from the shell::

    python -m repro_torch.telemetry validate results/telemetry/events.jsonl
    python -m repro_torch.telemetry export results/telemetry/events.jsonl trace.json
"""
from repro_torch.telemetry.clock import perf_seconds, wall_time  # noqa: F401
from repro_torch.telemetry.events import (  # noqa: F401
    EVENT_KEYS,
    EVENT_KINDS,
    validate_event,
    validate_jsonl,
)
from repro_torch.telemetry.hub import (  # noqa: F401
    NULL_HUB,
    TelemetryHub,
    default_hub,
    get_hub,
    hub_from_spec,
    set_hub,
)
from repro_torch.telemetry.perfetto import events_to_trace  # noqa: F401
from repro_torch.telemetry.sinks import (  # noqa: F401
    SINK_NAMES,
    ConsoleSink,
    JsonlSink,
    MemorySink,
    PerfettoSink,
    Sink,
    make_sinks,
)
