"""Telemetry for the port: a wall-clock shim and a hub with memory and
console sinks.

    from repro_torch.telemetry import MemorySink, TelemetryHub

    hub = TelemetryHub([MemorySink()])
    with hub.span("serve.prefill", rid=3):
        ...
"""
from repro_torch.telemetry.clock import perf_seconds, wall_time  # noqa: F401
from repro_torch.telemetry.hub import (  # noqa: F401
    NULL_HUB,
    ConsoleSink,
    MemorySink,
    TelemetryHub,
    default_hub,
)
