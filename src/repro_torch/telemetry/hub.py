"""A telemetry hub for the serving path: wall-clock spans and metric
samples, fanned out to sinks.

The subset of the JAX package's ``telemetry/hub.py`` that serving uses:
``span``, ``span_wall_at``, ``counter``, ``gauge`` and ``flush``, with the
same event dicts, plus :class:`MemorySink`. The JSONL and Perfetto sinks
come in a later slice (ROADMAP.md). Telemetry reads state and never writes
it; a disabled hub (:data:`NULL_HUB`, the default of the serving classes)
returns before building any event.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

from repro_torch.telemetry.clock import perf_seconds, wall_time


class MemorySink:
    """Keep every event in a list — the test/programmatic sink."""

    name = "memory"

    def __init__(self):
        self.events: List[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def flush(self) -> None:
        pass


class TelemetryHub:
    """Fan structured run events out to sinks."""

    def __init__(self, sinks=(), *, enabled: bool = True, meta: Optional[dict] = None):
        self.enabled = bool(enabled)
        self.sinks: List[object] = list(sinks)
        self._seq = 0
        self._epoch = perf_seconds()
        self._noop = contextlib.nullcontext()
        if self.enabled and self.sinks:
            self._emit("meta", "hub_start", attrs={"wall_epoch": wall_time(), **(meta or {})})

    def _emit(self, kind, name, *, t=None, dur=None, value=None, attrs=None):
        event = {
            "kind": kind,
            "name": name,
            "t": (perf_seconds() - self._epoch) if t is None else float(t),
            "dur": dur,
            "tv": None,
            "durv": None,
            "value": value,
            "attrs": attrs or {},
            "seq": self._seq,
        }
        self._seq += 1
        for sink in self.sinks:
            sink.emit(event)

    @contextlib.contextmanager
    def _span_cm(self, name, attrs):
        t0 = perf_seconds()
        try:
            yield
        finally:
            self._emit("span", name, t=t0 - self._epoch, dur=perf_seconds() - t0, attrs=attrs)

    def span(self, name: str, **attrs):
        """Context manager timing a wall-clock span."""
        if not self.enabled:
            return self._noop
        return self._span_cm(name, attrs)

    def span_wall_at(self, name: str, t_start: float, t_end: float, **attrs):
        """A completed wall-clock span from explicit :func:`perf_seconds`
        endpoints (serving phases that interleave across requests)."""
        if not self.enabled:
            return
        self._emit("span", name, t=float(t_start) - self._epoch,
                   dur=float(t_end) - float(t_start), attrs=attrs)

    def counter(self, name: str, inc: float = 1.0, **attrs) -> None:
        if not self.enabled:
            return
        self._emit("counter", name, value=float(inc), attrs=attrs)

    def gauge(self, name: str, value: float, **attrs) -> None:
        if not self.enabled:
            return
        self._emit("gauge", name, value=float(value), attrs=attrs)

    def flush(self) -> None:
        for sink in self.sinks:
            sink.flush()


#: the no-op hub: disabled, sinkless — every call is an early return
NULL_HUB = TelemetryHub(enabled=False)
