"""Pluggable telemetry sinks: where hub events go (the JAX package's
``telemetry/sinks.py``).

A sink is anything with ``emit(event) / flush() / close()`` (:class:`Sink`):

- :class:`MemorySink` — append to a list (tests, programmatic readers);
- :class:`JsonlSink` — one JSON object per line, the event log that
  ``python -m repro_torch.telemetry validate`` checks;
- :class:`ConsoleSink` — renders ``progress`` events to stdout and drops
  everything else: the engines' progress lines;
- :class:`PerfettoSink` — buffers events and writes a Chrome/Perfetto
  ``trace_event`` JSON file on flush and close
  (:func:`repro_torch.telemetry.perfetto.events_to_trace`).

Sinks only consume: they never mutate events and nothing reads them back
into the run, half of the telemetry-on ≡ telemetry-off invariant (the other
half: the hub reads state and never writes it).
"""
from __future__ import annotations

import json
import os
import sys
from typing import List, Optional, Protocol, runtime_checkable

from repro_torch.telemetry.perfetto import events_to_trace


@runtime_checkable
class Sink(Protocol):
    """Event consumer: the hub fans every event out to each sink."""

    def emit(self, event: dict) -> None:
        ...

    def flush(self) -> None:
        ...

    def close(self) -> None:
        ...


class MemorySink:
    """Keep every event in a list — the test/programmatic sink."""

    name = "memory"

    def __init__(self):
        self.events: List[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class ConsoleSink:
    """Render ``progress`` events as plain lines; drop everything else.

    ``stream=None`` resolves ``sys.stdout`` at emit time, so pytest's capsys
    and shell redirection both see the output.
    """

    name = "console"

    def __init__(self, stream=None):
        self.stream = stream

    def emit(self, event: dict) -> None:
        if event["kind"] == "progress":
            print(event["attrs"].get("message", event["name"]), file=self.stream or sys.stdout)

    def flush(self) -> None:
        (self.stream or sys.stdout).flush()

    def close(self) -> None:
        pass


def _open_parent(path: str) -> str:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    return path


class JsonlSink:
    """Write each event as one JSON line to ``path`` (parents created)."""

    name = "jsonl"

    def __init__(self, path):
        self.path = _open_parent(str(path))
        self._fh = open(self.path, "w")

    def emit(self, event: dict) -> None:
        self._fh.write(json.dumps(event) + "\n")

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


class PerfettoSink:
    """Buffer events; write a Perfetto-loadable trace file on flush and close.

    ``flush`` rewrites the whole file from the buffer, so a run that flushes
    leaves a loadable trace even if it dies before ``close``.
    """

    name = "perfetto"

    def __init__(self, path):
        self.path = _open_parent(str(path))
        self.events: List[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def flush(self) -> None:
        with open(self.path, "w") as fh:
            json.dump(events_to_trace(self.events), fh)
            fh.write("\n")

    def close(self) -> None:
        self.flush()


#: sink names accepted by :func:`make_sinks` / ``TelemetrySpec.sinks``
SINK_NAMES = ("console", "memory", "jsonl", "perfetto")


def make_sinks(spec: str, *, out_dir: Optional[str] = None) -> List[object]:
    """Comma-separated sink names → sink instances. ``jsonl`` writes
    ``<out_dir>/events.jsonl`` and ``perfetto`` ``<out_dir>/trace.json``;
    both need ``out_dir``."""
    sinks: List[object] = []
    for name in [s.strip() for s in spec.split(",") if s.strip()]:
        if name == "console":
            sinks.append(ConsoleSink())
        elif name == "memory":
            sinks.append(MemorySink())
        elif name in ("jsonl", "perfetto"):
            if not out_dir:
                raise ValueError(
                    f"the {name!r} sink needs an output directory (telemetry.dir)"
                )
            if name == "jsonl":
                sinks.append(JsonlSink(os.path.join(out_dir, "events.jsonl")))
            else:
                sinks.append(PerfettoSink(os.path.join(out_dir, "trace.json")))
        else:
            raise ValueError(
                f"unknown telemetry sink {name!r}; expected a comma list of {SINK_NAMES}"
            )
    return sinks
