"""The telemetry event schema and its validator (the JAX package's
``telemetry/events.py``, the same schema).

Every event the :class:`repro_torch.telemetry.TelemetryHub` emits is one flat
dict (JSONL: one JSON object per line) with a fixed key set:

==========  =========================================================
key         meaning
==========  =========================================================
``kind``    one of :data:`EVENT_KINDS`
``name``    dotted event name (``round``, ``wire.identity.bytes``, …)
``t``       wall seconds since the hub's epoch (monotonic, from
            :func:`repro_torch.telemetry.clock.perf_seconds`)
``dur``     wall duration in seconds for spans, else ``None``
``tv``      virtual-clock seconds when a virtual clock is
            attached, else ``None``
``durv``    virtual duration for spans (``None`` when not simulated)
``value``   metric value for counter/gauge/hist, else ``None``
``attrs``   flat dict of scalar attributes (round, client, …)
``seq``     per-hub monotone sequence number
==========  =========================================================

The hub's first event is a ``meta`` named ``hub_start`` whose attrs carry
``wall_epoch`` (Unix seconds of ``t == 0``) — the only place absolute
wall time appears, so events stay comparable across runs.

:func:`validate_event` / :func:`validate_jsonl` are the schema gate run
over emitted logs (``python -m repro_torch.telemetry validate``).
"""
from __future__ import annotations

import json
from typing import Iterator, List, Tuple

EVENT_KINDS = ("span", "counter", "gauge", "hist", "progress", "meta")

#: the exact key set of every event dict
EVENT_KEYS = ("kind", "name", "t", "dur", "tv", "durv", "value", "attrs", "seq")

_SCALAR = (bool, int, float, str, type(None))


def validate_event(event) -> List[str]:
    """Schema errors of one event dict (empty list = valid)."""
    errs: List[str] = []
    if not isinstance(event, dict):
        return [f"event must be a dict, got {type(event).__name__}"]
    missing = [k for k in EVENT_KEYS if k not in event]
    extra = sorted(set(event) - set(EVENT_KEYS))
    if missing:
        errs.append(f"missing key(s) {missing}")
    if extra:
        errs.append(f"unknown key(s) {extra}")
    if missing or extra:
        return errs
    if event["kind"] not in EVENT_KINDS:
        errs.append(f"kind must be one of {EVENT_KINDS}, got {event['kind']!r}")
    if not isinstance(event["name"], str) or not event["name"]:
        errs.append(f"name must be a non-empty string, got {event['name']!r}")
    if not isinstance(event["t"], (int, float)) or isinstance(event["t"], bool):
        errs.append(f"t must be a number, got {event['t']!r}")
    for opt in ("dur", "tv", "durv", "value"):
        v = event[opt]
        if v is not None and (not isinstance(v, (int, float)) or isinstance(v, bool)):
            errs.append(f"{opt} must be a number or null, got {v!r}")
    if not isinstance(event["seq"], int) or isinstance(event["seq"], bool):
        errs.append(f"seq must be an integer, got {event['seq']!r}")
    attrs = event["attrs"]
    if not isinstance(attrs, dict):
        errs.append(f"attrs must be a dict, got {attrs!r}")
    else:
        for k, v in attrs.items():
            if not isinstance(k, str):
                errs.append(f"attrs key {k!r} must be a string")
            if not isinstance(v, _SCALAR):
                errs.append(
                    f"attrs[{k!r}] must be a JSON scalar, got "
                    f"{type(v).__name__}"
                )
    if event["kind"] in ("counter", "gauge", "hist") and event["value"] is None:
        errs.append(f"{event['kind']} event carries no value")
    return errs


def iter_jsonl(path) -> Iterator[Tuple[int, dict]]:
    """``(lineno, event)`` pairs from a JSONL event log."""
    with open(path) as fh:
        for i, line in enumerate(fh, start=1):
            line = line.strip()
            if line:
                yield i, json.loads(line)


def validate_jsonl(path) -> List[str]:
    """All schema errors in a JSONL event log, prefixed with line numbers
    (empty list = the whole file is valid).  Also checks that ``seq`` is
    strictly increasing and that ``t`` never decreases across *non-span*
    events — those are stamped at emission, so they share one monotone
    timeline.  A span's ``t`` is its **start**, emitted at span end:
    events that fired inside it legitimately precede it in the file with
    larger ``t``, so spans are excluded from the ordering check (the
    Perfetto exporter orders per track instead)."""
    errs: List[str] = []
    last_seq, last_t = -1, float("-inf")
    try:
        for lineno, event in iter_jsonl(path):
            for e in validate_event(event):
                errs.append(f"line {lineno}: {e}")
                continue
            if not isinstance(event, dict) or set(event) != set(EVENT_KEYS):
                continue
            if isinstance(event["seq"], int) and event["seq"] <= last_seq:
                errs.append(
                    f"line {lineno}: seq {event['seq']} not increasing "
                    f"(previous {last_seq})"
                )
            if isinstance(event["seq"], int):
                last_seq = event["seq"]
            if event["kind"] != "span":
                if isinstance(event["t"], (int, float)) and event["t"] < last_t:
                    errs.append(
                        f"line {lineno}: t {event['t']} decreased "
                        f"(previous {last_t})"
                    )
                if isinstance(event["t"], (int, float)):
                    last_t = event["t"]
    except (OSError, json.JSONDecodeError) as e:
        errs.append(str(e))
    return errs
