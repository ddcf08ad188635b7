"""Chrome/Perfetto ``trace_event`` export of a telemetry event stream (the
JAX package's ``telemetry/perfetto.py``, the same tracks).

Renders hub events as a JSON object Perfetto (https://ui.perfetto.dev) and
``chrome://tracing`` load directly, with the run's two clocks as two
*processes* so a straggler quarter or a FedBuff staleness pileup is
visible as per-client tracks:

- pid 1 — **wall clock**: every span that measured a host-side duration
  (``dur`` is set) becomes a complete ("X") event at ``ts = t``.
- pid 2 — **virtual clock**: every span priced on a simulator's virtual
  clock (``durv`` is set) becomes an "X" event at
  ``ts = tv`` — e.g. the async engine's dispatch→arrival client rounds.

Within each process, tid 0 is the server; a ``client`` attr maps the
event onto that client's own track (tid = client + 1).  Counters and
gauges become "C" events on the wall-clock process, so effective rank and
staleness render as counter tracks under the spans.  Timestamps are
microseconds (the trace_event unit); metadata ("M") events name every
process and thread.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

WALL_PID = 1
VIRTUAL_PID = 2

#: the server's track within each clock process
SERVER_TID = 0


def _tid(event: dict) -> int:
    client = event.get("attrs", {}).get("client")
    if isinstance(client, int) and not isinstance(client, bool) and client >= 0:
        return client + 1
    return SERVER_TID


def _args(event: dict) -> dict:
    args = {k: v for k, v in event.get("attrs", {}).items() if v is not None}
    if event.get("value") is not None:
        args["value"] = event["value"]
    return args


def events_to_trace(events: Iterable[dict]) -> dict:
    """Telemetry events → a ``trace_event`` JSON object.

    Returns ``{"traceEvents": [...], "displayTimeUnit": "ms"}``; the
    caller serializes it.  Events that carry neither a wall nor a virtual
    duration (progress lines, meta, plain counters without values)
    contribute no span; counters/gauges contribute "C" samples.
    """
    out: List[dict] = []
    threads: Dict[Tuple[int, int], None] = {}

    def track(pid: int, tid: int) -> Tuple[int, int]:
        threads.setdefault((pid, tid), None)
        return pid, tid

    for ev in events:
        kind = ev.get("kind")
        if kind == "span":
            if ev.get("dur") is not None:
                pid, tid = track(WALL_PID, _tid(ev))
                out.append({
                    "ph": "X", "pid": pid, "tid": tid,
                    "name": ev["name"],
                    "ts": float(ev["t"]) * 1e6,
                    "dur": float(ev["dur"]) * 1e6,
                    "args": _args(ev),
                })
            if ev.get("durv") is not None and ev.get("tv") is not None:
                pid, tid = track(VIRTUAL_PID, _tid(ev))
                out.append({
                    "ph": "X", "pid": pid, "tid": tid,
                    "name": ev["name"],
                    "ts": float(ev["tv"]) * 1e6,
                    "dur": float(ev["durv"]) * 1e6,
                    "args": _args(ev),
                })
        elif kind in ("counter", "gauge", "hist") and ev.get("value") is not None:
            pid, tid = track(WALL_PID, SERVER_TID)
            out.append({
                "ph": "C", "pid": pid, "tid": tid,
                "name": ev["name"],
                "ts": float(ev["t"]) * 1e6,
                "args": {ev["name"]: ev["value"]},
            })

    meta: List[dict] = []
    for pid, pname in ((WALL_PID, "wall clock"), (VIRTUAL_PID, "virtual clock")):
        if any(p == pid for p, _ in threads):
            meta.append({
                "ph": "M", "pid": pid, "tid": SERVER_TID,
                "name": "process_name", "args": {"name": pname},
            })
    for pid, tid in sorted(threads):
        tname = "server" if tid == SERVER_TID else f"client {tid - 1}"
        meta.append({
            "ph": "M", "pid": pid, "tid": tid,
            "name": "thread_name", "args": {"name": tname},
        })
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}
