"""The telemetry hub: dual-clock spans, metric streams, progress events
(the JAX package's ``telemetry/hub.py``, the same events).

One :class:`TelemetryHub` per run fans structured events out to its sinks
(:mod:`repro_torch.telemetry.sinks`). Every event carries **wall** time
(``t``, monotonic seconds since the hub's epoch, read through
:mod:`repro_torch.telemetry.clock`) and, when a virtual clock is attached
(anything with a float ``.now``; a simulator's), **virtual** time (``tv``).

- ``with hub.span("round", round=r): ...`` — wall-duration span;
- ``hub.span_at(name, tv0, tv1, client=c)`` — a span on the virtual clock
  with explicit endpoints;
- ``hub.span_wall_at(name, t0, t1)`` — a span on the wall clock with
  explicit endpoints (serving phases that interleave across requests);
- ``hub.counter / gauge / hist`` — metric samples;
- ``hub.progress(msg)`` — a human-facing line, rendered by
  :class:`~repro_torch.telemetry.sinks.ConsoleSink`.

Telemetry **reads state and never writes it** (no RNG draws, no clock
advances, no engine mutation), so a run with telemetry on is bit-for-bit
the run with it off. A disabled hub (``enabled=False``, e.g.
:data:`NULL_HUB`) returns from every call before building an event and
hands out one cached no-op context manager.

Gauges and hists that carry a ``round=`` attr respect ``sample_every``:
only rounds divisible by the cadence are recorded. Spans, counters and
progress are never sampled away.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

from repro_torch.telemetry.clock import perf_seconds, wall_time
from repro_torch.telemetry.sinks import ConsoleSink, make_sinks

_UNSET = object()


class TelemetryHub:
    """Fan structured run events out to pluggable sinks; see module doc."""

    def __init__(self, sinks=(), *, enabled: bool = True, clock=None, sample_every: int = 1,
                 meta: Optional[dict] = None):
        self.enabled = bool(enabled)
        self.sinks: List[object] = list(sinks)
        self.sample_every = max(int(sample_every), 1)
        self._clock = clock
        self._seq = 0
        self._epoch = perf_seconds()
        self._noop = contextlib.nullcontext()
        if self.enabled and self.sinks:
            self._emit("meta", "hub_start", attrs={"wall_epoch": wall_time(), **(meta or {})})

    # -- clocks ------------------------------------------------------------

    def attach_clock(self, clock) -> None:
        """Attach a virtual clock (read-only: the hub only reads
        ``clock.now``; advancing it stays the simulator's job)."""
        self._clock = clock

    def virtual_now(self) -> Optional[float]:
        return None if self._clock is None else float(self._clock.now)

    # -- emission core -----------------------------------------------------

    def _emit(self, kind, name, *, t=None, dur=None, tv=_UNSET, durv=None, value=None,
              attrs=None):
        event = {
            "kind": kind,
            "name": name,
            "t": (perf_seconds() - self._epoch) if t is None else float(t),
            "dur": dur,
            "tv": self.virtual_now() if tv is _UNSET else tv,
            "durv": durv,
            "value": value,
            "attrs": attrs or {},
            "seq": self._seq,
        }
        self._seq += 1
        for sink in self.sinks:
            sink.emit(event)

    def _sampled(self, attrs: dict) -> bool:
        r = attrs.get("round")
        if r is None or self.sample_every == 1:
            return True
        return int(r) % self.sample_every == 0

    # -- spans -------------------------------------------------------------

    @contextlib.contextmanager
    def _span_cm(self, name, attrs):
        t0 = perf_seconds()
        tv0 = self.virtual_now()
        try:
            yield
        finally:
            self._emit("span", name, t=t0 - self._epoch, dur=perf_seconds() - t0, tv=tv0,
                       attrs=attrs)

    def span(self, name: str, **attrs):
        """Context manager timing a wall-clock span (virtual time stamped at
        entry; virtual durations come from :meth:`span_at`)."""
        if not self.enabled:
            return self._noop
        return self._span_cm(name, attrs)

    def span_at(self, name: str, tv_start: float, tv_end: float, **attrs):
        """A completed span on the **virtual** clock with explicit endpoints,
        on ``attrs['client']``'s track in the trace export."""
        if not self.enabled:
            return
        self._emit("span", name, tv=float(tv_start), durv=float(tv_end) - float(tv_start),
                   attrs=attrs)

    def span_wall_at(self, name: str, t_start: float, t_end: float, **attrs):
        """A completed span on the **wall** clock from explicit
        :func:`perf_seconds` endpoints."""
        if not self.enabled:
            return
        self._emit("span", name, t=float(t_start) - self._epoch,
                   dur=float(t_end) - float(t_start), attrs=attrs)

    # -- metrics -----------------------------------------------------------

    def counter(self, name: str, inc: float = 1.0, **attrs) -> None:
        if not self.enabled:
            return
        self._emit("counter", name, value=float(inc), attrs=attrs)

    def gauge(self, name: str, value: float, **attrs) -> None:
        if not self.enabled or not self._sampled(attrs):
            return
        self._emit("gauge", name, value=float(value), attrs=attrs)

    def hist(self, name: str, value: float, **attrs) -> None:
        if not self.enabled or not self._sampled(attrs):
            return
        self._emit("hist", name, value=float(value), attrs=attrs)

    # -- progress / lifecycle ----------------------------------------------

    def progress(self, message: str, **attrs) -> None:
        """A human-facing progress line (rendered by :class:`ConsoleSink`)."""
        if not self.enabled:
            return
        self._emit("progress", "progress", attrs={"message": message, **attrs})

    def flush(self) -> None:
        for sink in self.sinks:
            sink.flush()

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()


#: the no-op hub: disabled, sinkless — every call is an early return
NULL_HUB = TelemetryHub(enabled=False)

#: console-only hub for engines built without one (made on first use)
_DEFAULT_HUB: Optional[TelemetryHub] = None

#: the process-global hub, for sites with no engine in reach (kernel
#: dispatch counters); build() and serve() point it at the run's hub
_GLOBAL_HUB: TelemetryHub = NULL_HUB


def default_hub() -> TelemetryHub:
    """The console-only hub engines fall back to when built without one."""
    global _DEFAULT_HUB
    if _DEFAULT_HUB is None:
        _DEFAULT_HUB = TelemetryHub(sinks=(ConsoleSink(),))
    return _DEFAULT_HUB


def get_hub() -> TelemetryHub:
    """The process-global hub (NULL_HUB until a build() or serve() installs one)."""
    return _GLOBAL_HUB


def set_hub(hub: TelemetryHub) -> TelemetryHub:
    """Install ``hub`` as the process-global hub; returns the previous one."""
    global _GLOBAL_HUB
    prev = _GLOBAL_HUB
    _GLOBAL_HUB = hub
    return prev


def hub_from_spec(tspec, *, meta: Optional[dict] = None) -> TelemetryHub:
    """A hub from a ``TelemetrySpec``-shaped object (``enabled`` / ``sinks``
    / ``dir`` / ``sample_every``). A disabled spec gives the console-only
    default hub: progress lines print and no event log is written."""
    if not tspec.enabled:
        return default_hub()
    return TelemetryHub(make_sinks(tspec.sinks, out_dir=tspec.dir),
                        sample_every=tspec.sample_every, meta=meta)
