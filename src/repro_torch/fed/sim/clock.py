"""Virtual clock and per-run timeline for the event-driven simulator (the
JAX package's ``repro.fed.sim.clock``; plain Python, kept as the port's own
copy).

The simulator never sleeps: time is a number that only moves forward, to
the timestamp of the next event (:class:`VirtualClock`), and everything
that happens is appended to a :class:`Timeline` — the per-run record the
benchmarks and the determinism tests read back.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple


class VirtualClock:
    """Monotonic virtual time in seconds."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def advance_to(self, t: float) -> float:
        if t < self.now:
            raise ValueError(f"clock cannot run backwards: {t} < {self.now}")
        self.now = float(t)
        return self.now

    def __repr__(self):
        return f"VirtualClock(now={self.now:.6f})"


@dataclasses.dataclass(frozen=True)
class TimelineEntry:
    """One recorded occurrence: ``(t, kind, client, round_idx, detail)``.

    ``client`` is -1 for server-side entries (aggregations); ``detail`` is
    a short free-form annotation (staleness, buffer fill, drop fraction).
    """

    t: float
    kind: str
    client: int = -1
    round_idx: int = -1
    detail: str = ""

    def key(self) -> Tuple[float, str, int, int, str]:
        """Canonical tuple — what the determinism pin compares."""
        return (self.t, self.kind, self.client, self.round_idx, self.detail)


class Timeline:
    """Append-only record of everything the simulator did, in time order."""

    def __init__(self):
        self.entries: List[TimelineEntry] = []

    def record(
        self,
        t: float,
        kind: str,
        *,
        client: int = -1,
        round_idx: int = -1,
        detail: str = "",
    ) -> TimelineEntry:
        e = TimelineEntry(
            t=float(t), kind=kind, client=int(client),
            round_idx=int(round_idx), detail=detail,
        )
        self.entries.append(e)
        return e

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[TimelineEntry]:
        return iter(self.entries)

    def of_kind(self, kind: str) -> List[TimelineEntry]:
        return [e for e in self.entries if e.kind == kind]

    def span(self) -> float:
        """Virtual seconds covered by the run (0 for an empty timeline)."""
        return self.entries[-1].t if self.entries else 0.0

    def keys(self) -> List[Tuple]:
        """Canonical per-entry tuples (the determinism-pin comparison)."""
        return [e.key() for e in self.entries]

    def time_to(self, predicate) -> Optional[float]:
        """Timestamp of the first entry satisfying ``predicate``, or None."""
        for e in self.entries:
            if predicate(e):
                return e.t
        return None
