"""Event types and the deterministic event queue of the simulator (the JAX
package's ``repro.fed.sim.events``; plain Python, kept as the port's own
copy).

The queue is a binary heap ordered by ``(time, client_id, seq)`` — the
tie-break the async engine's determinism relies on: two
events at the same virtual timestamp always pop in client-id order (and
for the same client, in push order), never in hash/dict order.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: something that happens at virtual time ``time``."""

    time: float
    client_id: int


@dataclasses.dataclass(frozen=True)
class ClientFinished(Event):
    """A dispatched client's update arrives at the server.

    ``version`` is the server aggregation count at dispatch (its staleness
    at arrival is ``server_version − version``); ``dispatch_idx`` is the
    client's own dispatch counter (keys the pending-work table).
    """

    version: int = 0
    dispatch_idx: int = 0


@dataclasses.dataclass(frozen=True)
class ClientDropped(Event):
    """A dispatched client fails mid-round; its update never arrives."""

    version: int = 0
    dispatch_idx: int = 0


@dataclasses.dataclass(frozen=True)
class ClientAvailable(Event):
    """A previously unavailable client becomes dispatchable again."""


@dataclasses.dataclass(frozen=True)
class ServerAggregate(Event):
    """The server folds a buffer of arrivals into a new model version.

    Aggregations happen synchronously at the triggering arrival's
    timestamp, so this event is never *queued* — the async engine
    constructs one per flush and records its fields on the timeline.
    ``client_id`` is -1: the server is not a client.
    """

    version: int = 0
    buffer_fill: int = 0


class EventQueue:
    """Deterministic priority queue over :class:`Event`s.

    Orders by ``(time, client_id, seq)``; ``seq`` is a monotonically
    increasing push counter, so ordering never consults the event objects
    themselves (no dataclass comparison, no dict order anywhere).
    """

    def __init__(self):
        self._heap: List[tuple] = []
        self._seq = 0

    def push(self, event: Event) -> None:
        heapq.heappush(
            self._heap, (float(event.time), int(event.client_id), self._seq, event)
        )
        self._seq += 1

    def pop(self) -> Event:
        if not self._heap:
            raise IndexError("pop from empty EventQueue")
        return heapq.heappop(self._heap)[3]

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop_until(self, t: float) -> List[Event]:
        """Pop every event with ``time <= t`` (in deterministic order)."""
        out = []
        while self._heap and self._heap[0][0] <= t:
            out.append(self.pop())
        return out

    def clear(self) -> None:
        self._heap.clear()

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
