"""The port's one wall-clock shim (the JAX package's ``telemetry/clock.py``).

- :func:`perf_seconds` — monotonic, for durations;
- :func:`wall_time` — epoch seconds, for labelling only.
"""
from __future__ import annotations

import time


def perf_seconds() -> float:
    """Monotonic seconds from an arbitrary origin — duration measurement."""
    return time.perf_counter()


def wall_time() -> float:
    """Seconds since the Unix epoch — labels, never durations."""
    return time.time()
