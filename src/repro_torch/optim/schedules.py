"""Learning-rate schedules as functions of the step (paper Table 2 uses
cosine annealing)."""
from __future__ import annotations

import math


def constant_schedule(lr: float):
    def fn(step):
        return float(lr)

    return fn


def cosine_schedule(lr_start: float, lr_end: float, total_steps: int):
    """Cosine annealing from ``lr_start`` to ``lr_end`` over ``total_steps``."""

    def fn(step):
        frac = min(max(float(step) / max(total_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return lr_end + (lr_start - lr_end) * cos

    return fn
