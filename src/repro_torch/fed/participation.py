"""Per-round client participation policies (partial-participation FL); a
copy of the JAX package's ``repro.fed.participation``.

The standard FL regime (Konečný et al.; McMahan et al.) samples a cohort
of clients each round instead of waiting on the full population.  A
:class:`Participation` config describes how the engine picks the active
cohort; the round programs themselves are cohort-oblivious — they simply
receive ``k``-client batches and a ``FedConfig.num_clients == k``.

Modes
-----
- ``full``        every client, every round (the paper's setting).
- ``uniform``     uniform-k sampling without replacement per round.
- ``round_robin`` deterministic rotation of size-k cohorts: each round
                  takes the next k clients in cyclic order, so
                  participation counts equalize every lcm(C,k)/k rounds
                  (exactly once per C/k rounds when k divides C).
- ``dropout``     every client intends to participate, but each round a
                  client straggles/drops with probability ``dropout_prob``
                  and is excluded from the cohort (straggler exclusion);
                  at least ``min_cohort`` clients are always retained.

Cohorts are returned **sorted** so that sampling all ``C`` clients is
bit-for-bit identical to full participation (same batch stacking order,
same jit cache entry).

All randomness is derived from ``(seed, round_idx)`` so cohorts are
deterministic, restartable from a round index, and independent of call
order — the engine can replay any round.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

MODES = ("full", "uniform", "round_robin", "dropout")


@dataclasses.dataclass(frozen=True)
class Participation:
    """Which clients are active each round."""

    mode: str = "full"
    cohort_size: Optional[int] = None  # k for uniform / round_robin
    dropout_prob: float = 0.0  # per-client straggle probability (dropout mode)
    min_cohort: int = 1  # dropout mode never shrinks the cohort below this
    seed: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.mode in ("uniform", "round_robin") and not self.cohort_size:
            raise ValueError(f"{self.mode} participation requires cohort_size")
        if not 0.0 <= self.dropout_prob <= 1.0:
            raise ValueError("dropout_prob must be in [0, 1]")
        if self.min_cohort < 1:
            raise ValueError("min_cohort must be >= 1")

    @classmethod
    def from_spec(cls, spec: str, *, seed: int = 0) -> "Participation":
        """Parse a CLI spec: ``full`` | ``uniform:K`` | ``round_robin:K`` |
        ``dropout:P``."""
        mode, _, arg = spec.partition(":")
        if mode == "full":
            return cls(seed=seed)
        if mode in ("uniform", "round_robin"):
            return cls(mode=mode, cohort_size=int(arg), seed=seed)
        if mode == "dropout":
            return cls(mode="dropout", dropout_prob=float(arg), seed=seed)
        raise ValueError(f"bad participation spec {spec!r}")

    def _rng(self, round_idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, int(round_idx)))

    def cohort(self, round_idx: int, num_clients: int) -> np.ndarray:
        """Sorted indices of the clients active in ``round_idx``."""
        if self.mode == "full":
            return np.arange(num_clients, dtype=np.int64)
        if self.mode == "uniform":
            k = min(self.cohort_size, num_clients)
            return np.sort(
                self._rng(round_idx).choice(num_clients, size=k, replace=False)
            ).astype(np.int64)
        if self.mode == "round_robin":
            k = min(self.cohort_size, num_clients)
            start = (int(round_idx) * k) % num_clients
            return np.sort((start + np.arange(k)) % num_clients).astype(np.int64)
        # dropout: independent straggle coin per client, exclusion of the
        # stragglers, deterministic backfill if too few survive.
        rng = self._rng(round_idx)
        coins = rng.random(num_clients)
        active = np.where(coins >= self.dropout_prob)[0]
        if len(active) < self.min_cohort:
            # retain the least-unlucky stragglers so the round can proceed
            order = np.argsort(coins)[::-1]
            active_set = set(active.tolist())
            extra = [c for c in order if c not in active_set]
            need = self.min_cohort - len(active)
            active = np.concatenate([active, np.asarray(extra[:need], np.int64)])
        return np.sort(active).astype(np.int64)

    def padded_size(self, num_clients: int) -> Optional[int]:
        """Fixed size the engine pads cohort batches to, or None.

        ``dropout`` is the only mode with a *fluctuating* cohort size; left
        unpadded it compiles one jit executable per distinct size it
        encounters.  Padding every round up to the population size with
        zero-weight filler clients keeps the engine at exactly one
        executable per run.  The static-cohort modes (full / uniform /
        round_robin) need no padding.
        """
        return int(num_clients) if self.mode == "dropout" else None

    def expected_cohort_size(self, num_clients: int) -> float:
        """Mean active-cohort size — used for analytic comm budgeting."""
        if self.mode == "full":
            return float(num_clients)
        if self.mode in ("uniform", "round_robin"):
            return float(min(self.cohort_size, num_clients))
        return max(
            float(self.min_cohort), num_clients * (1.0 - self.dropout_prob)
        )
