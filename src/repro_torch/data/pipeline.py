"""Batching pipeline for federated rounds (a copy of the JAX package's
``repro.data.pipeline``: the same numpy streams, so the same batches).

Produces per-round batch pytrees with the ``(C, ...)`` or ``(C, s*, b, ...)``
client-leading layout that :func:`repro_torch.core.fedlrt.fedlrt_round` consumes,
where ``C`` is the *active cohort* of the round (all clients, or the subset
chosen by a :class:`repro_torch.fed.participation.Participation` policy).
Deterministic, restartable, no host-side dependency beyond numpy.

Cohort semantics: every client owns an independent shuffled stream over its
shard (per-client RNG seeded with ``(seed, c)``), and a client's cursor
advances **only in rounds it participates in**.  Consequently the sequence
of batches a client sees depends solely on how many rounds it has been
sampled into — not on which other clients were active — which is what makes
partial-participation runs reproducible and comparable against
full-participation baselines.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class FederatedBatcher:
    """Cycles through each client's shard in shuffled epochs.

    Parameters
    ----------
    arrays: dict of data arrays, first axis = sample.
    partitions: list (len C) of index arrays into the sample axis.
    batch_size: per-client per-step batch.
    steps_per_round: s* (yields ``(C, s*, b, ...)``) or None (``(C, b, ...)``
        with one batch per round reused for every local step).
    seed: base seed; client ``c`` draws from ``default_rng((seed, c))``.
    """

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        partitions: Sequence[np.ndarray],
        *,
        batch_size: int,
        steps_per_round: int | None = None,
        seed: int = 0,
    ):
        self.arrays = arrays
        self.partitions = [np.asarray(p) for p in partitions]
        self.batch_size = batch_size
        self.steps_per_round = steps_per_round
        self.seed = seed
        C = len(self.partitions)
        self._rngs = [np.random.default_rng((seed, c)) for c in range(C)]
        self._cursors = [0] * C
        self._orders: List[np.ndarray] = [
            rng.permutation(p) for rng, p in zip(self._rngs, self.partitions)
        ]

    @property
    def num_clients(self) -> int:
        return len(self.partitions)

    def _take(self, c: int, k: int) -> np.ndarray:
        idx = np.empty(k, dtype=np.int64)
        got = 0
        while got < k:
            avail = len(self._orders[c]) - self._cursors[c]
            take = min(avail, k - got)
            idx[got : got + take] = self._orders[c][
                self._cursors[c] : self._cursors[c] + take
            ]
            got += take
            self._cursors[c] += take
            if self._cursors[c] >= len(self._orders[c]):
                self._orders[c] = self._rngs[c].permutation(self.partitions[c])
                self._cursors[c] = 0
        return idx

    def next_round(self, cohort: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
        """Batches for one round.  ``cohort`` (optional) selects the active
        clients; leaves come back with a leading axis of ``len(cohort)`` in
        cohort order.  Inactive clients' streams are untouched."""
        if cohort is None:
            cohort = range(self.num_clients)
        cohort = [int(c) for c in cohort]
        b, s = self.batch_size, self.steps_per_round
        k = b * (s or 1)
        idx = np.stack([self._take(c, k) for c in cohort])  # (|cohort|, k)
        K = len(cohort)
        out = {}
        for name, arr in self.arrays.items():
            g = arr[idx.reshape(-1)].reshape((K, k) + arr.shape[1:])
            if s is not None:
                g = g.reshape((K, s, b) + arr.shape[1:])
            else:
                g = g.reshape((K, b) + arr.shape[1:])
            out[name] = g
        return out

    # -- restartability ----------------------------------------------------

    def state(self) -> Dict[str, Any]:
        """Snapshot of the stream state (cursors, orders, RNG states) —
        JSON-unfriendly but npz/pickle-able; pair with the constructor args
        to resume a run mid-epoch."""
        return {
            "cursors": list(self._cursors),
            "orders": [o.copy() for o in self._orders],
            "rng_states": [rng.bit_generator.state for rng in self._rngs],
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self._cursors = list(state["cursors"])
        self._orders = [np.asarray(o) for o in state["orders"]]
        for rng, st in zip(self._rngs, state["rng_states"]):
            rng.bit_generator.state = st
