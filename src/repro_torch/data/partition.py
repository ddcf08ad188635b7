"""Federated dataset partitioners (horizontal FL: same features, split
rows); a copy of the JAX package's ``repro.data.partition``."""
from __future__ import annotations

from typing import List

import numpy as np


def partition_iid(num_points: int, num_clients: int, *, seed: int = 0) -> List[np.ndarray]:
    """Uniform random equal-size split (the paper's CIFAR setup)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_points)
    per = num_points // num_clients
    return [perm[c * per : (c + 1) * per] for c in range(num_clients)]


def partition_sizes(partitions: List[np.ndarray]) -> np.ndarray:
    """``|X_c|`` per client — the natural aggregation weights of the
    paper's §2 weighted-average extension (pass as ``client_weights`` to
    the engine; it normalizes and slices them per active cohort)."""
    return np.asarray([len(p) for p in partitions], dtype=np.float32)


def partition_dirichlet(
    labels: np.ndarray, num_clients: int, *, alpha: float = 0.5, seed: int = 0
) -> List[np.ndarray]:
    """Label-skewed non-iid split via a Dirichlet prior (Hsu et al.).

    Lower ``alpha`` ⇒ more heterogeneity ⇒ stronger client drift — the
    regime where the paper's variance correction matters (Fig. 1 / Fig. 5).
    Client shares are rebalanced to equal sizes (the paper assumes
    ``|X_c|`` identical).
    """
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    buckets: List[list] = [[] for _ in range(num_clients)]
    for k in classes:
        idx = np.where(labels == k)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(alpha * np.ones(num_clients))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for c, part in enumerate(np.split(idx, cuts)):
            buckets[c].extend(part.tolist())
    per = len(labels) // num_clients
    out = []
    spill: List[int] = []
    for c in range(num_clients):
        b = np.array(buckets[c], dtype=np.int64)
        rng.shuffle(b)
        out.append(b[:per])
        spill.extend(b[per:].tolist())
    rng.shuffle(spill)
    for c in range(num_clients):
        need = per - len(out[c])
        if need > 0:
            out[c] = np.concatenate([out[c], np.array(spill[:need], dtype=np.int64)])
            spill = spill[need:]
    return out
