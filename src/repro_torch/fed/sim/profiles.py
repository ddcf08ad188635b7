"""Per-client system profiles: pricing federated rounds in *seconds* (the
JAX package's ``repro.fed.sim.profiles``).

The cost model (:mod:`repro_torch.core.cost_model`) and the wire layer
(:mod:`repro_torch.fed.wire`) report what a round costs in FLOPs and bytes.  A
deployment is judged in wall-clock under heterogeneous fleets, so this
module supplies the missing conversion: a :class:`SystemProfile` per client
(compute throughput, up/down bandwidth, per-message latency, availability)
turns those counts into per-client round latencies, and a :class:`Fleet`
bundles one profile per population client plus the seeded randomness for
dropout traces.

Everything is deterministic: fleets drawn from distributions are seeded,
and per-dispatch dropout coins are derived from ``(fleet seed, client,
dispatch index)`` so a simulated run replays bit-identically. The draws
are numpy's, made with the same calls as the JAX package's, so fleets,
dropout coins and therefore whole event timelines are identical across
the two packages.

Pricing convention: a client's round is ``download → compute → upload``
executed serially, each message paying the fixed per-direction latency on
top of size/bandwidth (the binding-constraint framing of Konečný et al. —
uplink time on slow clients dominates).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class SystemProfile:
    """One client's (or link's) system characteristics.

    Defaults sketch a mid-range edge device: ~50 GFLOP/s of usable
    compute, 100 Mbit/s up, 400 Mbit/s down, 50 ms per-message latency.
    """

    flops_per_sec: float = 50e9
    up_bytes_per_sec: float = 12.5e6
    down_bytes_per_sec: float = 50e6
    latency_sec: float = 0.05  # fixed per-message overhead, each direction
    drop_prob: float = 0.0  # probability a dispatched round is lost mid-flight
    rejoin_delay_sec: float = 0.0  # offline time after a drop before re-dispatch
    name: str = ""

    def __post_init__(self):
        for f in ("flops_per_sec", "up_bytes_per_sec", "down_bytes_per_sec"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive, got {getattr(self, f)}")
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError(f"drop_prob must be in [0, 1), got {self.drop_prob}")

    def compute_seconds(self, flops: float) -> float:
        return float(flops) / self.flops_per_sec

    def up_seconds(self, nbytes: float) -> float:
        return self.latency_sec + float(nbytes) / self.up_bytes_per_sec

    def down_seconds(self, nbytes: float) -> float:
        return self.latency_sec + float(nbytes) / self.down_bytes_per_sec

    def round_seconds(self, flops: float, down_bytes: float, up_bytes: float) -> float:
        """Latency of one full client round: receive, compute, send."""
        return (
            self.down_seconds(down_bytes)
            + self.compute_seconds(flops)
            + self.up_seconds(up_bytes)
        )

    def slowed(self, factor: float) -> "SystemProfile":
        """This profile with compute and both links ``factor``× slower."""
        return dataclasses.replace(
            self,
            flops_per_sec=self.flops_per_sec / factor,
            up_bytes_per_sec=self.up_bytes_per_sec / factor,
            down_bytes_per_sec=self.down_bytes_per_sec / factor,
            latency_sec=self.latency_sec * factor,
            name=(self.name + f"/slow{factor:g}x").lstrip("/"),
        )


class Fleet:
    """One :class:`SystemProfile` per population client + seeded dropout.

    Build via :meth:`from_spec` (the CLI surface), :meth:`uniform`,
    :meth:`straggler`, or :meth:`lognormal`, or pass an explicit profile
    sequence for a fixed fleet.
    """

    def __init__(self, profiles: Sequence[SystemProfile], *, seed: int = 0):
        if not profiles:
            raise ValueError("a fleet needs at least one profile")
        self.profiles = tuple(profiles)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.profiles)

    def __getitem__(self, client: int) -> SystemProfile:
        return self.profiles[client]

    def __repr__(self):
        return f"Fleet({len(self.profiles)} clients, seed={self.seed})"

    # -- constructors ------------------------------------------------------

    @classmethod
    def uniform(
        cls, num_clients: int, profile: Optional[SystemProfile] = None, *, seed: int = 0
    ) -> "Fleet":
        """Identical profiles — the degenerate fleet the sync engine assumes."""
        p = profile if profile is not None else SystemProfile(name="uniform")
        return cls([p] * num_clients, seed=seed)

    @classmethod
    def straggler(
        cls,
        num_clients: int,
        *,
        slow_frac: float = 0.25,
        slowdown: float = 10.0,
        base: Optional[SystemProfile] = None,
        seed: int = 0,
    ) -> "Fleet":
        """A fixed fraction of clients is ``slowdown``× slower end-to-end.

        The slow clients are the *last* ``ceil(slow_frac·C)`` ids —
        deterministic, so engine comparisons straggle the same clients.
        """
        if not 0.0 <= slow_frac <= 1.0:
            raise ValueError(f"slow_frac must be in [0, 1], got {slow_frac}")
        if slowdown < 1.0:
            raise ValueError(f"slowdown must be >= 1, got {slowdown}")
        p = base if base is not None else SystemProfile(name="base")
        n_slow = int(math.ceil(slow_frac * num_clients)) if slow_frac > 0 else 0
        slow = p.slowed(slowdown)
        return cls(
            [p] * (num_clients - n_slow) + [slow] * n_slow, seed=seed
        )

    @classmethod
    def lognormal(
        cls,
        num_clients: int,
        *,
        sigma: float = 0.5,
        base: Optional[SystemProfile] = None,
        seed: int = 0,
    ) -> "Fleet":
        """Per-client slowdowns drawn i.i.d. log-normal(0, sigma), seeded."""
        p = base if base is not None else SystemProfile(name="base")
        rng = np.random.default_rng((seed, 0xF1EE7))
        factors = np.exp(rng.normal(0.0, sigma, size=num_clients))
        factors = np.maximum(factors, 1.0)  # slowdowns, never speedups
        return cls([p.slowed(float(f)) for f in factors], seed=seed)

    @classmethod
    def from_spec(cls, spec: str, num_clients: int, *, seed: int = 0) -> "Fleet":
        """Parse a CLI fleet spec.

        ``uniform``                      identical default profiles
        ``straggler[:FRAC[,SLOWDOWN]]``  FRAC of clients SLOWDOWN× slower
                                         (defaults 0.25, 10)
        ``lognormal[:SIGMA]``            log-normal slowdown draw (default 0.5)
        ``dropout:P[,...]``              any of the above with per-dispatch
                                         drop probability P (prefix modifier)
        """
        spec = spec.strip()
        drop = 0.0
        if spec.startswith("dropout:"):
            rest = spec[len("dropout:"):]
            head, _, tail = rest.partition(",")
            drop, spec = float(head), (tail or "uniform")
        kind, _, arg = spec.partition(":")
        base = SystemProfile(drop_prob=drop, name=kind)
        if kind == "uniform":
            if arg:
                raise ValueError(f"uniform fleet takes no argument, got {spec!r}")
            return cls.uniform(num_clients, base, seed=seed)
        if kind == "straggler":
            frac, slowdown = 0.25, 10.0
            if arg:
                parts = arg.split(",")
                frac = float(parts[0])
                if len(parts) > 1:
                    slowdown = float(parts[1])
            return cls.straggler(
                num_clients, slow_frac=frac, slowdown=slowdown, base=base, seed=seed
            )
        if kind == "lognormal":
            return cls.lognormal(
                num_clients, sigma=float(arg) if arg else 0.5, base=base, seed=seed
            )
        raise ValueError(
            f"unknown fleet spec {spec!r}; expected uniform | "
            f"straggler[:FRAC[,SLOWDOWN]] | lognormal[:SIGMA] "
            f"(optionally prefixed dropout:P,)"
        )

    # -- seeded randomness -------------------------------------------------

    def drop_draw(self, client: int, dispatch_idx: int) -> "tuple[bool, float]":
        """Seeded dropout coin for one dispatch of ``client``.

        Returns ``(dropped, fraction)``: whether this dispatch is lost, and
        (if so) the fraction of its round latency completed before the drop
        — deterministic in ``(fleet seed, client, dispatch index)``.
        """
        p = self.profiles[client].drop_prob
        if p <= 0.0:
            return False, 1.0
        rng = np.random.default_rng((self.seed, int(client), int(dispatch_idx)))
        u, frac = rng.random(2)
        return bool(u < p), float(frac)

    def is_uniform(self) -> bool:
        return all(p == self.profiles[0] for p in self.profiles)


# ---------------------------------------------------------------------------
# FLOP pricing of one client round
# ---------------------------------------------------------------------------


def batch_tokens(client_batch, per_step_batches: bool = False) -> int:
    """Tokens one local step consumes, inferred from a *single client's*
    batch tree (no leading client axis; numpy arrays or tensors, read for
    their shape and dtype only).

    The per-step batch leaf is ``(b, ...)`` (``(s*, b, ...)`` under the
    per-step layout — the leading s* axis is stripped first).  Integer
    leaves with a trailing axis are token-id sequences (LM batches): tokens
    = b × T.  Float leaves are row-vector features: tokens = b.
    """
    leaf = tree_leaves(client_batch)[0]
    shape = tuple(leaf.shape[1:] if per_step_batches else leaf.shape)
    b = int(shape[0]) if shape else 1
    integer = (
        not (leaf.is_floating_point() or leaf.is_complex() or leaf.dtype == torch.bool)
        if torch.is_tensor(leaf)
        else np.issubdtype(np.asarray(leaf).dtype, np.integer)
    )
    if integer and len(shape) >= 2:
        return b * int(shape[1])
    return b


def client_round_flops(params, cfg, client_batch) -> float:
    """FLOPs of one client's round: s* local fwd+bwd steps on ``params``.

    Factor leaves price the low-rank chain, dense 2-D leaves a full matmul
    (:func:`repro_torch.core.cost_model.client_step_flops`); vectors and
    scalars are free.  ``client_batch`` is one client's batch tree (no
    client axis).
    """
    tokens = batch_tokens(client_batch, cfg.per_step_batches)
    return float(cfg.s_star) * cost_model.client_step_flops(params, tokens)


FlopsFn = Callable[..., float]  # (params, cfg, client_batch) -> flops
