"""Dynamic twin of the static pass: count step signatures per callsite.

The JAX package's audit counts jit traces per callsite; the port has no
jit, so what it counts is **step signatures**: per callsite of a round
function (the engine's ``self._round_fn(...)`` in
:meth:`repro_torch.fed.engine.FederatedEngine.run_round`), the distinct
(cohort size, weighted, batch shapes and dtypes) it was called with. The
invariant is the reference's: ``dropout`` participation pads every cohort
to the population size with zero-weight filler clients, so a whole run
keeps ONE signature — the same shapes and work every round, which is also
what a CUDA graph capture of the step needs. A broken padding path shows
as one signature per cohort size, all charged to the same callsite.

Usage::

    with trace_audit() as audit:
        build(spec).run()
    audit.assert_within_limit()        # ≤1 signature per callsite by default

While the audit is active every registered round method
(``repro_torch.fed.engine.ROUND_METHODS``) is wrapped, so engines built
inside the block record each round call; the registry is restored on
exit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
from typing import Dict, Iterator, List, Set, Tuple

import torch

from repro_torch.utils.tree import tree_leaves

#: (caller's file, caller's line, round function's qualname)
Site = Tuple[str, int, str]
#: (cohort size, weighted, ((shape, dtype) of each batch leaf))
Signature = Tuple[int, bool, tuple]


@dataclasses.dataclass
class TraceAudit:
    """Mutable audit record: the step signatures seen per callsite."""

    limit: int = 1
    signatures: Dict[Site, Set[Signature]] = dataclasses.field(default_factory=dict)

    def record(self, site: Site, signature: Signature) -> None:
        self.signatures.setdefault(site, set()).add(signature)

    @property
    def counts(self) -> Dict[Site, int]:
        """Distinct signatures per callsite."""
        return {s: len(sigs) for s, sigs in self.signatures.items()}

    def total(self) -> int:
        return sum(self.counts.values())

    def violations(self) -> List[Tuple[Site, int]]:
        """Callsites that saw more signatures than ``limit``."""
        return sorted((s, n) for s, n in self.counts.items() if n > self.limit)

    def publish(self, hub=None) -> None:
        """Republish the per-callsite signature counts as ``jit.traces``
        counters (the JAX package's name; default: the process-global hub
        from :func:`repro_torch.telemetry.get_hub`)."""
        if hub is None:
            from repro_torch.telemetry import get_hub

            hub = get_hub()
        for (fn, ln, qn), n in sorted(self.counts.items()):
            hub.counter("jit.traces", float(n), site=f"{fn}:{ln}", fn=qn)

    def assert_within_limit(self) -> None:
        bad = self.violations()
        if bad:
            lines = "\n".join(
                f"  {fn}:{ln} ({qn}): {n} step signatures (limit {self.limit})"
                for (fn, ln, qn), n in bad
            )
            raise AssertionError(
                "step signature audit failed — the engine changed its round's "
                f"shapes where it should keep one:\n{lines}\n"
                "(dropout cohorts must be padded to a fixed size with "
                "zero-weight clients; see ROADMAP 'Aggregation and dropout')"
            )


def signature(client_batches, cfg, client_weights) -> Signature:
    """(cohort size, weighted, the batch leaves' shapes and dtypes)."""
    return (
        int(cfg.num_clients),
        client_weights is not None,
        tuple((tuple(t.shape), str(t.dtype)) for t in tree_leaves(client_batches)
              if torch.is_tensor(t)),
    )


@contextlib.contextmanager
def trace_audit(limit: int = 1) -> Iterator[TraceAudit]:
    """Wrap every registered round method to record its step signature
    per callsite while active."""
    from repro_torch.fed import engine

    audit = TraceAudit(limit=limit)
    real = dict(engine.ROUND_METHODS)

    def audited(fn):
        qualname = getattr(fn, "__qualname__", repr(fn))

        @functools.wraps(fn)
        def counted(loss_fn, params, client_batches, cfg, *args, **kwargs):
            caller = sys._getframe(1)
            audit.record((caller.f_code.co_filename, caller.f_lineno, qualname),
                         signature(client_batches, cfg, kwargs.get("client_weights")))
            return fn(loss_fn, params, client_batches, cfg, *args, **kwargs)

        return counted

    engine.ROUND_METHODS.update({name: audited(fn) for name, fn in real.items()})
    try:
        yield audit
    finally:
        engine.ROUND_METHODS.clear()
        engine.ROUND_METHODS.update(real)
